"""The benchmark of ``diffpir_tpu_torch`` on one NVIDIA H100.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m benchmark.calibrate --workload <cell> --seeds <n> ... [--control]
    python -m pytest benchmark/tests -q          (CPU; card tests skip without one)

``BENCHMARK.json`` at the repository's root names the cells; everything of
one cell is found by name: ``configs/<config>.json`` (the model's sizes and
source), ``traffic/<traffic>.json`` (the mix the one generator,
``traffic.py``, reads), ``limits/<cell>.json`` (the correctness limits and
the readings they were set from) and ``metrics/<metric>.py`` (each metric's
reader).  ``reference/`` is the plain PyTorch reference the outputs are
judged by; it imports nothing of the program.  Nothing here imports JAX or
the JAX package.
"""
