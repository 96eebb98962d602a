"""What the benchmark's processes import, in fresh interpreters.

After the harness and the reference are imported and a CPU run of a tiny
cell has gone through, no top-level module is ``jax``, ``jaxlib``, ``flax``
or ``diffpir_tpu`` (whole names: ``diffpir_tpu_torch`` starts with the last
one).  The reference imports nothing of ``diffpir_tpu_torch``.  Without a
card the command exits non-zero and prints no result."""

import json
import os
import subprocess
import sys

import pytest

FORBIDDEN = {"jax", "jaxlib", "flax", "diffpir_tpu"}


def _python(code: str, root: str, env_extra=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)


def _top_levels(stdout: str) -> set:
    return set(json.loads(stdout.strip().splitlines()[-1]))


def test_harness_and_a_cpu_run_load_no_jax(data_root):
    code = """
import json, sys, types
sys.path.insert(0, "benchmark/tests")
import conftest
from benchmark import run, calibrate, judge, drive, traffic, flops
from benchmark.reference import unet, diffpir
cell = conftest._tiny_cell("tiny_inpaint")
res = run.run(cell, 5, 0.2, False, "cpu")
assert res["correct"], res
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    out = _python(code, data_root)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = _top_levels(out.stdout)
    assert "diffpir_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_reference_imports_nothing_of_the_program(data_root):
    code = """
import json, sys
from benchmark.reference import unet, diffpir
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    out = _python(code, data_root)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = _top_levels(out.stdout)
    assert not tops & (FORBIDDEN | {"diffpir_tpu_torch"})


def test_without_a_card_the_command_fails_and_prints_no_result(data_root):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "ffhq256.deblur_b16", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                          "--trace", "0"], cwd=data_root, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct(card, data_root):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "ffhq256.deblur_b16", "--seed", str(2 ** 31 + 77), "--seconds", "3",
                          "--trace", "0"], cwd=data_root, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
