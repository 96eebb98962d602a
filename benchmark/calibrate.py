"""The readings a cell's correctness limits are set from, on the card.

    python3 -m benchmark.calibrate --workload <cell> --seeds <n> [<n> ...] [--control]

In one process: the port is built once; for each seed its weights are made
anew, a short window at the cell's own load restores as many requests as a
run's sample holds (``traffic.sample.requests``), and the sample is
compared with the fp32 reference as a run compares it (the program's
reading).  With ``--control`` the same sample is also restored by the
reference computed in float8 e4m3 (the precision below the configuration's
bfloat16) and compared with the fp32 reference (the control's reading,
which has to come out above the limit).  Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import drive, judge
from benchmark.manifest import ROOT, Cell, load


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = Cell(load(ROOT), args.workload, ROOT)
    dev = torch.device("cuda", 0)
    prog = drive.Program(cell.config, cell.traffic, args.seeds[0], dev)
    for seed in args.seeds:
        prog.load_weights(seed)
        win = prog.window(0.0, count=cell.traffic["sample"]["requests"])
        sample = judge.draw_sample(cell.traffic, seed, list(win["outputs"]))
        ref = judge.Reference(cell.config, seed, dev)
        expected = judge.reference_outputs(ref, cell.traffic, seed, sample)
        del ref
        line = {"workload": cell.name, "seed": seed, "sample": sample,
                "program": judge.compare(win["outputs"], sample, expected)}
        if args.control:
            ctl = judge.Reference(cell.config, seed, dev, precision="fp8")
            got = judge.reference_outputs(ctl, cell.traffic, seed, sample)
            del ctl
            line["control"] = judge.compare(
                judge.in_batches(got, sample, cell.traffic["batch"]), sample, expected)
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
