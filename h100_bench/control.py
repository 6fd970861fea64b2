"""Readings that set a cell's limits, held to them: the control (the plain
reference at the precision below the configuration's, in the program's
place) and the faults the cell can have, at the cell's own size, one line
of JSON a seed. Not run by the benchmark's runs; run on the card:

    python3 h100_bench/control.py --workload <name> --seeds 11,12,13

Each reading goes through the cell's comparison with the cell's limits.
Exits 1 unless every control and fault comes out not correct and the
program's own reading (where the kind takes one) comes out correct.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import torch

    import run
    from hb import traffic
    from hb.common import load_kind

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    _, cell, cfg, limits = run.load_cell(args.workload)
    tr = traffic.load(cell["traffic"])
    kind = load_kind(tr["kind"])
    wrong = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = kind.control(cell, cfg, tr, seed, torch.device("cuda"), limits)
        line = {"workload": args.workload, "seed": seed}
        for name, checks in out.items():
            correct = checks.ok()
            line[name] = {"correct": correct, **checks.items}
            if correct != (name == "program"):
                wrong.append(f"seed {seed}: {name} came out "
                             f"{'correct' if correct else 'not correct'}")
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    for w in wrong:
        print(w, file=sys.stderr)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
