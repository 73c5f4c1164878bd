"""The readings a cell's limits are set from, on the card: for each seed,
a run of the cell (a short window at the cell's own sizes and load) and the
numbers its check compares, for the program and for the control (the
reference in float32 with TF32 on, in the program's place on the same
checked steps).

    python3 portbench/readings.py --workload sv30.kalman2.c32 --seeds 101-112 --seconds 3

Prints one JSON line a seed and writes them all to
chiprun_out/readings_<workload>.json when that directory exists.
"""
import argparse
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def seeds(text):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path[0] = str(CHECKOUT)
    from portbench.harness import run_cell
    rows = []
    for seed in args.seeds:
        result, _ = run_cell(args.workload, seed, args.seconds, False, controls=True,
                             log=lambda *a: print(*a, file=sys.stderr, flush=True))
        row = {"seed": seed, "program": {k: v["value"] for k, v in result["check"].items()},
               "control": result["control"],
               "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = CHECKOUT / "chiprun_out"
    if out.is_dir():
        (out / f"readings_{args.workload}.json").write_text(json.dumps(rows))


if __name__ == "__main__":
    main()
