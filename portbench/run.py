"""The benchmark of `aux_ssm_tpu_torch` on NVIDIA cards.

    python3 portbench/run.py --workload sv30.kalman2.c32 --seed 7 --seconds 20 --trace 0

Runs one cell of `BENCHMARK.json` (`harness.run_cell`) from the root of a
checkout and prints, as the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `check`, each compared number with its limit; the
same numbers are the last lines of standard error. Exits non-zero, and
prints no result, without a CUDA card (or with fewer than the cell asks
for), or where a module of JAX or of the JAX package is loaded once the
window has closed. The kernel library builds into the checkout's `build/`.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "aux_ssm_tpu")


def banned_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(CHECKOUT)] + [q for q in sys.path if q and Path(q).resolve() != Path(here)]
    import torch
    from portbench.manifest import Manifest

    manifest = Manifest()
    chips = manifest.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from portbench.harness import run_cell
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             manifest=manifest, started=STARTED,
                             log=lambda *a: print(*a, file=sys.stderr, flush=True))
    found = banned_modules()
    if found:
        print(f"portbench: JAX or the JAX package is loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
