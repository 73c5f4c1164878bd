"""Find a cell's frozen delta by the program's own burn-in adaptation.

    python3 portbench/tune.py --workload sv30.kalman2.c32 --iterations 1500 --seed 1

Builds the cell as a run does (`harness.Cell`), starting every chain's
delta at the traffic file's `burnin_delta`, and runs `parallel.chains
.run_sharded_chains`'s burn-in toward update rate 0.5 (learning rate
`--lr`, decaying linearly, on the windowed rate): each chain's delta adapts on its
own rate. Prints the geometric mean over the chains of the adapted delta (a
scalar, or one a time step) and the update rate of a short run at it, as
JSON, and writes it to chiprun_out/tune_<workload>.json when that
directory exists. Run once, on the card; the result goes into the traffic
file.
"""
import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--iterations", type=int, default=1500)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--write", action="store_true",
                   help="write the delta into the traffic file (a trial's checkout)")
    args = p.parse_args(argv)
    sys.path[0] = str(CHECKOUT)
    import torch
    from aux_ssm_tpu_torch.experiments.runner import RunConfig
    from aux_ssm_tpu_torch.parallel.chains import run_sharded_chains
    from portbench.harness import Cell
    from portbench.manifest import Manifest

    manifest = Manifest()
    cell = Cell(manifest, args.workload, args.seed, args.device)
    tic = time.perf_counter()
    res = run_sharded_chains(cell.kernel, cell.state,
                             RunConfig(n_samples=50, burnin=args.iterations,
                                       learning_rate=args.lr, target_alpha=0.5, verbose=False),
                             generator=cell.gen,
                             delta_init=torch.full_like(cell.delta, cell.traffic["burnin_delta"]))
    delta = torch.exp(torch.log(res.delta.double()).mean(0))
    out = {"workload": args.workload, "iterations": args.iterations, "seed": args.seed,
           "seconds": time.perf_counter() - tic,
           "delta": delta.tolist() if delta.dim() else float(delta),
           "update_rate_last_50": float(res.stats.accept_cum.double().mean()),
           "delta_spread_over_chains": float(torch.log(res.delta.double()).std(0).mean())}
    print(json.dumps(out))
    if args.write:
        name = manifest.workload(args.workload)["traffic"]
        path = CHECKOUT / "portbench" / "traffic" / f"{name}.json"
        traffic = json.loads(path.read_text())
        traffic["delta"] = out["delta"]
        path.write_text(json.dumps(traffic) + "\n")
    target = CHECKOUT / "chiprun_out"
    if target.is_dir():
        (target / f"tune_{args.workload}.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main()
