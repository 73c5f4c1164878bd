"""Tiny copies of the benchmark's cells for CPU tests: the same files and
fields, at sizes the CPU runs in seconds."""
import copy
import json
from pathlib import Path

from portbench.ess import interior_coords
from portbench.manifest import CHECKOUT, Manifest

SIZES = {"sv-d30-t250": {"T": 12, "D": 3}, "spatial-8x8-t1024": {"T": 12, "D": 2}}
CHAINS, PARTICLES = 3, 8
# Traffic mixes kept under portbench/traffic for a later cell, not in
# BENCHMARK.json: their style and reference stay under test.
KEPT = [{"name": "sv30.kalman2.c32", "config": "sv-d30-t250", "traffic": "sv30.kalman2.c32",
         "chips": 1, "why": "kalman-2, 32 chains"}]


def with_kept_cells(bench):
    """`bench` with the kept traffic mixes as cells."""
    names = {w["name"] for w in bench["workloads"]}
    bench["workloads"] += [dict(w) for w in KEPT if w["name"] not in names]
    return bench


def tiny_manifest(root):
    """A Manifest over tiny copies of every configuration and traffic mix,
    written under `root`; the limits are the cells' own."""
    real = Manifest()
    bench = with_kept_cells(copy.deepcopy(real.bench))
    root = Path(root)
    for c in bench["configs"]:
        cfg = json.loads((CHECKOUT / c["file"]).read_text())
        cfg.update(SIZES[c["name"]])
        path = root / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        cfg = json.loads((root / next(c["file"] for c in bench["configs"]
                                      if c["name"] == w["config"])).read_text())
        tr = real.traffic(w["traffic"])
        T = cfg["T"]
        d = cfg["D"] ** 2 if cfg["family"] == "spatial" else cfg["D"]
        delta = tr["delta"]
        tr.update(chains=CHAINS, particles=PARTICLES, warmup=3, burnin=min(tr["burnin"], 5),
                  calibrate=2, profile_steps=2, check_steps=2, coords=interior_coords(T, d, 8),
                  delta=delta[:T] if isinstance(delta, list) else delta)
        path = root / bench["paths"][0] / "traffic" / f"{w['traffic']}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(tr))
    return Manifest(bench, root)
