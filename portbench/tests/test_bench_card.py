"""On the card (skipped without one): each cell at its full widths, fewer
chains and a shorter T, runs correct, and its control (the reference in
float32 with TF32 on, in the program's place) comes out not correct on
three seeds.

    python -m pytest portbench/tests/test_bench_card.py -m cuda -q
"""
import copy
import json

import pytest
import torch

from portbench.harness import run_cell
from portbench.manifest import CHECKOUT, Manifest
from portbench.tests.tiny import with_kept_cells

CELLS = ("sv30.kalman2.c32", "spatial8.guided.c128", "sv30.guided.c128")
T_CUT = {"sv-d30-t250": 64, "spatial-8x8-t1024": 128}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def card_manifest(root):
    """The cells at a T the test holds, 8 chains, every width as published."""
    real = Manifest()
    bench = with_kept_cells(copy.deepcopy(real.bench))
    for c in bench["configs"]:
        cfg = json.loads((CHECKOUT / c["file"]).read_text())
        cfg["T"] = T_CUT[c["name"]]
        path = root / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        tr = real.traffic(w["traffic"])
        T = T_CUT[w["config"]]
        tr.update(chains=8, warmup=10, burnin=min(tr["burnin"], 100), check_steps=3,
                  coords=[c for c in tr["coords"] if c[0] < T] or [[T // 2, 0]],
                  delta=tr["delta"][:T] if isinstance(tr["delta"], list) else tr["delta"])
        path = root / bench["paths"][0] / "traffic" / f"{w['traffic']}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(tr))
    return Manifest(bench, root)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_and_control_refused(card, tmp_path, cell):
    m = card_manifest(tmp_path)
    limits = m.traffic(m.workload(cell)["traffic"])["limits"]
    for seed in (1, 2, 3):
        result, lines = run_cell(cell, seed, 1.0, False, manifest=m, device=card, controls=True,
                                 log=lambda *a: None)
        assert result["correct"], lines
        assert any(not v <= limits[k] for k, v in result["control"].items()
                   if limits[k] is not None), result["control"]
