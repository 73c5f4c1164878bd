"""The plain references against the port at tiny sizes, in float64 on the
CPU: given the same state and noise, the port's step and the reference's
agree, and the check's numbers read rounding only."""
import pytest
import torch

from portbench.manifest import load_module
from portbench.reference import csmc
from portbench.tests.tiny import tiny_manifest


def _cell(tmp_path, workload, chains=4):
    m = tiny_manifest(tmp_path)
    w = m.workload(workload)
    cfg, traffic = m.config(w["config"]), m.traffic(w["traffic"])
    traffic["chains"] = chains
    family, style = m.module("families", cfg["family"]), m.module("styles", traffic["style"])
    _, ys = family.simulate(cfg)
    init, kernel = family.build(cfg, traffic, ys)
    from aux_ssm_tpu_torch.parallel.chains import broadcast_chains
    x0 = family.start(cfg, traffic, ys, 11)
    state = broadcast_chains(init(x0), chains)
    return cfg, traffic, family, style, ys, kernel, state


def test_kalman2_step_matches_the_reference(tmp_path):
    cfg, traffic, family, style, ys, kernel, state = _cell(tmp_path, "sv30.kalman2.c32", 6)
    gen = torch.Generator().manual_seed(5)
    delta = torch.tensor([0.002, 0.01, 0.05, 0.2, 1.0, 4.0], dtype=torch.float64)
    model = family.model(cfg, ys, torch.float64, "cpu")
    seen = set()
    for _ in range(4):
        noise = style.noise(state, traffic, gen)
        out = kernel(state, delta, generator=None, noise=noise)
        numbers = style.judge(model, state.x, delta, noise, style.outputs(out, {}))
        assert numbers["draw_err"] < 1e-9 and numbers["accept_gap"] == 0.0
        seen |= set(out.updated.tolist())
        state = out
    assert seen == {True, False}


@pytest.mark.parametrize("workload", ["sv30.guided.c128", "spatial8.guided.c128"])
def test_guided_step_matches_the_reference(tmp_path, workload):
    cfg, traffic, family, style, ys, kernel, state = _cell(tmp_path, workload)
    gen = torch.Generator().manual_seed(9)
    T = state.x.shape[1]
    delta = torch.full((4, T), 0.05, dtype=torch.float64)
    model = family.model(cfg, ys, torch.float64, "cpu")
    for _ in range(3):
        noise = style.noise(state, traffic, gen)
        with style.recording() as record:
            out = kernel(state, delta, generator=None, noise=noise)
        numbers = style.judge(model, state.x, delta, noise, style.outputs(out, record))
        assert numbers["output_err"] == 0.0 and numbers["anc_gap"] == 0.0
        assert numbers["back_gap"] == 0.0
        assert numbers["prop_err"] < 1e-10 and numbers["logw_err"] < 1e-9
        free = csmc.sweep(model, state.x, delta, noise)
        assert torch.equal(free["picked"] != 0, out.updated)
        assert torch.allclose(free["x_new"], out.x, atol=1e-10, rtol=0)
        state = out


def test_reference_imports_nothing_of_the_port():
    import subprocess
    import sys
    code = ("import sys; import portbench.reference.kalman, portbench.reference.csmc, "
            "portbench.reference.sv, portbench.reference.spatial; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'aux_ssm_tpu_torch', 'aux_ssm_tpu', 'jax', 'jaxlib'}))")
    from portbench.manifest import CHECKOUT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=CHECKOUT, check=True)
    assert out.stdout.strip() == "[]"


def test_traffic_delta_is_frozen_finite_and_of_the_style_shape():
    import copy
    from portbench.manifest import Manifest
    from portbench.tests.tiny import with_kept_cells
    m = Manifest()
    for w in with_kept_cells(copy.deepcopy(m.bench))["workloads"]:
        cfg, traffic = m.config(w["config"]), m.traffic(w["traffic"])
        delta = torch.as_tensor(traffic["delta"], dtype=torch.float64)
        want = () if traffic["style"].startswith("kalman") else (cfg["T"],)
        assert tuple(delta.shape) == want, w["name"]
        assert torch.isfinite(delta).all() and (delta > 0).all()
        assert traffic["delta_found"]
        style = load_module("styles", traffic["style"])
        assert set(traffic["limits"]) == set(style.NUMBERS)
