"""The benchmark's arithmetic against values worked by hand: ESS, EJSD a
second, the rooflines' work and shares."""
import numpy as np
import pytest
import torch

from portbench import ess, kernels
from portbench.manifest import load_module


def test_ess_by_hand():
    # x = 1, 2, 3, 4: biased autocovariances 1.25, 0.3125, -0.375, -0.5625;
    # var+ = 1.25 + 0.3125; rho = 1, 0.4, -0.04, -0.16; pairs 1.4, -0.2 (cut);
    # tau = -1 + 2 * 1.4 = 1.8; ESS = 4 / 1.8.
    assert ess.effective_sample_size([[1.0, 2.0, 3.0, 4.0]]) == pytest.approx(4 / 1.8)


def test_ess_matches_the_ports_diagnostic():
    from aux_ssm_tpu_torch.utils.ess import effective_sample_size
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.standard_normal((4, 300)), 1) * 0.1 + rng.standard_normal((4, 300))
    assert ess.effective_sample_size(x) == pytest.approx(
        float(effective_sample_size(torch.from_numpy(x))), rel=1e-9)


def test_mean_ess_and_coords():
    coords = ess.interior_coords(250, 30)
    assert len(coords) == 64 and len({tuple(c) for c in coords}) == 64
    assert all(62 <= t < 188 and 0 <= i < 30 for t, i in coords)
    rng = np.random.default_rng(0)
    s = rng.standard_normal((8, 400, 3))
    assert ess.mean_ess(s) == pytest.approx(np.mean([ess.effective_sample_size(s[:, :, k])
                                                     for k in range(3)]))


def test_ejsd_and_rates_by_hand():
    class Stats:
        ejsd = torch.full((2, 5, 3), 0.5)
        accept_cum = torch.tensor([0.25, 0.75])
    ctx = {"stats": Stats, "chains": 2, "steps": 10, "window_s": 2.0, "launches": 30,
           "host_s": [0.001, 0.003], "trace": None, "events": []}
    read = {n: load_module("metrics", n).read for n in
            ("samples_per_s", "ejsd_per_s", "update_rate", "cuda_launches_per_step",
             "host_ms_per_step", "device_idle_share", "step_ms_p95")}
    assert read["samples_per_s"](ctx) == 10.0           # 2 chains x 10 steps / 2 s
    assert read["ejsd_per_s"](ctx) == 5.0              # 0.5 x 10 samples/s
    assert read["update_rate"](ctx) == 0.5
    assert read["cuda_launches_per_step"](ctx) == 3.0
    assert read["host_ms_per_step"](ctx) == pytest.approx(2.0)
    assert read["device_idle_share"](ctx) is None       # no trace: not measured
    assert read["step_ms_p95"](ctx) is None


def test_filter_scan_work_and_share_by_hand():
    cfg, traffic = {"family": "sv", "T": 3, "D": 2}, {"chains": 1}
    # n = 2 elements a filter, 1 combine of 18 d^3 = 144, two filters: 288
    # operations; bytes 2 filters x 2 elements x (3 d^2 + 2 d + d^2 + d = 22) x 4.
    assert load_module("work", "filter_scan").per_step(cfg, traffic) == (288, 352)
    least = max(288 / 67e12, 352 / 3.35e12)
    trace = {"steps": 2, "kernels": [("scan_kernel<FilterOp<float, 16> >", 0.0, 1.0),
                                     ("scan_kernel<AffineOp<float, 16> >", 1.0, 9.0),
                                     ("void at::native::foo", 9.0, 10.0)]}
    share = kernels.roofline({"trace": trace, "cfg": cfg, "traffic": traffic}, "filter_scan")
    assert share == pytest.approx(100 * least * 2 / 1e-6)


def test_block_lane_work_by_hand():
    # SV, T = 3, d = 2, N = 4, C = 2: n = 2; a particle 6 d^2 + 20 d = 64.
    cfg, traffic = {"family": "sv", "T": 3, "D": 2}, {"chains": 2, "particles": 4}
    ops, nbytes = load_module("work", "block_lane").per_step(cfg, traffic)
    assert ops == 2 * 2 * 4 * 64
    values = 2 * 2 * 2 * 4 + 2 * 2 * 4 + 2 * 2 + 2 * 4 + 4 + 2 * (6 * 2 + 2)
    assert nbytes == 2 * (values * 4 + 2 * 4 * 8)
    # spatial 8 x 8, r = 1: 64 + 2 x 112 = 288 nonzeros; 2 x 288 + 40 x 64.
    sp = load_module("families", "spatial")
    assert sp.block_lane_particle_ops({"D": 8, "tau": -0.25, "r_y": 1.0}) == 3136


def test_idle_share_and_gaps_by_hand():
    from portbench.devtrace import summarise
    trace = {"wall_s": 10e-6, "steps": 1,
             "kernels": [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 6.0, 7.0)],
             "host": [("outer", 0.0, 10.0), ("aten::copy_", 3.5, 5.5)]}
    s = summarise(trace)
    assert s["busy_s"] == pytest.approx(4e-6)          # [0, 3] and [6, 7]
    assert s["idle_gaps"] == [["aten::copy_", pytest.approx(3e-6)]]
    assert load_module("metrics", "device_idle_share").read({"trace": trace}) == \
        pytest.approx(60.0)
    assert load_module("metrics", "device_ops_per_step").read({"trace": trace}) == 3.0
    assert kernels.is_library("void at::native::vectorized_elementwise_kernel<4>")
    assert not kernels.is_library("void block_lane_kernel<float, SpatialGuided>(int)")
    assert kernels.is_library("zdisplace_pointers_kernel(float**, float**, int, int, int)")
    assert not kernels.is_library("void (anonymous namespace)::scan_kernel<(anonymous "
                                  "namespace)::FilterOp<float, 32> >(int, int)")


def test_tf32_rounding_by_hand():
    from portbench.reference.gauss import tf32, tf32_matmul
    ulp = 2.0 ** -10  # TF32 keeps 10 bits of mantissa
    x = torch.tensor([1 + ulp / 2, 1 + 3 * ulp / 2, 1 + ulp / 4, -(1 + 3 * ulp / 4), 1 + ulp],
                     dtype=torch.float32)
    want = [1.0, 1 + 2 * ulp, 1.0, -(1 + ulp), 1 + ulp]   # to nearest, ties to even
    assert tf32(x).tolist() == want
    a = torch.tensor([[1 + ulp / 4]], dtype=torch.float32)
    assert tf32_matmul(a, a).item() == 1.0
