"""The port's analysis artifacts (`aux_ssm_tpu_torch/experiments/figures.py`)
against the JAX package's on the same inputs: every CSV column of the four
tables, the returned tables, and the names of the files written. The port
builds its tables with NumPy and the `csv` module; the JAX side uses pandas.

Tolerance: rtol 1e-12 on every column (float64 on both sides). The spatial
kalman styles' (T, B, 1) EJSD is held against its sum over every non-time
axis and not against JAX, which sums over the last axis only.

The figures are drawn on both sides but not rendered: `Figure.savefig`
writes an empty file under the figure's name, which is all these tests read
of it.
"""
import os

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

from aux_ssm_tpu.experiments import figures as jfigures  # noqa: E402
from aux_ssm_tpu_torch.experiments import figures  # noqa: E402

RTOL = 1e-12


@pytest.fixture(autouse=True)
def _no_rendering(monkeypatch):
    from matplotlib.figure import Figure
    monkeypatch.setattr(Figure, "savefig", lambda self, path, **kw: open(path, "wb").close())


@pytest.fixture
def no_matplotlib(monkeypatch):
    """The port's figures as on a machine without matplotlib."""
    monkeypatch.setattr(figures, "_pyplot", lambda: None)


def _same_csv(port_path, jax_path):
    got, want = pd.read_csv(port_path), pd.read_csv(jax_path)
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        np.testing.assert_allclose(got[col].to_numpy(float), want[col].to_numpy(float),
                                   rtol=RTOL, err_msg=col)


def _same_table(table, frame):
    assert list(table) == list(frame.columns)
    for col in frame.columns:
        np.testing.assert_allclose(np.asarray(table[col], float), frame[col].to_numpy(float),
                                   rtol=RTOL, err_msg=col)


def _dirs(tmp_path):
    return str(tmp_path / "port"), str(tmp_path / "jax")


def _style_results(seed, T, shape=()):
    rng = np.random.default_rng(seed)
    return {"kalman-1": dict(ejsd=rng.uniform(0.1, 1, (T,) + shape), sampling_time=2.0),
            "csmc": dict(ejsd=rng.uniform(0.1, 1, (T,) + shape), sampling_time=5.3),
            "csmc-guided": dict(ejsd=rng.uniform(0.1, 1, (T,) + shape), sampling_time=3.1)}


@pytest.mark.parametrize("name, files", [
    ("sv_style_comparison", ["ESJD.csv", "ESJD_time.csv", "sv_ejsd.png"]),
    ("spatial_style_comparison", ["spatial_ESJD.csv", "spatial_ESJD_time.csv",
                                  "spatial_ejsd.png"])])
def test_style_comparison_matches_jax(tmp_path, name, files):
    res = _style_results(0, 40, (3,))
    port, jax_dir = _dirs(tmp_path)
    tables = getattr(figures, name)(res, 1000, port)
    frames = getattr(jfigures, name)(res, 1000, jax_dir)
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir)) == sorted(files)
    for table, frame in zip(tables, frames):
        _same_table(table, frame)
    for f in files[:2]:
        _same_csv(os.path.join(port, f), os.path.join(jax_dir, f))


def test_spatial_ejsd_summed_over_every_component(tmp_path, no_matplotlib):
    res = _style_results(1, 12, (9, 1))
    ejsd, eff = figures.spatial_style_comparison(res, 500, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["spatial_ESJD.csv", "spatial_ESJD_time.csv"]
    for style, r in res.items():
        want = r["ejsd"].sum(axis=(1, 2))
        np.testing.assert_allclose(ejsd[style], want, rtol=RTOL)
        np.testing.assert_allclose(eff[style], want / (r["sampling_time"] / 500), rtol=RTOL)
    written = pd.read_csv(tmp_path / "spatial_ESJD.csv")
    np.testing.assert_allclose(written["csmc"], res["csmc"]["ejsd"].sum(axis=(1, 2)),
                               rtol=RTOL)


def test_lorenz_freq_comparison_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    res = {1: dict(theta_samples=rng.standard_normal((200, 3)) + 1,
                   ejsd=rng.uniform(0.1, 1, (32, 3)), sampling_time=2.0),
           2: dict(theta_samples=rng.standard_normal((2, 100, 3)) + 2,
                   ejsd=rng.uniform(0.1, 1, (32,)), sampling_time=3.0)}
    port, jax_dir = _dirs(tmp_path)
    table = figures.lorenz_freq_comparison(res, port)
    frame = jfigures.lorenz_freq_comparison(res, jax_dir)
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir)) \
        == ["lorenz_theta.csv", "lorenz_theta.png"]
    _same_table(table, frame)
    _same_csv(os.path.join(port, "lorenz_theta.csv"), os.path.join(jax_dir, "lorenz_theta.csv"))


def test_rare_event_heatmaps_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    rows = [dict(rho=r, r2=s, err_mean_0=abs(rng.standard_normal()),
                 err_mean_T=abs(rng.standard_normal()), err_std_0=rng.standard_normal(),
                 err_std_T=rng.standard_normal(), ess_0=rng.uniform(10, 100),
                 ess_T=rng.uniform(10, 100), acc=rng.uniform(), time=1.5)
            for r in np.linspace(0, 0.9, 3) for s in np.logspace(-2, 0, 4)]
    port, jax_dir = _dirs(tmp_path)
    table = figures.rare_event_heatmaps(rows, port)
    frame = jfigures.rare_event_heatmaps(rows, jax_dir)
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir)) \
        == ["rare_event_heatmaps.png", "rare_event_summary.csv"]
    _same_table(table, frame)
    _same_csv(os.path.join(port, "rare_event_summary.csv"),
              os.path.join(jax_dir, "rare_event_summary.csv"))
    # The CLI reads the summary back and writes the same table, and only the
    # table without matplotlib.
    monkeypatch.setattr(figures, "_pyplot", lambda: None)
    figures.main(["rare-event", "--summary", os.path.join(jax_dir, "rare_event_summary.csv"),
                  "--out-dir", str(tmp_path / "cli")])
    assert os.listdir(tmp_path / "cli") == ["rare_event_summary.csv"]
    _same_csv(tmp_path / "cli" / "rare_event_summary.csv",
              os.path.join(jax_dir, "rare_event_summary.csv"))
