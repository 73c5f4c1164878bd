"""The port's SV and spatial experiment drivers, the typed configuration
of the CLI and resumable driver runs (`aux_ssm_tpu_torch.experiments.{sv,
spatial,cli,lorenz}`), and the reference-compatible namespaces, against the
JAX package: each driver style runs on the CPU at a tiny size and writes the
.npz keys the JAX driver's `save_results` call names (read from its source:
no JAX driver is run, each would jit a sampler) with the JAX shapes; the
spatial data equal JAX `spatial.get_data`'s for the seed; `experiment_config`
equals JAX's field by field; a Lorenz run killed mid-sampling and started
again equals the uninterrupted one.

Tolerance: exact. Keys, shapes, configs and the spatial data are compared
exactly; the resumed run bit for bit.
"""
import ast
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import aux_ssm_tpu.csmc as jcsmc  # noqa: E402
import aux_ssm_tpu.kalman as jkalman  # noqa: E402
from aux_ssm_tpu.experiments import cli as jcli  # noqa: E402
from aux_ssm_tpu.experiments import spatial as jspatial  # noqa: E402
from aux_ssm_tpu.experiments import sv as jsv  # noqa: E402
from aux_ssm_tpu.models import spatial as jspatial_model  # noqa: E402
from aux_ssm_tpu_torch import csmc, kalman  # noqa: E402
from aux_ssm_tpu_torch.experiments import cli, lorenz, runner, spatial, sv  # noqa: E402

SMALL = ["--n-samples", "20", "--burnin", "10", "--no-verbose", "--platform", "cpu",
         "--seed", "3"]


@pytest.fixture(autouse=True)
def default_dtype():
    """The drivers set the default dtype from --precision: restore it."""
    saved = torch.get_default_dtype()
    yield
    torch.set_default_dtype(saved)


def _saved_keys(module):
    """The keyword names of the `save_results` call in `module`'s source."""
    for node in ast.walk(ast.parse(inspect.getsource(module))):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "save_results":
            return {kw.arg for kw in node.keywords}
    raise AssertionError(f"no save_results call in {module.__name__}")


def _run(driver, tmp_path, argv):
    tmp_path.mkdir(exist_ok=True)
    out = tmp_path / "out.npz"
    res = driver.main(SMALL + argv + ["--out", str(out)])
    return res, np.load(out)


@pytest.mark.parametrize("style", ["kalman-1", "kalman-2", "csmc", "csmc-guided"])
def test_sv_driver_writes_jax_keys_and_shapes(tmp_path, style):
    T, D = 16, 2
    res, saved = _run(sv, tmp_path, ["--style", style, "--T", str(T), "--D", str(D),
                                     "--N", "8"])
    assert set(saved.files) == _saved_keys(jsv) == _saved_keys(sv)
    want = dict(samples_mean=(T, D), samples_std=(T, D), ejsd=(T, D), xs_true=(T, D),
                ys=(T, D), sampling_time=(), delta=(T,) if style.startswith("csmc") else ())
    assert {k: saved[k].shape for k in saved.files} == want
    assert res.samples.shape == (20, T, D) and np.isfinite(res.samples).all()
    assert all(np.isfinite(saved[k]).all() for k in saved.files)
    assert res.state.x.device.type == "cpu" and res.state.x.dtype == torch.float32


@pytest.mark.parametrize("style", ["kalman-2", "csmc-guided"])
def test_spatial_driver_writes_jax_keys_shapes_and_data(tmp_path, style):
    T, D = 12, 3
    _, saved = _run(spatial, tmp_path, ["--style", style, "--T", str(T), "--D", str(D)])
    assert set(saved.files) == _saved_keys(jspatial) == _saved_keys(spatial)
    x_shape = (T, D * D, 1) if style.startswith("kalman") else (T, D * D)
    want = dict(mean_x=x_shape, var_x=x_shape, ejsd=x_shape, xs_true=(T, D * D),
                ys=(T, D * D), sampling_time=(),
                delta=(T,) if style.startswith("csmc") else ())
    assert {k: saved[k].shape for k in saved.files} == want
    xs, ys = jspatial_model.get_data(np.random.default_rng(3), jspatial.SIGMA_X, jspatial.R_Y,
                                     jspatial.TAU, jspatial.NU, D, T)
    np.testing.assert_array_equal(saved["xs_true"], xs)
    np.testing.assert_array_equal(saved["ys"], ys)
    assert all(np.isfinite(saved[k]).all() for k in saved.files)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("argv", [[], ["--style", "csmc", "--N", "64", "--no-parallel",
                                       "--precision", "double", "--platform", "cpu",
                                       "--n-samples", "7", "--seed", "5", "--mesh-chains", "2",
                                       "--checkpoint-dir", "ck", "--checkpoint-every", "9"]])
def test_experiment_config_equals_jax(argv):
    args = cli.base_parser("x").parse_args(argv)
    got, want = cli.experiment_config(args, seed=11), jcli.experiment_config(args, seed=11)
    for name in ("backend", "mesh", "sampler", "run"):
        g, w = _fields(getattr(got, name)), _fields(getattr(want, name))
        assert g == {k: w[k] for k in g}, name
        assert set(w) - set(g) <= {"matmul_precision"}   # JAX's TPU matmul setting
    top = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == top
    for name in set(top) - {"backend", "mesh", "sampler", "run"}:
        assert getattr(got, name) == getattr(want, name), name


def test_lorenz_driver_killed_and_resumed_equals_uninterrupted(tmp_path, monkeypatch):
    argv = ["--n-steps", "16", "--freq", "2", "--n-samples", "12", "--burnin", "8",
            "--checkpoint-every", "4"]
    full, want = _run(lorenz, tmp_path / "full", argv)

    class Killed(RuntimeError):
        pass

    save, calls = runner._save, []

    def dying_save(directory, payload, step):
        save(directory, payload, step)
        calls.append(step)
        if len(calls) == 4:       # burn-in 4, 8; sampling 4, 8: killed mid-sampling
            raise Killed()

    ck = ["--checkpoint-dir", str(tmp_path / "ck")]
    monkeypatch.setattr(runner, "_save", dying_save)
    with pytest.raises(Killed):
        _run(lorenz, tmp_path / "killed", argv + ck)
    monkeypatch.setattr(runner, "_save", save)
    assert calls[-1] == 10 ** 9 + 8
    resumed, got = _run(lorenz, tmp_path / "resumed", argv + ck)
    assert set(got.files) == set(want.files)
    for k in set(want.files) - {"sampling_time"}:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(resumed.state.x, full.state.x)
    np.testing.assert_array_equal(resumed.state.theta, full.state.theta)


@pytest.mark.parametrize("driver, extra, missing", [
    (sv, ["--n-chains", "3", "--mesh-chains", "2"], "does not divide"),
    (spatial, ["--n-chains", "3", "--mesh-chains", "2"], "does not divide"),
    (spatial, ["--style", "csmc", "--batch-sharded", "2"], "kalman styles")])
def test_unported_options_raise(tmp_path, driver, extra, missing):
    with pytest.raises(ValueError, match=missing):
        _run(driver, tmp_path, ["--T", "8", "--D", "2"] + extra)
    assert not (tmp_path / "out.npz").exists()


@pytest.mark.parametrize("driver, style", [(sv, "kalman-1"), (sv, "csmc-guided"),
                                           (spatial, "kalman-2")])
def test_drivers_run_several_chains(tmp_path, capsys, driver, style):
    """`--n-chains 2` (kalman-1: one batched step; the other styles: the
    chain loop): the state and delta carry the chain axis, the saved
    moments are the chains' means, R-hat is printed."""
    res, saved = _run(driver, tmp_path, ["--style", style, "--T", "8", "--D", "2", "--N", "8",
                                         "--n-chains", "2"])
    assert res.state.x.shape[0] == 2 and res.stats.step.shape == (2,)
    assert res.delta.shape[0] == 2 and all(np.isfinite(saved[k]).all() for k in saved.files)
    printed = capsys.readouterr().out
    assert "2 chains" in printed and "Rhat max=" in printed


@pytest.mark.parametrize("port, ref", [(kalman, jkalman), (csmc, jcsmc)])
def test_namespaces_export_jax_names(port, ref):
    assert port.__all__ == ref.__all__
    assert all(hasattr(port, name) for name in ref.__all__)
