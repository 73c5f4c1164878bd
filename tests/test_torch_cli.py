"""The port's CLI, configuration and Lorenz driver
(`aux_ssm_tpu_torch.experiments.{cli,lorenz}`, `aux_ssm_tpu_torch.config`)
against the JAX package's: the same flags with the same defaults, types and
actions; the driver's synthetic mode on the CPU writes the JAX driver's .npz
keys; an option that does not fit the run raises.

Tolerance: none needed. Flags and keys are compared exactly; the driver's
numbers come from the port's own random streams, so only their shapes and
finiteness are held.
"""
import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aux_ssm_tpu.experiments import cli as jcli  # noqa: E402
from aux_ssm_tpu_torch import config as tconfig  # noqa: E402
from aux_ssm_tpu_torch.experiments import cli as tcli  # noqa: E402
from aux_ssm_tpu_torch.experiments import lorenz as tlorenz  # noqa: E402

NPZ_KEYS = {"mean_x", "ejsd", "theta", "theta_samples", "delta", "sampling_time", "freq"}
SMALL = ["--n-steps", "32", "--n-samples", "5", "--burnin", "5", "--platform", "cpu",
         "--no-verbose"]


@pytest.fixture
def default_dtype():
    """The driver sets the default dtype from --precision: restore it."""
    saved = torch.get_default_dtype()
    yield
    torch.set_default_dtype(saved)


def _actions(parser):
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_base_parser_flags_equal_jax():
    jax_actions, port_actions = _actions(jcli.base_parser("x")), _actions(tcli.base_parser("x"))
    assert set(port_actions) == set(jax_actions)
    for dest, want in jax_actions.items():
        got = port_actions[dest]
        assert (got.option_strings, got.default, got.type, type(got)) == \
            (want.option_strings, want.default, want.type, type(want)), dest
    assert vars(tcli.base_parser("x").parse_args([])) == vars(jcli.base_parser("x").parse_args([]))


def test_run_config_equal_to_jax_fields():
    args = tcli.base_parser("x").parse_args(["--n-samples", "7", "--lr", "0.5"])
    cfg = tcli.run_config(args, burnin=3)
    want = jcli.run_config(args, burnin=3)
    for name in ("n_samples", "burnin", "target_alpha", "delta_init", "learning_rate", "beta",
                 "verbose"):
        assert getattr(cfg, name) == getattr(want, name), name


def test_lorenz_driver_synthetic_on_cpu(tmp_path, default_dtype, capsys):
    out = tmp_path / "lorenz.npz"
    res = tlorenz.main(SMALL + ["--freq", "2", "--out", str(out)])
    assert res.state.x.device.type == "cpu" and res.state.x.dtype == torch.float32
    saved = np.load(out)
    assert set(saved.files) == NPZ_KEYS
    assert saved["mean_x"].shape == (32, 3) and saved["theta_samples"].shape == (5, 3)
    assert np.isfinite(saved["mean_x"]).all() and np.isfinite(saved["theta_samples"]).all()
    assert int(saved["freq"]) == 2
    assert "samples/s" in capsys.readouterr().out


@pytest.mark.parametrize("extra, missing", [(["--n-chains", "3", "--mesh-chains", "2"],
                                             "does not divide")])
def test_lorenz_driver_unported_options_raise(tmp_path, default_dtype, extra, missing):
    with pytest.raises(ValueError, match=missing):
        tlorenz.main(SMALL + ["--out", str(tmp_path / "x.npz")] + extra)
    assert not (tmp_path / "x.npz").exists()


def test_lorenz_driver_runs_several_chains(tmp_path, default_dtype, capsys):
    """`--n-chains 2` runs two chains as one batched Gibbs step: theta samples
    (2, n, 3), the chains' mean statistics saved, split-R-hat printed."""
    out = tmp_path / "lorenz.npz"
    res = tlorenz.main(SMALL + ["--n-chains", "2", "--out", str(out)])
    assert res.state.theta.shape == (2, 3) and res.samples.shape == (2, 5, 3)
    saved = np.load(out)
    assert saved["theta_samples"].shape == (2, 5, 3) and saved["mean_x"].shape == (32, 3)
    printed = capsys.readouterr().out
    assert "2 chains" in printed and "Rhat max=" in printed


def test_backend_config(default_dtype):
    cpu = tconfig.BackendConfig(precision="double", platform="cpu")
    assert cpu.device == torch.device("cpu") and cpu.dtype == torch.float64
    assert tconfig.BackendConfig().device == torch.device("cuda")  # the card by default
    cpu.apply()
    assert torch.get_default_dtype() == torch.float64
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError, match="platform"):
        tconfig.BackendConfig(platform="tpu").device
    with pytest.raises(ValueError, match="precision"):
        tconfig.BackendConfig(precision="half").dtype
    with pytest.raises(ValueError, match="device_count"):  # no card here, and no CPU fallback
        tconfig.MeshConfig().build()
    mesh = tconfig.MeshConfig(axis_sizes=(2, -1), axis_names=("chains", "particles")).build(
        ["cpu"] * 4)
    assert mesh.shape == {"chains": 2, "particles": 2}


def test_from_args_nested_overrides():
    cfg = tconfig.from_args(**{"run.n_samples": 100, "sampler.style": "csmc",
                               "backend.precision": "double", "seed": "7"})
    assert cfg.run.n_samples == 100 and cfg.sampler.style == "csmc"
    assert cfg.backend.dtype == torch.float64 and cfg.seed == 7
    assert tconfig.ExperimentConfig().run == tconfig.RunConfig()
