"""The port's checkpoints (`aux_ssm_tpu_torch/utils/checkpoint.py`) and the
resumable experiment loop (`experiments/runner.py` with `checkpoint_dir`):
state classes round-trip through `torch.save` / `torch.load(weights_only=
True)` into the caller's template, a kill during a save leaves the newest
checkpoint intact, and a segmented, killed and resumed chain equals the
uninterrupted one bit for bit (the JAX package's
`tests/test_config_checkpoint.py` on a toy torch kernel); with
`checkpoint_every` set the loop still equals JAX's `run_chain` on
`tests/test_torch_runner.py`'s toy at that file's tolerance (rtol 1e-12).

Tolerance: bit for bit (`assert_array_equal`) between runs of the port;
rtol 1e-12 against JAX, float64 on both sides.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.experiments import runner as jrunner  # noqa: E402
from aux_ssm_tpu.kernels.csmc_base import CSMCState as JState  # noqa: E402
from aux_ssm_tpu_torch import CSMCState, KalmanSampler, SamplerState  # noqa: E402
from aux_ssm_tpu_torch.experiments import RunConfig, run_chain  # noqa: E402
from aux_ssm_tpu_torch.experiments import runner  # noqa: E402
from aux_ssm_tpu_torch.models.lorenz import GibbsState  # noqa: E402
from aux_ssm_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from aux_ssm_tpu_torch.utils.stats import init_stats, update_stats  # noqa: E402
from test_torch_runner import FIELDS, T, _close, _toy_jax, _toy_torch  # noqa: E402


def _t(*shape, seed=0, dtype=torch.float64):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


def _states():
    x = _t(5, 3)
    stats = update_stats(init_stats(x, accept_shape=(5,)), x, _t(5, 3, seed=1),
                         torch.arange(5) % 2 == 0)
    return {
        "SamplerState": SamplerState(x=x),
        "KalmanSampler": KalmanSampler(x=x, updated=torch.tensor(True),
                                       log_target=torch.tensor(-3.5, dtype=torch.float64)),
        "CSMCState": CSMCState(x=_t(5, 3, dtype=torch.float32),
                               updated=torch.arange(5) % 3 == 0),
        "GibbsState": GibbsState(kalman_state=KalmanSampler(x=x, updated=torch.tensor(False)),
                                 theta=_t(3, seed=2)),
        "OnlineStats": stats,
    }


def _assert_same(got, want):
    """Same classes, devices, dtypes and bits, field by field."""
    assert type(got) is type(want)
    if isinstance(want, torch.Tensor):
        assert got.device == want.device and got.dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _assert_same(getattr(got, f.name), getattr(want, f.name))
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    else:
        assert got == want


@pytest.mark.parametrize("name", list(_states()))
def test_state_round_trip(tmp_path, name):
    state = _states()[name]
    payload = {"state": state, "delta": torch.tensor(0.25), "iter": 7, "tag": None}
    path = ckpt.save_checkpoint(tmp_path, 3, payload)
    assert os.path.basename(path) == "step_3.pt"
    raw = torch.load(path, weights_only=True)          # plain data only
    assert isinstance(raw["state"], dict)
    step, got = ckpt.restore_checkpoint(tmp_path, target=payload)
    assert step == 3
    _assert_same(got, payload)
    if name == "GibbsState":
        assert got["state"].kalman_state.log_target is None


def test_restore_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "absent"))


def test_latest_step_ignores_temporary_files(tmp_path):
    ckpt.save_checkpoint(tmp_path, 10, {"a": torch.ones(2)})
    ckpt.save_checkpoint(tmp_path, 1_000_000_005, {"a": torch.zeros(2)}, keep=2)
    (tmp_path / "step_2000000000.pt.tmp").write_bytes(b"a save cut short")
    assert ckpt.latest_step(tmp_path) == 1_000_000_005
    step, got = ckpt.restore_checkpoint(tmp_path)
    assert step == 1_000_000_005 and torch.equal(got["a"], torch.zeros(2))
    ckpt.save_checkpoint(tmp_path, 1_000_000_009, {"a": torch.ones(2)}, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_1000000005.pt", "step_1000000009.pt",
                                            "step_2000000000.pt.tmp"]


def _mh_toy(state, delta, generator=None):
    """Random-walk MH on N(0, I): accepts and rejects, so delta adapts."""
    x = state.x
    prop = x + torch.sqrt(delta) * torch.randn(x.shape, generator=generator, dtype=x.dtype)
    log_a = 0.5 * (x ** 2 - prop ** 2).sum()
    acc = torch.log(torch.rand((), generator=generator, dtype=x.dtype)) < log_a
    return KalmanSampler(x=torch.where(acc, prop, x), updated=acc)


CFG = RunConfig(n_samples=24, burnin=20, delta_init=0.5)
INIT = KalmanSampler(x=torch.zeros(4, dtype=torch.float64), updated=torch.tensor(False))


def _run(seed=1, **kw):
    return run_chain(_mh_toy, INIT, CFG, generator=torch.Generator().manual_seed(seed),
                     collect_samples=True, **kw)


@pytest.fixture(scope="module")
def uninterrupted():
    return _run()


def _assert_same_run(got, want):
    np.testing.assert_array_equal(got.samples, want.samples)
    _assert_same(got.state, want.state)
    _assert_same(got.delta, want.delta)
    _assert_same(got.stats, want.stats)


def test_segmented_run_equals_monolithic(tmp_path, uninterrupted):
    seg = _run(checkpoint_dir=str(tmp_path), checkpoint_every=7)
    _assert_same_run(seg, uninterrupted)
    assert seg.samples.shape == (CFG.n_samples, 4) and seg.sampling_time > 0
    assert len(os.listdir(tmp_path)) == runner.KEEP_CHECKPOINTS


@pytest.mark.parametrize("kill_after", [2, 5], ids=["mid-burnin", "mid-sampling"])
def test_killed_run_resumes_bit_for_bit(tmp_path, monkeypatch, uninterrupted, kill_after):
    """Saves at burn-in 8, 16, 20, then sampling 8, 16, 24: killed after the
    second (mid-burn-in) or the fifth (mid-sampling), then run again."""
    class Killed(RuntimeError):
        pass

    save, calls = runner._save, []

    def dying_save(directory, payload, step):
        save(directory, payload, step)
        calls.append(step)
        if len(calls) == kill_after:
            raise Killed()

    monkeypatch.setattr(runner, "_save", dying_save)
    with pytest.raises(Killed):
        _run(checkpoint_dir=str(tmp_path), checkpoint_every=8)
    monkeypatch.setattr(runner, "_save", save)
    assert ckpt.latest_step(tmp_path) == calls[-1]
    assert calls[-1] >= 10 ** 9 if kill_after == 5 else calls[-1] < 20
    resumed = _run(checkpoint_dir=str(tmp_path), checkpoint_every=8)
    _assert_same_run(resumed, uninterrupted)


def test_checkpointing_needs_a_generator(tmp_path):
    with pytest.raises(ValueError, match="generator"):
        run_chain(_mh_toy, INIT, CFG, checkpoint_dir=str(tmp_path))
    assert not os.listdir(tmp_path)


def test_checkpointed_run_chain_matches_jax(tmp_path):
    cfg = dict(n_samples=20, burnin=30, target_alpha=0.5, delta_init=0.3, learning_rate=0.3,
               beta=0.1)
    x0 = np.concatenate([np.random.default_rng(0).standard_normal((T, 2)), np.zeros((T, 1))],
                        axis=1)
    delta0 = np.linspace(0.1, 1.0, T)
    jres = jrunner.run_chain(
        jax.random.key(0), _toy_jax, JState(x=jnp.asarray(x0), updated=jnp.zeros(T, bool)),
        jrunner.RunConfig(**cfg), collect_samples=True, delta_init=jnp.asarray(delta0))
    tres = run_chain(_toy_torch, CSMCState(x=torch.as_tensor(x0),
                                           updated=torch.zeros(T, dtype=torch.bool)),
                     RunConfig(**cfg), generator=torch.Generator(), collect_samples=True,
                     delta_init=torch.as_tensor(delta0), checkpoint_dir=str(tmp_path),
                     checkpoint_every=7)
    _close(tres.delta, jres.delta)
    for f in FIELDS:
        _close(getattr(tres.stats, f), getattr(jres.stats, f))
    _close(tres.samples, jres.samples)
    _close(tres.state.x, jres.state.x)
