"""The chain axis through the auxiliary-Kalman MH path (the dense batched
layout, x (T, C, d)) against the JAX package's one-chain functions under
`jax.vmap`, at C = 3 chains with d > 1, float64:

- the dense-layout ops: `filtering` (parallel and sequential), `sampling`
  given each chain's noise, `posterior_logpdf` with `keep_batch`, with
  missing observations and F, Q, b shared by the chains;
- the fixed target's density one value a chain (`make_target_logpdf` with
  `keep_batch`, the flagship's target), dense and scalar;
- `convert`'s batched Kalman state both ways;
- what the wrappers hand the chain instances (the launch mocked): n, C, the
  `shared` mask and each operand's shape, the scans' hand-over buffer;
- the batched MH steps against `jax.vmap` of the JAX one-chain kernel over
  `chain_keys` (what JAX's `run_sharded_chains` runs), each chain given the
  noise JAX draws from its key: SV kalman-1 (parallel) and kalman-2
  (sequential) at T = 12, D = 30, the flagship LGSSM (T = 16, dx = 4) and
  the Lorenz Gibbs step (T = 64, theta per chain), both sequential (each
  JAX reference is compiled once: the parallel-in-time ones take 10-15 s
  each, and the dense ops and SV kalman-1 hold the parallel route); C = 1
  of the batched kernel equals the one-chain kernel;
- the drivers with `--n-chains 2`: one batched step an iteration (two
  proposals, forward and reverse, each one filter over both chains), the
  output shapes and the split-R-hat fields.

Tolerance: float64 on both sides, the same algebra in other orders (the
port's chunked scans and batched kernels, JAX's associative scan): states
agree to ~1e-13, rtol 1e-9 catches any wrong term, and every accept
decision must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.kernels import kalman as jkalman  # noqa: E402
from aux_ssm_tpu.models import lorenz as jl  # noqa: E402
from aux_ssm_tpu.models import stochastic_volatility as jsv  # noqa: E402
from aux_ssm_tpu.ops import LGSSM as JLGSSM  # noqa: E402
from aux_ssm_tpu.ops import filtering as jfiltering  # noqa: E402
from aux_ssm_tpu.ops import posterior_logpdf as jposterior  # noqa: E402
from aux_ssm_tpu.ops import sampling as jsampling  # noqa: E402
from aux_ssm_tpu.parallel.chains import chain_keys  # noqa: E402
from aux_ssm_tpu_torch import convert  # noqa: E402
from aux_ssm_tpu_torch.experiments import cli, lorenz as tlorenz_driver, sv as tsv_driver  # noqa: E402
from aux_ssm_tpu_torch.kernels import kalman as tkalman  # noqa: E402
from aux_ssm_tpu_torch.models import lgssm_flagship  # noqa: E402
from aux_ssm_tpu_torch.models import lorenz as tl  # noqa: E402
from aux_ssm_tpu_torch.models import stochastic_volatility as tsv  # noqa: E402
from aux_ssm_tpu_torch.ops.filtering import filtering  # noqa: E402
from aux_ssm_tpu_torch.ops.lgssm import LGSSM, posterior_logpdf  # noqa: E402
from aux_ssm_tpu_torch.ops.sampling import sampling  # noqa: E402

C = 3
f64 = jnp.float64


def _t(z):
    return torch.as_tensor(np.array(z))


def _close(got, want, rtol=1e-9, atol=1e-11):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _kalman_noise(key, shape):
    """The noise of one JAX Kalman step, drawn as kernels/kalman.py draws it."""
    aux_key, sample_key, accept_key = jax.random.split(key, 3)
    return (jax.random.normal(aux_key, shape, f64), jax.random.normal(sample_key, shape, f64),
            jax.random.uniform(accept_key, (), f64))


def _steps(jkernel, jstate, tkernel, tstate, deltas, key, n_steps, noise_of, check):
    """n_steps of `jax.vmap(jkernel)` over each step's `chain_keys` and of
    the port's batched `tkernel` given the same chains' noise
    (`noise_of(keys)`, chain first); `check(tstate, jstate)` after each.
    Returns the accept decisions, (n_steps, C)."""
    jstep = jax.jit(jax.vmap(jkernel))
    jnoise = jax.jit(jax.vmap(noise_of))
    accepted = []
    for step_key in jax.random.split(key, n_steps):
        keys = chain_keys(step_key, C)
        jstate = jstep(keys, jstate, jnp.asarray(deltas))
        noise = jax.tree.map(_t, jnoise(keys))
        tstate = tkernel(tstate, torch.as_tensor(deltas), noise=noise)
        np.testing.assert_array_equal(tstate.updated.numpy(), np.asarray(jstate.updated))
        check(tstate, jstate)
        accepted.append(tstate.updated.numpy())
    return np.array(accepted)


# --------------------------------------------------------------------------
# The dense-layout ops and the batched state
# --------------------------------------------------------------------------

def _chains_model(T, dx, dy, seed):
    """C chains' LGSSMs with shared F, Q, b and each chain's own m0, P0, H,
    R, c and observations (a share missing, one step missing whole), as
    NumPy arrays: (shared dict, per-chain dict with a leading C)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((dx, dx))
    shared = {"Fs": np.tile(0.8 * A / np.linalg.norm(A, 2), (T - 1, 1, 1)),
              "Qs": np.tile(0.3 * np.eye(dx) + 0.05, (T - 1, 1, 1)),
              "bs": 0.1 * rng.standard_normal((T - 1, dx))}
    B = rng.standard_normal((C, T, dy, dy))
    per = {"m0": rng.standard_normal((C, dx)), "P0": np.tile(np.eye(dx), (C, 1, 1)),
           "Hs": rng.standard_normal((C, T, dy, dx)),
           "Rs": B @ B.transpose(0, 1, 3, 2) / dy + 0.5 * np.eye(dy),
           "cs": 0.1 * rng.standard_normal((C, T, dy)),
           "ys": rng.standard_normal((C, T, dy))}
    per["ys"][rng.uniform(size=per["ys"].shape) < 0.2] = np.nan
    per["ys"][:, 3] = np.nan
    return shared, per


@pytest.mark.parametrize("parallel", [True, False])
def test_dense_ops_match_jax_vmap(parallel):
    T, dx, dy = 10, 3, 2
    shared, per = _chains_model(T, dx, dy, seed=parallel)
    jl_model = JLGSSM(per["m0"], per["P0"], shared["Fs"], shared["Qs"], shared["bs"],
                      per["Hs"], per["Rs"], per["cs"])
    axes = JLGSSM(0, 0, None, None, None, 0, 0, 0)
    keys = chain_keys(jax.random.key(3), C)

    @jax.jit
    def jax_chains(ys, model, keys):
        ms, Ps, ell = jax.vmap(lambda y, m: jfiltering(y, m, parallel),
                               in_axes=(0, axes))(ys, model)
        xs = jax.vmap(lambda k, a, b, m: jsampling(k, a, b, m, parallel),
                      in_axes=(0, 0, 0, axes))(keys, ms, Ps, model)
        lp = jax.vmap(jposterior, in_axes=(0, 0, 0, axes))(ys, xs, ell, model)
        return ms, Ps, ell, xs, lp, jax.vmap(lambda k: jax.random.normal(k, (T, dx), f64))(keys)

    ms, Ps, ell, xs, lp, eps = jax_chains(per["ys"], jl_model, keys)

    # The port's time-first layout: per-chain parameters (T, C, ...), the
    # shared ones with a unit chain axis (read once for all chains).
    tf = {k: _t(v).transpose(0, 1) for k, v in per.items() if k not in ("m0", "P0")}
    model = LGSSM(_t(per["m0"]), _t(per["P0"]), *(_t(shared[k])[:, None] for k in
                                                  ("Fs", "Qs", "bs")),
                  tf["Hs"], tf["Rs"], tf["cs"])
    tms, tPs, tell = filtering(tf["ys"], model, parallel, keep_batch=True)
    _close(tms.transpose(0, 1), ms)
    _close(tPs.transpose(0, 1), Ps)
    _close(tell, ell)
    total = filtering(tf["ys"], model, parallel)[2]
    _close(total, np.sum(ell))
    txs = sampling(_t(eps).transpose(0, 1), tms, tPs, model, parallel)
    _close(txs.transpose(0, 1), xs)
    _close(posterior_logpdf(tf["ys"], txs, tell, model, keep_batch=True), lp)
    _close(posterior_logpdf(tf["ys"], txs, tell.sum(), model), np.sum(lp))


@pytest.mark.parametrize("dx,dy", [(3, 2), (1, 1), (3, 1)])
def test_target_logpdf_per_chain_matches_jax_vmap(dx, dy):
    """`make_target_logpdf(..., keep_batch=True)`: one target (every chain's,
    with missing observations) at C chains' trajectories (T, C, dx), one
    value a chain, against `jax.vmap` of the JAX target over the chains,
    the dense and the scalar branches."""
    from aux_ssm_tpu.ops.lgssm import make_target_logpdf as jtarget
    from aux_ssm_tpu_torch.ops.lgssm import make_target_logpdf
    T = 9
    shared, per = _chains_model(T, dx, dy, seed=dx + dy)
    one = {k: v[0] for k, v in per.items()}
    args = (one["m0"], one["P0"], shared["Fs"], shared["Qs"], shared["bs"], one["Hs"],
            one["Rs"], one["cs"])
    xs = np.random.default_rng(7).standard_normal((C, T, dx))
    want = jax.vmap(jtarget(jnp.asarray(one["ys"]), JLGSSM(*map(jnp.asarray, args))))(
        jnp.asarray(xs))
    lifted = LGSSM(_t(args[0]), _t(args[1]), *(_t(z)[:, None] for z in args[2:]))
    got = make_target_logpdf(_t(one["ys"])[:, None], lifted, keep_batch=True)(
        _t(xs).transpose(0, 1))
    assert got.shape == (C,)
    _close(got, want)


def test_convert_batched_kalman_state_both_ways():
    x = np.random.default_rng(0).standard_normal((C, 7, 4))
    jstate = jkalman.KalmanSampler(x=jnp.asarray(x), updated=jnp.array([True, False, True]),
                                   log_target=jnp.arange(C, dtype=f64))
    state = convert.kalman_chains_from_numpy(np.asarray(jstate.x), np.asarray(jstate.updated),
                                             np.asarray(jstate.log_target), device="cpu",
                                             dtype=torch.float64)
    assert state.x.shape == (7, C, 4) and state.x.is_contiguous()
    np.testing.assert_array_equal(state.x[:, 1].numpy(), x[1])
    back = convert.kalman_chains_to_numpy(state)
    np.testing.assert_array_equal(back["x"], x)
    np.testing.assert_array_equal(back["updated"], np.asarray(jstate.updated))
    np.testing.assert_array_equal(back["log_target"], np.asarray(jstate.log_target))
    fresh = convert.kalman_chains_from_numpy(x, device="cpu", dtype=torch.float64)
    assert bool(fresh.updated.all()) and fresh.log_target is None
    assert convert.kalman_chains_to_numpy(fresh)["log_target"] is None


def test_chain_launch_arguments(monkeypatch):
    """What the wrappers hand the chain instances (the launch mocked: no
    card here): n, C and the `shared` mask, every chain-shared operand (a
    unit chain axis or an expanded view) as its (n, ...) slice, the rest
    (n, C, ...); the scans' C and hand-over buffer (C times a chain's); an
    operand that is neither (n, C, ...) nor (n, 1, ...) raises, a bare (n,
    ...) one beside (n, C, ...) ones too, also where n = C."""
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS
    from aux_ssm_tpu_torch.ops.cuda import kalman_fused as KF
    launched = []
    for mod in (KF, FS):
        monkeypatch.setattr(mod, "_on_cuda", lambda name, ref: True)
        monkeypatch.setattr(mod, "launch", lambda name, dtype, *a: launched.append((name, a)))
    n, Cc, dx, dy = 5, 3, 4, 2
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    F = rand(n, dx, dx)
    args = (F[:, None], F[:, None].expand(n, Cc, dx, dx), rand(n, 1, dx), rand(n, Cc, dy, dx),
            rand(n, Cc, dy, dy), rand(n, 1, dy), rand(n, Cc, dy), rand(n, Cc, dx),
            rand(n, Cc, dx, dx))
    out = KF.make_elements(*args)
    name, a = launched[-1]
    assert name == "make_elements" and a[:5] == (n, Cc, 0b100111, dx, dy)
    assert [tuple(t.shape) for t in a[5:14]] == [(n, dx, dx), (n, dx, dx), (n, dx),
                                                 (n, Cc, dy, dx), (n, Cc, dy, dy), (n, dy),
                                                 (n, Cc, dy), (n, Cc, dx), (n, Cc, dx, dx)]
    assert torch.equal(a[5], F) and all(t.is_contiguous() for t in a[5:14])
    assert [tuple(t.shape) for t in out] == [(n, Cc, dx, dx), (n, Cc, dx), (n, Cc, dx, dx),
                                             (n, Cc, dx), (n, Cc, dx, dx)]
    assert KF.ell(*args).shape == (n, Cc) and launched[-1][1][:3] == (n, Cc, 0b100111)
    one = tuple(z[:, 0].contiguous() for z in args)
    KF.make_elements(*one)
    assert launched[-1][1][:5] == (n, 1, 0, dx, dy)
    KF.make_elements(*(z[:, :1] for z in args))  # C = 1 with a chain axis: nothing shared
    assert launched[-1][1][:3] == (n, 1, 0)
    with pytest.raises(ValueError, match="chain axis"):
        KF.make_elements(*args[:3], rand(n, 2, dy, dx), *args[4:])
    square = (rand(Cc, 1, dx, dx),) + tuple(rand(Cc, Cc, *z.shape[2:]) for z in args[1:])
    KF.make_elements(*square)
    with pytest.raises(ValueError, match="chain axis"):  # a bare (n, ...) beside (n, C, ...)
        KF.make_elements(square[0][:, 0], *square[1:])

    elems = (rand(n, Cc, dx, dx), rand(n, Cc, dx), rand(n, Cc, dx, dx), rand(n, Cc, dx),
             rand(n, Cc, dx, dx))
    FS.filter_scan(elems)
    name, a = launched[-1]
    assert name == "filter_scan" and a[:3] == (n, Cc, dx)
    chunks = FS.scan_chunks(n)  # a chain's words: (levels + 1) x chunks f64 slots, 2 a value
    assert a[13].numel() >= Cc * chunks.bit_length() * chunks * FS.SLOTS["filter"][16] * 2
    FS.filter_scan(tuple(z[:, 0].contiguous() for z in elems))
    assert launched[-1][1][:3] == (n, 1, dx)
    FS.affine_scan(elems[0], elems[1], reverse=True)
    assert launched[-1][0] == "affine_scan" and launched[-1][1][:4] == (n, Cc, dx, 1)


# --------------------------------------------------------------------------
# The batched MH steps
# --------------------------------------------------------------------------

FLAG_T, FLAG_DX = 16, 4


@pytest.mark.parametrize("parallel", [False])
def test_flagship_chains_match_jax_vmap(parallel):
    """The flagship's order-1 step, the port's time-first batched kernel
    (`get_kernel(..., chains=True)`) started from and read back through
    `convert`'s batched state."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
    from headline_ess import build_order2_factory
    jdyn, jobs1, _, jtarget = build_order2_factory(FLAG_T, FLAG_DX, f64)
    jinit, jkernel = jkalman.get_kernel(jdyn, jobs1, jtarget, parallel=parallel)
    tdyn, tobs1, _, ttarget = lgssm_flagship.build_order2_factory(
        FLAG_T, FLAG_DX, device="cpu", dtype=torch.float64, chains=True)
    _, tkernel = tkalman.get_kernel(tdyn, tobs1, ttarget, parallel, chains=True)

    x0 = 0.5 * np.random.default_rng(1).standard_normal((C, FLAG_T, FLAG_DX))
    jstate = jax.vmap(jinit)(jnp.asarray(x0))
    start = convert.kalman_chains_from_numpy(np.asarray(jstate.x), np.asarray(jstate.updated),
                                             np.asarray(jstate.log_target), device="cpu",
                                             dtype=torch.float64)
    _close(start.log_target, jstate.log_target, rtol=1e-12)

    def time_first(state, delta, noise):
        noise = (noise[0].transpose(0, 1), noise[1].transpose(0, 1), noise[2])
        return tkernel(state, delta, noise=noise)

    def check(tstate, jstate):
        back = convert.kalman_chains_to_numpy(tstate)
        _close(back["x"], jstate.x)
        _close(back["log_target"], jstate.log_target)

    acc = _steps(jkernel, jstate, time_first, start, np.array([0.8, 3.0, 10.0]),
                 jax.random.key(11 + parallel), 3,
                 lambda k: _kalman_noise(k, (FLAG_T, FLAG_DX)), check)
    assert acc.any() and not acc.all(), acc


SV = (0.0, 0.9, 2.0, 0.25)  # experiments/sv.py
SV_T, SV_D = 12, 30


@pytest.fixture(scope="module")
def sv_data():
    xs, ys = jsv.get_data(jax.random.key(0), *SV, SV_D, SV_T)
    return np.array(xs), np.array(ys)


@pytest.mark.parametrize("order,parallel", [(1, True), (2, False)])
def test_sv_kalman_chains_match_jax_vmap(sv_data, order, parallel):
    xs, ys = sv_data
    jinit, jkernel = jsv.get_kalman_kernel(jnp.asarray(ys), *SV, parallel, order)
    tinit, tkernel = tsv.get_kalman_kernel(_t(ys), *SV, parallel, order=order, chains=True)
    assert tkernel.chain_axis
    x0 = xs[None] + 0.3 * np.random.default_rng(order).standard_normal((C, SV_T, SV_D))
    jstate, tstate = jax.vmap(jinit)(jnp.asarray(x0)), tinit(_t(x0))
    _close(tstate.log_target, jstate.log_target, rtol=1e-12)

    def check(tstate, jstate):
        _close(tstate.x, jstate.x)
        _close(tstate.log_target, jstate.log_target)

    acc = _steps(jkernel, jstate, tkernel, tstate, np.array([0.01, 0.05, 0.2]),
                 jax.random.key(10 * order + parallel), 3,
                 lambda k: _kalman_noise(k, (SV_T, SV_D)), check)
    assert acc.any() and not acc.all(), acc


def test_sv_one_chain_of_the_batched_kernel_equals_the_one_chain_kernel(sv_data):
    """C = 1 of the batched kernel: the same state, accept and target value
    as the one-chain kernel given the same noise."""
    xs, ys = sv_data
    init1, kernel1 = tsv.get_kalman_kernel(_t(ys), *SV, True, order=1)
    initc, kernelc = tsv.get_kalman_kernel(_t(ys), *SV, True, order=1, chains=True)
    one, batched = init1(_t(xs)), initc(_t(xs)[None])
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        noise = (torch.randn(SV_T, SV_D, generator=gen, dtype=torch.float64),
                 torch.randn(SV_T, SV_D, generator=gen, dtype=torch.float64),
                 torch.rand((), generator=gen, dtype=torch.float64))
        one = kernel1(one, 0.05, noise=noise)
        batched = kernelc(batched, torch.tensor([0.05], dtype=torch.float64),
                          noise=tuple(z[None] for z in noise))
        assert bool(one.updated) == bool(batched.updated[0])
        _close(batched.x[0], one.x, rtol=1e-12, atol=1e-13)
        _close(batched.log_target[0], one.log_target, rtol=1e-12)


LZ_T, LZ_EVERY, LZ_DT, LZ_SIGMA_X, LZ_SIGMA_THETA = 64, 4, 0.02, 3.0, 100.0
LZ_M0 = np.array([1.5, -1.5, 25.0])


@pytest.fixture(scope="module")
def lorenz_model():
    theta = np.array([10.0, 28.0, 8.0 / 3.0])
    xs = np.asarray(jl.sample_trajectory(jax.random.key(0), jnp.asarray(LZ_M0), jnp.eye(3),
                                         jnp.asarray(theta), LZ_SIGMA_X, LZ_DT, LZ_T))
    obs_idx = np.arange(0, LZ_T, LZ_EVERY)
    ys = xs[obs_idx, 1:] + 0.5 * np.random.default_rng(0).standard_normal((len(obs_idx), 2))
    data = np.column_stack([obs_idx * LZ_DT, ys])
    return xs, theta, jl.observations_model(data, 0.5, LZ_T, LZ_EVERY)


@pytest.mark.parametrize("parallel", [False])
def test_lorenz_gibbs_chains_match_jax_vmap(lorenz_model, parallel):
    xs, theta, obs = lorenz_model
    jinit, jkernel = jl.get_gibbs_kernel(*map(jnp.asarray, obs), jnp.asarray(LZ_M0), jnp.eye(3),
                                         LZ_SIGMA_X, LZ_DT, LZ_SIGMA_THETA, parallel)
    tinit, tkernel = tl.get_gibbs_kernel(*map(_t, obs), _t(LZ_M0), torch.eye(3, dtype=torch.float64),
                                         LZ_SIGMA_X, LZ_DT, LZ_SIGMA_THETA, parallel,
                                         chains=True)
    assert tkernel.chain_axis
    rng = np.random.default_rng(parallel)
    x0 = xs[None] + 0.1 * rng.standard_normal((C, LZ_T, 3))
    th0 = theta[None] * (1.0 + 0.1 * rng.standard_normal((C, 3)))
    jstate = jax.vmap(jinit)(jnp.asarray(x0), jnp.asarray(th0))
    tstate = tinit(_t(x0), _t(th0))

    def noise_of(key):
        key_traj, key_theta = jax.random.split(key)
        return _kalman_noise(key_traj, (LZ_T, 3)), jax.random.normal(key_theta, (3,), f64)

    def check(tstate, jstate):
        _close(tstate.x, jstate.x, atol=1e-9)
        _close(tstate.theta, jstate.theta)
        assert tstate.kalman_state.log_target is None

    acc = _steps(jkernel, jstate, tkernel, tstate, np.array([3.0, 10.0, 30.0]),
                 jax.random.key(7 + parallel), 4, noise_of, check)
    assert acc.any() and not acc.all(), acc


# --------------------------------------------------------------------------
# The drivers with --n-chains
# --------------------------------------------------------------------------

SMALL = ["--n-samples", "6", "--burnin", "4", "--no-verbose", "--platform", "cpu", "--seed",
         "3", "--n-chains", "2"]


@pytest.mark.parametrize("driver, extra", [
    (tsv_driver, ["--style", "kalman-1", "--T", "8", "--D", "3"]),
    (tsv_driver, ["--style", "kalman-2", "--T", "8", "--D", "3"]),
    (tlorenz_driver, ["--n-steps", "24", "--freq", "4"])])
def test_drivers_run_chains_as_one_batched_step(tmp_path, monkeypatch, capsys, driver, extra):
    """`--n-chains 2` runs both chains as one batched step an iteration: the
    kernel filters twice a step (the proposal and the reverse move), each
    time both chains at once; the state, samples and split-R-hat carry both
    chains."""
    filters, diags = [], []
    real_filtering, real_run = tkalman.filtering, cli.run_maybe_sharded
    monkeypatch.setattr(tkalman, "filtering", lambda ys, *a, **k: filters.append(
        tuple(ys.shape)) or real_filtering(ys, *a, **k))
    monkeypatch.setattr(cli, "run_maybe_sharded", lambda *a, **k: diags.append(
        real_run(*a, **k)) or diags[-1])
    saved = torch.get_default_dtype()
    try:
        res = driver.main(SMALL + extra + ["--out", str(tmp_path / "out.npz")])
    finally:
        torch.set_default_dtype(saved)
    T = int(extra[extra.index("--T") + 1]) if "--T" in extra else 24
    assert len(filters) == 2 * (4 + 6) and set(s[:2] for s in filters) == {(T, 2)}
    assert res.state.x.shape[:2] == (2, T) and res.stats.step.shape == (2,)
    assert res.samples.shape[:2] == (2, 6) and res.delta.shape[0] == 2
    _, diag = diags[0]
    assert diag["n_chains"] == 2 and set(diag) == {"stats", "rhat_max", "rhat_median",
                                                  "n_chains"}
    assert np.isfinite(diag["rhat_max"]) and diag["rhat_median"] <= diag["rhat_max"]
    printed = capsys.readouterr().out
    assert "2 chains" in printed and "Rhat max=" in printed and "median=" in printed
    assert all(np.isfinite(v).all() for v in np.load(tmp_path / "out.npz").values())
