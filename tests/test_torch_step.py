"""The port's whole auxiliary-Kalman MH step against the JAX package's, on
the flagship model, given the noise JAX draws; the flagship builder and the
converter against the JAX builder; and no JAX in the port.

Tolerance: float64 on both sides, same algebra in other summation and
association orders; the states agree to ~1e-12, and rtol 1e-9 catches any
wrong term.
"""
import os
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from aux_ssm_tpu.kernels import kalman as jkalman  # noqa: E402
from aux_ssm_tpu_torch import get_kernel, lgssm_from_numpy  # noqa: E402
from aux_ssm_tpu_torch.models import lgssm_flagship  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
T, DX = 64, 8
DELTA = 0.1


def _jax_factories():
    sys.path.insert(0, os.fspath(ROOT / "benchmarks"))
    from headline_ess import build_order2_factory
    return build_order2_factory(T, DX, jnp.float64)


@pytest.mark.parametrize("order", [1, 2])
def test_step_matches_jax_given_noise(order):
    jdyn, jobs1, jobs2, jtarget = _jax_factories()
    jinit, jkernel = jkalman.get_kernel(jdyn, jobs1 if order == 1 else jobs2, jtarget,
                                        parallel=True)
    tdyn, tobs1, tobs2, ttarget = lgssm_flagship.build_order2_factory(
        T, DX, device="cpu", dtype=torch.float64)
    tinit, tkernel = get_kernel(tdyn, tobs1 if order == 1 else tobs2, ttarget, parallel=True)

    x0 = np.zeros((T, DX))
    jstate, tstate = jinit(jnp.asarray(x0)), tinit(torch.as_tensor(x0))
    jstep = jax.jit(lambda k, s: jkernel(k, s, DELTA))
    accepted = []
    for key in jax.random.split(jax.random.key(order), 4):
        # The noise of one JAX step, drawn as kernels/kalman.py draws it.
        aux_key, sample_key, accept_key = jax.random.split(key, 3)
        noise = (jax.random.normal(aux_key, (T, DX), jnp.float64),
                 jax.random.normal(sample_key, (T, DX), jnp.float64),
                 jax.random.uniform(accept_key, (), jnp.float64))
        jstate = jstep(key, jstate)
        tstate = tkernel(tstate, DELTA, noise=tuple(torch.as_tensor(np.array(z)) for z in noise))
        assert bool(tstate.updated) == bool(jstate.updated)
        np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), rtol=1e-9,
                                   atol=1e-11)
        np.testing.assert_allclose(float(tstate.log_target), float(jstate.log_target),
                                   rtol=1e-9)
        accepted.append(bool(tstate.updated))

    if order == 2:
        # The second-order proposal is exact for this Gaussian target: every
        # step accepts, and alpha is 1 to rounding (u_accept just below 1).
        assert all(accepted)
        z = torch.zeros(T, DX, dtype=torch.float64)
        u_accept = torch.tensor(1 - 1e-9, dtype=torch.float64)
        st = tkernel(tstate, DELTA, noise=(z, z + 0.3, u_accept))
        assert bool(st.updated)


def test_flagship_builder_matches_jax():
    jdyn, jobs1, _, jtarget = _jax_factories()
    arrays = lgssm_flagship.build_arrays(T, DX)
    for got, want in zip(arrays[:5], jdyn(None)):
        np.testing.assert_array_equal(got, np.asarray(want))

    tdyn, tobs1, ttarget = lgssm_flagship.build_model(T, DX, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(4)
    x, u = rng.standard_normal((2, T, DX))
    # H, R, ys enter through the observation factory and the target density.
    for got, want in zip(tobs1(torch.as_tensor(x), torch.as_tensor(u), DELTA),
                         jobs1(jnp.asarray(x), jnp.asarray(u), DELTA)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(float(ttarget(torch.as_tensor(x))),
                               float(jtarget(jnp.asarray(x))), rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lgssm_from_numpy_round_trips(dtype):
    arrays = lgssm_flagship.build_arrays(16, 4, seed=3)
    lgssm, ys = lgssm_from_numpy(*arrays, device="cpu", dtype=dtype)
    for got, want in zip(tuple(lgssm) + (ys,), arrays):
        assert got.dtype == dtype and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))


def test_port_imports_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|aux_ssm_tpu)\b", re.M)
    files = sorted((ROOT / "aux_ssm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [f.name for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


@pytest.mark.parametrize("delta,acc", [(0.05, 0.15), (0.3, 0.9), (1e-19, 0.0)])
def test_delta_adaptation_matches_jax(delta, acc):
    from aux_ssm_tpu.kernels.adaptation import delta_adaptation as jax_adapt
    from aux_ssm_tpu_torch import delta_adaptation
    got = delta_adaptation(torch.tensor(delta, dtype=torch.float64), 0.5, acc, 0.1)
    np.testing.assert_allclose(float(got), float(jax_adapt(delta, 0.5, acc, 0.1)), rtol=1e-12)
