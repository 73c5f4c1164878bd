"""Per-time-step Kalman maps: wrappers of `csrc/kalman_fused.cu` with their
plain PyTorch versions (counterpart of `aux_ssm_tpu/ops/pallas/kalman_fused.py`).

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises. Each wrapper counts its kernel launches in
its `launches` attribute.

Shapes (n = T - 1 steps): Fs/Qs (n, dx, dx), bs (n, dx), Hs (n, dy, dx),
Rs (n, dy, dy), cs/ys (n, dy), ms/x (n, dx), Ps (n, dx, dx).
"""
import torch

from ..batched import mT, mv, sym
from ..chol import cholesky
from ..lgssm import _masked_step_logpdf, mask_observation
from ..mvn import logpdf as mvn_logpdf
from ._build import MAX_DIM, check_cuda_inputs, launch


def _on_cuda(name, ref):
    """True for a CUDA tensor, False for a CPU one; raises for other devices."""
    if ref.device.type == "cuda":
        return True
    if ref.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {ref.device}")


def _check_shapes(name, kinds, tensors, n, dx, dy):
    """Each tensor against the shape its kind letter names: F (n, dx, dx),
    x (n, dx), H (n, dy, dx), R (n, dy, dy), y (n, dy)."""
    want = {"F": (n, dx, dx), "x": (n, dx), "H": (n, dy, dx), "R": (n, dy, dy), "y": (n, dy)}
    for i, (kind, t) in enumerate(zip(kinds, tensors)):
        if tuple(t.shape) != want[kind]:
            raise ValueError(f"{name}: argument {i} has shape {tuple(t.shape)}, "
                             f"expected {want[kind]}")


# --------------------------------------------------------------------------
# Filtering elements (fused_make_elements)
# --------------------------------------------------------------------------

def make_elements_plain(Fs, Qs, bs, Hs, Rs, cs, ys, m, P):
    """SGF-2021 filtering elements (A, b, C, eta, J) of each step, with `m`,
    `P` the per-step states (the first step carries the updated initial
    state, the rest zeros)."""
    y_eff, H_eff, c_eff, R_eff, mask = mask_observation(ys, Hs, cs, Rs)
    m_pred = mv(Fs, m) + bs
    P_pred = Fs @ P @ mT(Fs) + Qs

    S = sym(H_eff @ P_pred @ mT(H_eff) + R_eff)
    if ys.shape[-1] == 1:
        S_invH = H_eff / S
    else:
        S_invH = torch.cholesky_solve(H_eff, cholesky(S))
    S_invH_T = mT(S_invH)

    K = P_pred @ S_invH_T
    A = Fs - K @ (H_eff @ Fs)

    y_diff_b = torch.where(mask, y_eff - mv(H_eff, bs) - c_eff, 0.0)
    y_diff_m = torch.where(mask, y_eff - mv(H_eff, m_pred) - c_eff, 0.0)

    b_el = m_pred + mv(K, y_diff_m)
    C = P_pred - K @ S @ mT(K)

    temp = mT(Fs) @ S_invH_T
    eta = mv(temp, y_diff_b)
    J = temp @ (H_eff @ Fs)
    return A, b_el, sym(C), eta, sym(J)


def make_elements(Fs, Qs, bs, Hs, Rs, cs, ys, m, P):
    """Filtering elements of each step; see `make_elements_plain`."""
    if not _on_cuda("make_elements", bs):
        return make_elements_plain(Fs, Qs, bs, Hs, Rs, cs, ys, m, P)
    n, dx = bs.shape
    dy = cs.shape[-1]
    args = (Fs, Qs, bs, Hs, Rs, cs, ys, m, P)
    _check_shapes("make_elements", "FFxHRyyxF", args, n, dx, dy)
    args = check_cuda_inputs("make_elements", args, bs.dtype, MAX_DIM, (dx, dy))
    A, C, J = (torch.empty_like(args[0]) for _ in range(3))
    b_el, eta = torch.empty_like(args[2]), torch.empty_like(args[2])
    if n:
        launch("make_elements", bs.dtype, n, dx, dy, *args, A, b_el, C, eta, J)
        make_elements.launches += 1
    return A, b_el, C, eta, J


make_elements.launches = 0


# --------------------------------------------------------------------------
# Log-likelihood increments (fused_ell)
# --------------------------------------------------------------------------

def ell_plain(Fs, Qs, bs, Hs, Rs, cs, ys, ms, Ps):
    """Predict + masked update log-likelihood increment of each step from
    the filtered (ms, Ps) of the step before: (n,)."""
    from ..filtering import kalman_predict_update  # filtering imports this module

    return kalman_predict_update(ms, Ps, Fs, bs, Qs, ys, Hs, cs, Rs)[2]


def ell(Fs, Qs, bs, Hs, Rs, cs, ys, ms, Ps):
    """Log-likelihood increments; see `ell_plain`."""
    if not _on_cuda("ell", bs):
        return ell_plain(Fs, Qs, bs, Hs, Rs, cs, ys, ms, Ps)
    n, dx = bs.shape
    dy = cs.shape[-1]
    args = (Fs, Qs, bs, Hs, Rs, cs, ys, ms, Ps)
    _check_shapes("ell", "FFxHRyyxF", args, n, dx, dy)
    args = check_cuda_inputs("ell", args, bs.dtype, MAX_DIM, (dx, dy))
    out = torch.empty(n, dtype=bs.dtype, device=bs.device)
    if n:
        launch("ell", bs.dtype, n, dx, dy, *args, out)
        ell.launches += 1
    return out


ell.launches = 0


# --------------------------------------------------------------------------
# Backward-sampling maps (fused_backward_maps)
# --------------------------------------------------------------------------

def backward_maps_plain(Fs, Qs, bs, ms, Ps, eps):
    """Backward-sampling gains G = P F^T S^{-1} and noisy increments
    m - G (F m + b) + safe_cholesky(P - G S G^T) eps of each step."""
    from ..sampling import backward_map_moments  # sampling imports this module

    inc_m, L, gains = backward_map_moments(Fs, Qs, bs, ms, Ps)
    return gains, inc_m + mv(L, eps)


def backward_maps(Fs, Qs, bs, ms, Ps, eps):
    """Backward-sampling gains and increments; see `backward_maps_plain`."""
    if not _on_cuda("backward_maps", bs):
        return backward_maps_plain(Fs, Qs, bs, ms, Ps, eps)
    n, dx = bs.shape
    args = (Fs, Qs, bs, ms, Ps, eps)
    _check_shapes("backward_maps", "FFxxFx", args, n, dx, 1)
    args = check_cuda_inputs("backward_maps", args, bs.dtype, MAX_DIM, (dx,))
    G, inc = torch.empty_like(args[0]), torch.empty_like(args[2])
    if n:
        launch("backward_maps", bs.dtype, n, dx, *args, G, inc)
        backward_maps.launches += 1
    return G, inc


backward_maps.launches = 0


# --------------------------------------------------------------------------
# Trajectory log-density steps (fused_logdensity_steps)
# --------------------------------------------------------------------------

def logdensity_steps_plain(Fs, Qs, bs, Hs, Rs, cs, ys, x_prev, x_cur):
    """log N(x_t; F x_{t-1} + b, Q) + masked log N(y_t; H x_t + c, R) of each
    step t >= 1: (n,)."""
    trans = mvn_logpdf(x_cur, mv(Fs, x_prev) + bs, cholesky(Qs))
    return trans + _masked_step_logpdf(ys, mv(Hs, x_cur) + cs, Rs)


def logdensity_steps(Fs, Qs, bs, Hs, Rs, cs, ys, x_prev, x_cur):
    """Per-step trajectory log-density; see `logdensity_steps_plain`."""
    if not _on_cuda("logdensity_steps", bs):
        return logdensity_steps_plain(Fs, Qs, bs, Hs, Rs, cs, ys, x_prev, x_cur)
    n, dx = bs.shape
    dy = cs.shape[-1]
    args = (Fs, Qs, bs, Hs, Rs, cs, ys, x_prev, x_cur)
    _check_shapes("logdensity_steps", "FFxHRyyxx", args, n, dx, dy)
    args = check_cuda_inputs("logdensity_steps", args, bs.dtype, MAX_DIM, (dx, dy))
    out = torch.empty(n, dtype=bs.dtype, device=bs.device)
    if n:
        launch("logdensity_steps", bs.dtype, n, dx, dy, *args, out)
        logdensity_steps.launches += 1
    return out


logdensity_steps.launches = 0
