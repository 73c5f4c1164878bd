"""Per-time-step Kalman maps: wrappers of `csrc/kalman_fused.cu` with their
plain PyTorch versions (counterpart of `aux_ssm_tpu/ops/pallas/kalman_fused.py`).

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises. On the card each kernel has compile-time
instances chosen in the kernel library by max(dx, dy) and the dtype: D = 16
up to 16, D = 32 up to 32, and in float32 D = 48 up to 48
(`_build.instance_dim`); past the dtype's last (`_build.max_dim`: 48 in
float32, 32 in float64) the wrapper raises. Each wrapper counts its kernel
launches (any instance) in its `launches` attribute.

Shapes (n = T - 1 steps): Fs/Qs (n, dx, dx), bs (n, dx), Hs (n, dy, dx),
Rs (n, dy, dy), cs/ys (n, dy), ms/x (n, dx), Ps (n, dx, dx).

Chain axis (the dense batched layout of `ops/lgssm.py`): with bs (n, C, dx),
every operand is (n, C, ...) or (n, 1, ...), and the outputs are (n, C,
...): C chains' steps in one launch of the same kernel, a block a (step,
chain) pair. An operand whose chain axis has stride 0 (an `expand`ed view,
e.g. F, Q and b that every chain shares) reaches the kernel as its (n, ...)
slice, once for all chains, with its bit set in the launch's `shared` mask:
nothing is copied C times. The plain versions broadcast. C = 1 gives the
one-chain call's values bit for bit, and chain c of a C-chain launch those of
a one-chain launch on its inputs.
"""
import torch

from ..batched import mT, mv, sym
from ..chol import cholesky
from ..lgssm import _masked_step_logpdf, mask_observation
from ..mvn import logpdf as mvn_logpdf
from ._build import check_cuda_inputs, launch, max_dim


def _on_cuda(name, ref):
    """True for a CUDA tensor, False for a CPU one; raises for other devices."""
    if ref.device.type == "cuda":
        return True
    if ref.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {ref.device}")


def _kind_shapes(dx, dy):
    """A step's shape of each operand kind: F (dx, dx), x (dx,), H (dy, dx),
    R (dy, dy), y (dy,)."""
    return {"F": (dx, dx), "x": (dx,), "H": (dy, dx), "R": (dy, dy), "y": (dy,)}


def _check_shapes(name, kinds, tensors, n, dx, dy, chains=None):
    """Each tensor against the shape its kind letter names (`_kind_shapes`)
    after (n,), or with `chains` C after (n, C)."""
    lead = (n,) if chains is None else (n, chains)
    want = _kind_shapes(dx, dy)
    for i, (kind, t) in enumerate(zip(kinds, tensors)):
        if tuple(t.shape) != lead + want[kind]:
            raise ValueError(f"{name}: argument {i} has shape {tuple(t.shape)}, "
                             f"expected {lead + want[kind]}")


def chain_operands(name, kinds, tensors, dims):
    """The operands of a per-step kernel for the card: (lead, C, shared,
    tensors), `lead` the outputs' leading shape. Without a chain axis (every
    operand of its kind's shape after (n,), `_check_shapes`) lead is (n,), C
    = 1 and `shared` 0. With one, every operand is (n, C, ...) or, every
    chain's, (n, 1, ...): a bare (n, ...) operand beside them raises (read
    from the right, its n would pass for a chain axis where n = C). Then
    lead is (n, C) and each tensor is expanded to (n, C, ...); where C > 1
    and its chain axis has stride 0 (an `expand`ed view, or (n, 1, ...)) it
    goes as its (n, ...) slice and sets its bit (its place in `tensors`) in
    `shared`. Every tensor checked by `check_cuda_inputs` (contiguous, one
    dtype and device, dims in range)."""
    ref = tensors[kinds.index("x")]
    shapes = _kind_shapes(dims[0], dims[-1])
    leads = [tuple(t.shape[:t.dim() - len(shapes[k])]) for k, t in zip(kinds, tensors)]
    n = tensors[0].shape[0]
    if all(len(lead) == 1 for lead in leads):
        _check_shapes(name, kinds, tensors, n, dims[0], dims[-1])
        return (n,), 1, 0, check_cuda_inputs(name, tensors, ref.dtype, max_dim(ref.dtype), dims)
    C = max((lead[1] for lead in leads if len(lead) == 2), default=1)
    shared, out = 0, []
    for i, (kind, t, lead) in enumerate(zip(kinds, tensors, leads)):
        if len(lead) != 2 or lead[0] != n or lead[1] not in (1, C) or (
                t.shape[2:] != shapes[kind]):
            raise ValueError(f"{name}: argument {i} has shape {tuple(t.shape)}; with a chain "
                             f"axis every operand is (n, C) + {shapes[kind]} or (n, 1) + "
                             f"{shapes[kind]}, n = {n}, C = {C}")
        t = t.expand((n, C) + shapes[kind])
        if C > 1 and t.stride(1) == 0:
            shared |= 1 << i
            t = t[:, 0]
        out.append(t)
    return (n, C), C, shared, check_cuda_inputs(name, out, ref.dtype, max_dim(ref.dtype), dims)


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


ELEMENTS_STAMPS = 6  # kElemStamps: clock64 readings of a step


def _elements_io(args):
    """make_elements' dimensions (n, C, shared, dx, dy), its inputs checked
    for the card and its outputs (A, b, C, eta, J), empty."""
    bs, cs = args[2], args[5]
    dx, dy = bs.shape[-1], cs.shape[-1]
    lead, C, shared, args = chain_operands("make_elements", "FFxHRyyxF", args, (dx, dy))
    new = dict(dtype=bs.dtype, device=bs.device)
    A, Cm, J = (torch.empty(lead + (dx, dx), **new) for _ in range(3))
    b_el, eta = (torch.empty(lead + (dx,), **new) for _ in range(2))
    return (lead[0], C, shared, dx, dy), args, (A, b_el, Cm, eta, J)


def make_elements(Fs, Qs, bs, Hs, Rs, cs, ys, m, P):
    """Filtering elements of each step; see `make_elements_plain`."""
    args = (Fs, Qs, bs, Hs, Rs, cs, ys, m, P)
    if not _on_cuda("make_elements", bs):
        return make_elements_plain(*args)
    dims, args, out = _elements_io(args)
    if dims[0]:
        launch("make_elements", bs.dtype, *dims, *args, *out, None)
        make_elements.launches += 1
    return out


make_elements.launches = 0


def elements_cycles(args):
    """Diagnostics on the card: `make_elements(*args)` once, with thread 0's
    clock64 in each step's block at its phases; returns stamps (n,
    ELEMENTS_STAMPS) int64: at the start, after the staging, after S, after
    the solve, after K and at the end. Not counted in
    `make_elements.launches`."""
    dims, args, out = _elements_io(args)
    stamps = torch.zeros(dims[0] * dims[1], ELEMENTS_STAMPS, dtype=torch.int64,
                         device=args[2].device)
    launch("make_elements", args[2].dtype, *dims, *args, *out, stamps)
    return stamps


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
    dx, dy = bs.shape[-1], cs.shape[-1]
    lead, C, shared, args = chain_operands("ell", "FFxHRyyxF",
                                           (Fs, Qs, bs, Hs, Rs, cs, ys, ms, Ps), (dx, dy))
    out = torch.empty(lead, dtype=bs.dtype, device=bs.device)
    if lead[0]:
        launch("ell", bs.dtype, lead[0], C, shared, dx, dy, *args, out)
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


MAPS_STAMPS = 7  # kMapStamps: clock64 readings of a step


def _maps_io(args):
    """backward_maps' dimensions (n, C, shared, dx), its inputs checked for
    the card and its outputs (G, inc), empty."""
    bs = args[2]
    dx = bs.shape[-1]
    lead, C, shared, args = chain_operands("backward_maps", "FFxxFx", args, (dx,))
    new = dict(dtype=bs.dtype, device=bs.device)
    return ((lead[0], C, shared, dx), args,
            (torch.empty(lead + (dx, dx), **new), torch.empty(lead + (dx,), **new)))


def backward_maps(Fs, Qs, bs, ms, Ps, eps):
    """Backward-sampling gains and increments; see `backward_maps_plain`."""
    args = (Fs, Qs, bs, ms, Ps, eps)
    if not _on_cuda("backward_maps", bs):
        return backward_maps_plain(*args)
    dims, args, out = _maps_io(args)
    if dims[0]:
        launch("backward_maps", bs.dtype, *dims, *args, *out, None)
        backward_maps.launches += 1
    return out


backward_maps.launches = 0


def maps_cycles(args):
    """Diagnostics on the card: `backward_maps(*args)` once, with thread 0's
    clock64 in each step's block at its phases; returns stamps (n,
    MAPS_STAMPS) int64: at the start, after the staging, S, the solve, cov,
    the factor and the outputs. Not counted in `backward_maps.launches`."""
    dims, args, out = _maps_io(args)
    stamps = torch.zeros(dims[0] * dims[1], MAPS_STAMPS, dtype=torch.int64,
                         device=args[2].device)
    launch("backward_maps", args[2].dtype, *dims, *args, *out, stamps)
    return stamps


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
    dx, dy = bs.shape[-1], cs.shape[-1]
    lead, C, shared, args = chain_operands(
        "logdensity_steps", "FFxHRyyxx", (Fs, Qs, bs, Hs, Rs, cs, ys, x_prev, x_cur), (dx, dy))
    out = torch.empty(lead, dtype=bs.dtype, device=bs.device)
    if lead[0]:
        launch("logdensity_steps", bs.dtype, lead[0], C, shared, dx, dy, *args, out)
        logdensity_steps.launches += 1
    return out


logdensity_steps.launches = 0
