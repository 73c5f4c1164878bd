"""cSMC sweeps: wrappers of `csrc/csmc_fwd.cu`, `csrc/csmc_lane.cu` and
`csrc/csmc_block_lane.cu` with their plain PyTorch versions (counterpart of
`aux_ssm_tpu/ops/pallas/csmc_fwd.py`).

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises. Each wrapper counts its kernel launches in
its `launches` attribute. A factor sweep of at most WARP_N particles
launches two kernels (the pair-score pass, then the sweep on one warp) and
counts both; past WARP_N it launches one. The plain versions follow the
XLA oracles of the JAX package (`factor_scan_xla`,
`backward_factor_scan_xla`, `lane_scan_xla`, `block_lane_scan_xla`) step
for step; indices are int64.

Shapes (n = T - 1 steps, N particles, k factor width, d state width):
rf, cf (n, N, k); rb, cb, log_ws, res_u (n, N); anc_u, us (n,); w0 (N,);
block-lane sweep: eps, xs (n, d, N); x_star (n, d); x0 (d, N);
lane sweep (scalar state): eps, xs (n, N); x_star (n,); x0 (N,).

Chain axis: every sweep also takes C independent chains at once, every
operand (and output) with a leading C (rf (C, n, N, k), b_T (C,), the lane
and block-lane functors' rows (C, n, P); their constants shared). On the
card that is one launch of each kernel, a block a chain (the pair-score
pass: C n blocks); C = 1 gives the one-chain call's values bit for bit. The
plain versions run the one-chain plain version on each chain.
"""
import torch

from ...kernels.csmc_base import tree_map
from ._build import check_cuda_inputs, launch
from .kalman_fused import _on_cuda

MAX_N = 8192        # factor and lane kernels (the TPU kernels' _LANE_MAX_N)
WARP_N = 32         # kWarpN of csrc/csmc_fwd.cu: the factor sweeps' one-warp path
MAX_BLOCK_N = 1024  # block-lane kernel (the TPU kernel's dense cap)


def _at(tree, t):
    return tree_map(lambda z: z[t], tree)


def _carry(log_w):
    """The normalised carry exp(lw - max) / sum, as the oracles and kernels
    compute it."""
    wn = torch.exp(log_w - log_w.max())
    return wn / wn.sum()


def _resample(cw, u, N):
    """#{i : cw[i] < u[j]} for each j, clamped to N - 1."""
    return torch.searchsorted(cw, u.contiguous()).clamp_(max=N - 1)


def _check_n(name, N, cap):
    if not 1 <= N <= cap:
        raise ValueError(f"{name}: the CUDA kernel takes 1..{cap} particles, got {N}")


def _check_shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _for_chains(tree, C):
    """Per-step params of C chains: a leaf with a unit chain axis (shared by
    every chain, `csmc_base.shared_by_chains`) expanded to C, a view."""
    return tree_map(lambda z: z.expand(C, *z.shape[1:]) if z.shape[0] == 1 else z, tree)


def _per_chain(plain, *args, chains=None, **kw):
    """A plain version on each chain of its leading axis (`chains` C, default
    the first argument's; every tensor in `args` and in their trees sliced),
    the outputs stacked."""
    C = args[0].shape[0] if chains is None else chains
    outs = [plain(*(tree_map(lambda z: z[c], a) for a in args), **kw) for c in range(C)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(z) for z in zip(*outs))
    return torch.stack(outs)


# --------------------------------------------------------------------------
# Pair scores: the first kernel of the factor sweeps at N <= WARP_N
# --------------------------------------------------------------------------

def _record_words(N, vectors, dtype):
    """Words of a step's record (record_words of csrc/csmc_fwd.cu)."""
    q = 16 // (torch.finfo(dtype).bits // 8)
    return (N * WARP_N + vectors * N + 1 + q - 1) // q * q


def pair_scores_plain(a, b, vectors, scalar):
    """Each step's record: its pair scores a[t, r] . b[t, c] in N rows of
    WARP_N (0 past column N), then its rows of the (n, N) `vectors` (two or
    three) and its entry of the (n,) `scalar`, then 0 to 16 bytes. Shapes: a,
    b (n, N, k); returns (n, words)."""
    n, N, _ = a.shape
    sw = N * WARP_N
    out = a.new_zeros(n, _record_words(N, len(vectors), a.dtype))
    out[:, :sw].unflatten(1, (N, WARP_N))[..., :N] = a @ b.transpose(1, 2)
    for i, v in enumerate(vectors):
        out[:, sw + i * N:sw + (i + 1) * N] = v
    out[:, sw + len(vectors) * N] = scalar
    return out


def pair_scores(a, b, vectors, scalar):
    """The records of every step at once; see `pair_scores_plain`. The
    forward sweep takes (rf, cf, (rb, cb, res_u), anc_u), a score row an
    ancestor; the backward sweep (cf, rf, (log_ws, rb), us), a row a next
    index. On the card each score sums its k products in order, as the
    sweeps' block path does. The sweeps count its launches."""
    if not _on_cuda("pair_scores", a):
        return pair_scores_plain(a, b, vectors, scalar)
    n, N, k = a.shape
    _check_n("pair_scores", N, WARP_N)
    if len(vectors) not in (2, 3):
        raise ValueError(f"pair_scores: takes two or three vectors, got {len(vectors)}")
    for t, shape in ((b, (n, N, k)), *((v, (n, N)) for v in vectors), (scalar, (n,))):
        _check_shape("pair_scores", t, shape)
    a, b, *vectors, scalar = check_cuda_inputs("pair_scores", (a, b, *vectors, scalar),
                                               a.dtype, 1, ())
    out = a.new_empty(n, _record_words(N, len(vectors), a.dtype))
    if n:  # a third vector's pointer is passed, and not read, when there are two
        launch("csmc_pair_scores", a.dtype, n, N, k, len(vectors), a, b, vectors[0], vectors[1],
               vectors[-1], scalar, out)
    return out


# --------------------------------------------------------------------------
# Forward factor sweep (fused_forward_scan)
# --------------------------------------------------------------------------

def forward_factor_scan_plain(rf, cf, rb, cb, res_u, anc_u, w0, pgas=False):
    """T-1 steps of conditional multinomial resampling from `res_u` and
    reweighting log_w = cb + rb[anc] + rf[anc] . cf, the weights carried
    normalised; lane 0 pinned to 0, or redrawn under PGAS from
    log(max(w, 1e-37)) + rb + rf . cf[0] at anc_u * total.
    Returns (log_ws (n, N), ancestors (n, N) int64)."""
    n, N, _ = rf.shape
    log_ws = rf.new_empty(n, N)
    ancestors = torch.empty(n, N, dtype=torch.int64, device=rf.device)
    w = w0
    for t in range(n):
        anc = _resample(torch.cumsum(w, 0), res_u[t], N)
        if pgas:
            score = torch.log(torch.clamp_min(w, 1e-37)) + rb[t] + rf[t] @ cf[t, 0]
            cwa = torch.cumsum(torch.exp(score - score.max()), 0)
            anc[0] = (cwa < anc_u[t] * cwa[-1]).sum().clamp(max=N - 1)
        else:
            anc[0] = 0
        log_w = cb[t] + rb[t][anc] + (rf[t][anc] * cf[t]).sum(-1)
        log_ws[t], ancestors[t] = log_w, anc
        w = _carry(log_w)
    return log_ws, ancestors


def forward_factor_scan(rf, cf, rb, cb, res_u, anc_u, w0, pgas=False):
    """The forward factor sweep; see `forward_factor_scan_plain`. With a
    leading chain axis on every operand, C chains' sweeps at once."""
    chained = rf.dim() == 4
    if not _on_cuda("forward_factor_scan", rf):
        if chained:
            return _per_chain(forward_factor_scan_plain, rf, cf, rb, cb, res_u, anc_u, w0,
                              pgas=pgas)
        return forward_factor_scan_plain(rf, cf, rb, cb, res_u, anc_u, w0, pgas)
    *lead, n, N, k = rf.shape
    C = lead[0] if chained else 1
    _check_n("forward_factor_scan", N, MAX_N)
    for t, shape in ((cf, (n, N, k)), (rb, (n, N)), (cb, (n, N)), (res_u, (n, N)),
                     (anc_u, (n,)), (w0, (N,))):
        _check_shape("forward_factor_scan", t, (*lead, *shape))
    args = check_cuda_inputs("forward_factor_scan", (rf, cf, rb, cb, res_u, anc_u, w0),
                             rf.dtype, 1, ())
    log_ws = rf.new_empty(*lead, n, N)
    ancestors = torch.empty(*lead, n, N, dtype=torch.int64, device=rf.device)
    if not n:
        return log_ws, ancestors
    if N <= WARP_N:
        rf, cf, rb, cb, res_u, anc_u, w0 = args
        # The chains fold into the pair-score pass's step axis.
        records = pair_scores(rf.reshape(C * n, N, k), cf.reshape(C * n, N, k),
                              tuple(z.reshape(C * n, N) for z in (rb, cb, res_u)),
                              anc_u.reshape(C * n))
        forward_factor_scan.launches += 1
        launch("csmc_forward_factor_warp", rf.dtype, C, n, N, int(pgas), records, w0, log_ws,
               ancestors)
    else:
        launch("csmc_forward_factor", rf.dtype, C, n, N, k, int(pgas), *args, log_ws,
               ancestors)
    forward_factor_scan.launches += 1
    return log_ws, ancestors


forward_factor_scan.launches = 0


# --------------------------------------------------------------------------
# Backward factor sweep (fused_backward_scan)
# --------------------------------------------------------------------------

def backward_factor_scan_plain(rf, cf, rb, log_ws, us, b_T):
    """Whiteley backward sampling through pair factors, t = n-1 .. 0:
    score = log_ws[t] + rb[t] + rf[t] . cf[t, b_next], index = inverse CDF of
    exp(score - max) at us[t] * total. `b_T` is a 0-d int64 tensor (the draw
    at the last step). Returns picked (n,) int64, the indices at steps 0..n-1."""
    n, N, _ = rf.shape
    picked = torch.empty(n, dtype=torch.int64, device=rf.device)
    b = b_T.reshape(1)
    for t in range(n - 1, -1, -1):
        score = log_ws[t] + rb[t] + rf[t] @ cf[t][b][0]
        cw = torch.cumsum(torch.exp(score - score.max()), 0)
        b = (cw < us[t] * cw[-1]).sum().clamp(max=N - 1).reshape(1)
        picked[t] = b[0]
    return picked


def backward_factor_scan(rf, cf, rb, log_ws, us, b_T):
    """The backward factor sweep; see `backward_factor_scan_plain`. With a
    leading chain axis on every operand (b_T (C,)), C chains' sweeps at
    once."""
    chained = rf.dim() == 4
    if not _on_cuda("backward_factor_scan", rf):
        if chained:
            return _per_chain(backward_factor_scan_plain, rf, cf, rb, log_ws, us, b_T)
        return backward_factor_scan_plain(rf, cf, rb, log_ws, us, b_T)
    *lead, n, N, k = rf.shape
    C = lead[0] if chained else 1
    _check_n("backward_factor_scan", N, MAX_N)
    for t, shape in ((cf, (n, N, k)), (rb, (n, N)), (log_ws, (n, N)), (us, (n,))):
        _check_shape("backward_factor_scan", t, (*lead, *shape))
    args = check_cuda_inputs("backward_factor_scan", (rf, cf, rb, log_ws, us), rf.dtype, 1, ())
    b_T = b_T.reshape(C).to(torch.int64)
    if b_T.device != rf.device:
        raise ValueError(f"backward_factor_scan: b_T must be on {rf.device}, got {b_T.device}")
    picked = torch.empty(*lead, n, dtype=torch.int64, device=rf.device)
    if not n:
        return picked
    if N <= WARP_N:
        rf, cf, rb, log_ws, us = args
        records = pair_scores(cf.reshape(C * n, N, k), rf.reshape(C * n, N, k),
                              (log_ws.reshape(C * n, N), rb.reshape(C * n, N)),
                              us.reshape(C * n))
        backward_factor_scan.launches += 1
        launch("csmc_backward_factor_warp", rf.dtype, C, n, N, records, b_T.contiguous(),
               picked)
    else:
        launch("csmc_backward_factor", rf.dtype, C, n, N, k, *args, b_T.contiguous(), picked)
    backward_factor_scan.launches += 1
    return picked


backward_factor_scan.launches = 0


# --------------------------------------------------------------------------
# Lane forward sweep (lane_forward_scan): scalar state, the model in the kernel
# --------------------------------------------------------------------------

# cuda_model -> (constants, per-step parameters) of its functor in
# csrc/csmc_models.cuh.
LANE_MODELS = {"theta_logistic": (5, 1), "rare_event_guided": (2, 10),
               "rare_event_bootstrap": (1, 5), "ar1_gauss": (3, 1)}


def lane_scan_plain(propagate, logw, pgas_logpdf, mt_params, gt_params, pt_params, eps, res_u,
                    anc_u, x_star, x0, w0):
    """State-dependent cSMC forward sweep of a scalar-state model on (N,)
    particle rows. `propagate(eps, x_prev, mt_p) -> (N,)`, `logw(x_next,
    x_prev, gt_p) -> (N,)` and `pgas_logpdf(x_star, x_prev, pt_p) -> (N,)`
    (None: no ancestor sampling) are the model's lane callables; `mt_p`,
    `gt_p`, `pt_p` one time step of the params. Conditional multinomial
    resampling of the carried weights; lane 0 pinned to 0, or redrawn under
    PGAS from log(max(w, 1e-37)) + pgas_logpdf(x*_t, x_prev) at anc_u * total;
    particle 0 pinned to x*_t.
    Returns (xs (n, N), log_ws (n, N), ancestors (n, N) int64)."""
    n, N = res_u.shape
    xs = eps.new_empty(n, N)
    log_ws = eps.new_empty(n, N)
    ancestors = torch.empty(n, N, dtype=torch.int64, device=eps.device)
    x_prev, w = x0, w0
    for t in range(n):
        anc = _resample(torch.cumsum(w, 0), res_u[t], N)
        if pgas_logpdf is not None:
            score = (torch.log(torch.clamp_min(w, 1e-37))
                     + pgas_logpdf(x_star[t], x_prev, _at(pt_params, t)))
            cwa = torch.cumsum(torch.exp(score - score.max()), 0)
            anc[0] = (cwa < anc_u[t] * cwa[-1]).sum().clamp(max=N - 1)
        else:
            anc[0] = 0
        x_res = x_prev[anc]
        x_t = propagate(eps[t], x_res, _at(mt_params, t))
        x_t[0] = x_star[t]
        log_w = logw(x_t, x_res, _at(gt_params, t))
        xs[t], log_ws[t], ancestors[t] = x_t, log_w, anc
        x_prev, w = x_t, _carry(log_w)
    return xs, log_ws, ancestors


def lane_scan(Mt, Gt, Pt, eps, res_u, anc_u, x_star, x0, w0):
    """The lane sweep of the scalar-state model (Mt, Gt), with ancestor
    sampling from `Pt.lane_logpdf` when `Pt` is given; see `lane_scan_plain`.
    On the card the model's step is a functor compiled into the kernel, named
    by the class attribute `cuda_model` of Mt and Gt; Gt's `cuda_operands()`
    hands over its constants and compact per-step rows. The functor scores
    ancestors with Mt's own transition, so there `Pt` must be Mt. With a
    leading chain axis on eps and the other operands (and on the
    components' params, which lead with (C, n), or (1, n) where every chain
    shares them), C chains' sweeps at once."""
    chained = eps.dim() == 3
    if not _on_cuda("lane_scan", eps):
        params = (Mt.params, Gt.params, None if Pt is None else Pt.params)
        fns = (Mt.lane_propagate, Gt.lane_logw, None if Pt is None else Pt.lane_logpdf)
        if chained:
            return _per_chain(lambda *a: lane_scan_plain(*fns, *a),
                              *_for_chains(params, eps.shape[0]), eps, res_u, anc_u, x_star,
                              x0, w0, chains=eps.shape[0])
        plain_args = params + (eps, res_u, anc_u, x_star, x0, w0)
        return lane_scan_plain(*fns, *plain_args)
    model = getattr(Gt, "cuda_model", None)
    if model not in LANE_MODELS or getattr(Mt, "cuda_model", None) != model:
        raise NotImplementedError(
            f"lane_scan: no CUDA functor for {type(Mt).__name__}/{type(Gt).__name__} "
            f"(csrc/csmc_models.cuh has {', '.join(LANE_MODELS)})")
    if Pt is not None and Pt is not Mt:
        raise NotImplementedError(
            "lane_scan: the CUDA functor scores ancestors with Mt's own transition; "
            f"got another Pt ({type(Pt).__name__})")
    *lead, n, N = res_u.shape
    C = lead[0] if chained else 1
    _check_n("lane_scan", N, MAX_N)
    consts, params = Gt.cuda_operands()
    if chained:
        params = _for_chains(params, C)
    n_consts, n_params = LANE_MODELS[model]
    for t, shape in ((eps, (*lead, n, N)), (anc_u, (*lead, n)), (x_star, (*lead, n)),
                     (x0, (*lead, N)), (w0, (*lead, N)), (consts, (n_consts,)),
                     (params, (*lead, n, n_params))):
        _check_shape("lane_scan", t, shape)
    args = check_cuda_inputs("lane_scan", (eps, res_u, anc_u, x_star, x0, w0, consts, params),
                             eps.dtype, 1, ())
    xs = eps.new_empty(*lead, n, N)
    log_ws = eps.new_empty(*lead, n, N)
    ancestors = torch.empty(*lead, n, N, dtype=torch.int64, device=eps.device)
    if n:
        launch(f"csmc_lane_{model}", eps.dtype, C, n, N, int(Pt is not None), *args, xs,
               log_ws, ancestors)
        lane_scan.launches += 1
    return xs, log_ws, ancestors


lane_scan.launches = 0


# --------------------------------------------------------------------------
# Block-lane forward sweep (block_lane_forward_scan)
# --------------------------------------------------------------------------

# cuda_model -> the sizes the wrapper checks before a launch: the constants'
# (d x d matrices, d-vectors, d x W row lists, scalars), W being Gt's
# `ell_width` (the widest row of a sparse matrix the functor reads as row
# lists), then a per-step row's (d-vectors, scalars), which the C++ states
# nowhere but in the functor's own indexing. The kernel sizes its shared
# memory by the constants' count.
BLOCK_LANE_MODELS = {"sv_guided": (3, 2, 0, 1, 6, 2), "spatial_guided": (0, 0, 2, 4, 2, 7)}


def block_lane_scan_plain(propagate, logw, mt_params, gt_params, eps, res_u, x_star, x0, w0):
    """State-dependent cSMC forward sweep on (d, N) particle blocks.
    `propagate(eps, x_prev, mt_p) -> (d, N)` and `logw(x_next, x_prev, gt_p)
    -> (N,)` are the model's block callables; `mt_p`, `gt_p` one time step
    of the params. Conditional multinomial resampling, lane 0 pinned to 0
    and its particle to x_star; no PGAS.
    Returns (xs (n, d, N), log_ws (n, N), ancestors (n, N) int64)."""
    n, d, N = eps.shape
    xs = eps.new_empty(n, d, N)
    log_ws = eps.new_empty(n, N)
    ancestors = torch.empty(n, N, dtype=torch.int64, device=eps.device)
    x_prev, w = x0, w0
    for t in range(n):
        anc = _resample(torch.cumsum(w, 0), res_u[t], N)
        anc[0] = 0
        x_res = x_prev[:, anc]
        x_t = propagate(eps[t], x_res, _at(mt_params, t))
        x_t[:, 0] = x_star[t]
        log_w = logw(x_t, x_res, _at(gt_params, t))
        xs[t], log_ws[t], ancestors[t] = x_t, log_w, anc
        x_prev, w = x_t, _carry(log_w)
    return xs, log_ws, ancestors


def block_lane_scan(Mt, Gt, eps, res_u, x_star, x0, w0):
    """The block-lane sweep of the model (Mt, Gt); see `block_lane_scan_plain`.
    On the card the model's step is a functor compiled into the kernel,
    named by the class attribute `cuda_model` of Mt and Gt; Gt's
    `cuda_operands()` hands over its constants and per-step parameters.
    With a leading chain axis on eps (C, n, d, N) and the other operands
    (and on the components' params, which lead with (C, n); the constants
    shared), C chains' sweeps at once: one launch, a block a chain. Each
    chain's operands must be its own: a per-chain operand broadcast over the
    chains (stride 0) raises, rather than being copied C times. Any d runs
    whose buffers fit in a block's shared memory; past that the launch
    raises."""
    chained = eps.dim() == 4
    if not _on_cuda("block_lane_scan", eps):
        plain_args = (Mt.params, Gt.params, eps, res_u, x_star, x0, w0)
        fns = (Mt.block_propagate, Gt.block_logw)
        if chained:
            return _per_chain(lambda *a: block_lane_scan_plain(*fns, *a), *plain_args,
                              chains=eps.shape[0])
        return block_lane_scan_plain(*fns, *plain_args)
    model = getattr(Gt, "cuda_model", None)
    if model not in BLOCK_LANE_MODELS or getattr(Mt, "cuda_model", None) != model:
        raise NotImplementedError(
            f"block_lane_scan: no CUDA functor for {type(Mt).__name__}/{type(Gt).__name__} "
            f"(csrc/csmc_models.cuh has {', '.join(BLOCK_LANE_MODELS)})")
    *lead, n, d, N = eps.shape
    C = lead[0] if chained else 1
    _check_n("block_lane_scan", N, MAX_BLOCK_N)
    consts, params = Gt.cuda_operands()
    mats, vecs, lists, scalars, row_vecs, row_scalars = BLOCK_LANE_MODELS[model]
    width = getattr(Gt, "ell_width", 0)
    per_chain = ((eps, (n, d, N)), (res_u, (n, N)), (x_star, (n, d)), (x0, (d, N)), (w0, (N,)),
                 (params, (n, row_vecs * d + row_scalars)))
    for t, shape in per_chain + ((consts, (mats * d * d + vecs * d + lists * d * width
                                           + scalars,)),):
        _check_shape("block_lane_scan", t, (*lead, *shape) if t is not consts else shape)
    if C > 1:
        for i, (t, _) in enumerate(per_chain):
            if t.stride(0) == 0:
                raise ValueError(f"block_lane_scan: operand {i} ({tuple(t.shape)}) is one "
                                 "tensor broadcast over the chains; each chain's must be its "
                                 "own")
    args = check_cuda_inputs("block_lane_scan", (eps, res_u, x_star, x0, w0, consts, params),
                             eps.dtype, 1, ())
    xs = eps.new_empty(*lead, n, d, N)
    log_ws = eps.new_empty(*lead, n, N)
    ancestors = torch.empty(*lead, n, N, dtype=torch.int64, device=eps.device)
    if n:
        launch(f"csmc_block_lane_{model}", eps.dtype, n, C, N, d, consts.numel(), *args, xs,
               log_ws, ancestors)
        block_lane_scan.launches += 1
    return xs, log_ws, ancestors


def block_lane_occupancy(model, N, d, nconst, dtype, device):
    """(blocks a chain's sweep of N particles of width d with `nconst`
    constants puts on one SM at once, whether that sweep is staged in shared
    memory), by the CUDA occupancy calculator on `device`: how many chains
    an SM runs side by side."""
    out = torch.zeros(2, dtype=torch.int32, device=device)
    launch(f"csmc_block_lane_occupancy_{model}", dtype, N, d, nconst, out)
    blocks, staged = out.tolist()
    return blocks, bool(staged)


block_lane_scan.launches = 0
