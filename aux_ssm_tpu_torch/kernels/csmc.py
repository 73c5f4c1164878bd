"""Sequential conditional SMC (particle Gibbs) kernel (counterpart of
`aux_ssm_tpu/kernels/csmc.py`).

One step at reference trajectory x*: a forward sweep of N particles with
particle 0 pinned to x*, then a draw of one trajectory, by ancestor scanning
or by Whiteley backward sampling.

Every random number of a step is drawn up front, in the JAX package's order,
and can be given instead as `noise = (eps_m0 (N, d), res_u (T-1, N) [or
(T-1, 3) for systematic resampling], eps_prop (T-1, N, d), anc_u (T-1,),
us (T,))`. `us` are the backward-sampling uniforms; ancestor scanning draws
its final index as `jax.random.choice` does, by inverse CDF at
(1 - us[-1]) * total.

Chain axis: a reference trajectory x (C, T, d) runs C independent chains in
one step; every noise array and the state (`updated` (C, T)) then carry the
leading C, and the components' per-step params lead with (C, T-1), or (1,
T-1) where every chain shares them. Every path takes it: the factor, lane
and block-lane sweeps on the card (one launch set for all C chains,
`ops/cuda/csmc_fwd.py`), and the generic step loops, ancestor scanning and
both resampling schemes in plain torch over the leading axis (each loop
step one batch of ops for all C chains). So any options run C chains as one
batched step, and chain c's values are those of a one-chain step given its
noise.

Dispatch by model capability, as in the JAX package (there by platform and
environment flags; here the same path runs everywhere, a CPU tensor through
the kernels' plain versions and a CUDA tensor through the kernels):
  - forward: the factor sweep (`ops/cuda/csmc_fwd.forward_factor_scan`) for
    independent proposals with pair-factorising weights; the lane sweep
    (`lane_scan`) for scalar-state models with (N,)-row lane callables,
    PGAS included; the block-lane sweep (`block_lane_scan`) for d > 1 models
    with (d, N)-block callables; otherwise the generic step loop;
  - backward sampling: the factor sweep (`backward_factor_scan`) when the
    true dynamics have `logpdf_factors`; otherwise the generic loop.
"""
import torch

from .csmc_base import CSMCState, tree_map
from ..ops import resampling as resampling_mod
from ..ops.cuda import csmc_fwd
from ..ops.logspace import normalize
from ..ops.take import take_rows

_FUSED_MAX_N = 1024   # past it the TPU factor kernels need N % 128 == 0


def get_kernel(M0, G0, Mt, Gt, N, backward=False, Pt=None, resampling="multinomial",
               ancestor_sampling=False):
    """Build a cSMC kernel.

    M0, G0, Mt, Gt: Feynman–Kac components (`csmc_base`); N particles;
    `backward`: Whiteley backward sampling (needs `Pt.logpdf`) instead of
    ancestor scanning; `Pt`: true dynamics (default Mt); `resampling`:
    'multinomial' or 'systematic' (or those functions of
    `ops/resampling.py`); `ancestor_sampling`: PGAS.

    Returns (init, kernel) with `kernel(state, generator=None, noise=None)
    -> CSMCState`.
    """
    if (backward or ancestor_sampling) and Pt is None:
        Pt = Mt
    if (backward or ancestor_sampling) and not hasattr(Pt, "logpdf"):
        raise ValueError("backward/ancestor sampling requires `Pt` to implement logpdf.")
    resample = resampling_mod.get(resampling) if isinstance(resampling, str) else resampling
    if resample not in (resampling_mod.multinomial, resampling_mod.systematic):
        raise ValueError("resampling must be 'multinomial' or 'systematic'")

    def kernel(state, generator=None, noise=None):
        x = state.x
        if noise is None:
            noise = draw_noise(x, N, resample, generator)
        eps_m0, res_u, eps_prop, anc_u, us = noise
        w_T, xs, log_ws, ancestors = forward_pass(
            x, M0, G0, Mt, Gt, N, resample, (eps_m0, res_u, eps_prop, anc_u),
            ancestor_Pt=Pt if ancestor_sampling else None)
        if backward:
            if _use_fused_backward(Pt, N):
                x_new, picked = _fused_backward_pass(Pt, w_T, xs, log_ws, us)
            else:
                x_new, picked = backward_sampling_pass(Pt, w_T, xs, log_ws, us)
        else:
            x_new, picked = backward_scanning_pass(w_T, xs, ancestors, us[..., -1])
        return CSMCState(x=x_new, updated=picked != 0)

    def init(x_star):
        return CSMCState(x=x_star, updated=torch.zeros(x_star.shape[:-1], dtype=torch.bool,
                                                       device=x_star.device))

    return init, kernel


def draw_noise(x, N, resample, generator=None):
    """Every random number of one cSMC step, from `generator`, in the order
    and shapes of `noise`, each with x's chain axis (if any) in front."""
    *lead, T, d = x.shape
    kw = dict(generator=generator, dtype=x.dtype, device=x.device)
    n_res = N if resample is resampling_mod.multinomial else 3
    return (torch.randn(*lead, N, d, **kw), torch.rand(*lead, T - 1, n_res, **kw),
            torch.randn(*lead, T - 1, N, d, **kw), torch.rand(*lead, T - 1, **kw),
            torch.rand(*lead, T, **kw))


def _at(tree, t, chained=False):
    """Step t of per-step params: axis 0, or axis 1 behind a chain axis."""
    return tree_map((lambda z: z[:, t]) if chained else (lambda z: z[t]), tree)


def _particle(xs, b):
    """xs (..., N, d) at index b (...) -> (..., d)."""
    return take_rows(xs, b[..., None])[..., 0, :]


def _row(x, chained):
    """One value a chain (C, d) as a particle row (C, 1, d) that broadcasts
    against particles (C, N, d); one chain's (d,) as it is."""
    return x[:, None] if chained else x


def _pin(x, value):
    """Particles x (..., N, d) with particle 0 set to value (..., d) (x a
    fresh tensor, changed in place)."""
    x[..., 0, :] = value
    return x


def _use_fused_forward(Mt, Gt, resample, ancestor_Pt, N):
    """Independent proposals (particle values invariant to resampling) and a
    pair-factorising weight; PGAS also needs the ancestor transition to be
    the weight's own (its scores then come from the same factors)."""
    if not (getattr(Mt, "independent", False)
            and getattr(Gt, "supports_pairwise_factors", False)
            and resample is resampling_mod.multinomial):
        return False
    if ancestor_Pt is not None and ancestor_Pt is not getattr(Gt, "trans", None):
        return False
    return _factor_sweep_takes(N)


def _use_lane_forward(x_star, Mt, Gt, resample, ancestor_Pt, N):
    """(N,)-row lane callables of a scalar-state model; PGAS needs
    `lane_logpdf` on the ancestor dynamics."""
    if x_star.shape[-1] != 1 or not _factor_sweep_takes(N):
        return False
    if not (hasattr(Mt, "lane_propagate") and hasattr(Gt, "lane_logw")
            and hasattr(Mt, "sample_from_noise") and resample is resampling_mod.multinomial):
        return False
    return ancestor_Pt is None or hasattr(ancestor_Pt, "lane_logpdf")


def _use_block_lane_forward(x_star, Mt, Gt, resample, ancestor_Pt, N):
    """(d, N)-block callables of a d > 1 model, dense N <= 1024, no PGAS."""
    if x_star.shape[-1] <= 1 or N > csmc_fwd.MAX_BLOCK_N or ancestor_Pt is not None:
        return False
    return (hasattr(Mt, "block_propagate") and hasattr(Gt, "block_logw")
            and resample is resampling_mod.multinomial)


def _use_fused_backward(Pt, N):
    """Pair-factorisable true dynamics."""
    return hasattr(Pt, "logpdf_factors") and _factor_sweep_takes(N)


def _factor_sweep_takes(N):
    """The particle counts the TPU factor kernels served: N <= 8192, and a
    multiple of 128 past 1024 (the same dispatch on every device)."""
    return N <= csmc_fwd.MAX_N and not (N > _FUSED_MAX_N and N % 128)


def _initial(x_star, M0, G0, eps_m0):
    x0 = _pin(M0.sample_from_noise(eps_m0), x_star[..., 0, :])
    log_w0 = G0(x0)
    return x0, log_w0, normalize(log_w0, -1)


def _fused_forward_pass(x_star, M0, G0, Mt, Gt, N, ancestor_Pt, noise):
    """Independent proposals: the whole proposal stack and the pair factors
    of every step are precomputed, and one factor sweep runs the index and
    weight recursion."""
    eps_m0, res_u, eps_prop, anc_u = noise
    x0, log_w0, w0 = _initial(x_star, M0, G0, eps_m0)
    xs_rest = Mt.sample_from_noise(eps_prop, eps_prop, Mt.params)
    xs_rest[..., 0, :] = x_star[..., 1:, :]
    xs = torch.cat([x0.unsqueeze(-3), xs_rest], -3)
    rf, cf, rb, cb = (z.contiguous() for z in Gt.pairwise_factors(
        xs[..., :-1, :, :], xs[..., 1:, :, :], Gt.params))
    log_ws_rest, ancestors = csmc_fwd.forward_factor_scan(
        rf, cf, rb, cb, res_u, anc_u, w0, pgas=ancestor_Pt is not None)
    log_ws = torch.cat([log_w0.unsqueeze(-2), log_ws_rest], -2)
    return normalize(log_ws_rest[..., -1, :], -1), xs, log_ws, ancestors


def _lane_forward_pass(x_star, M0, G0, Mt, Gt, N, ancestor_Pt, noise):
    """State-dependent proposals of a scalar-state model through the lane
    sweep; the noise is the generic draw with its unit state axis dropped."""
    eps_m0, res_u, eps_prop, anc_u = noise
    x0, log_w0, w0 = _initial(x_star, M0, G0, eps_m0)
    xs_r, log_ws_r, ancestors = csmc_fwd.lane_scan(
        Mt, Gt, ancestor_Pt, eps_prop[..., 0].contiguous(), res_u.contiguous(),
        anc_u.contiguous(), x_star[..., 1:, 0].contiguous(), x0[..., 0].contiguous(), w0)
    xs = torch.cat([x0.unsqueeze(-3), xs_r[..., None]], -3)
    log_ws = torch.cat([log_w0.unsqueeze(-2), log_ws_r], -2)
    return normalize(log_ws_r[..., -1, :], -1), xs, log_ws, ancestors


def _block_lane_forward_pass(x_star, M0, G0, Mt, Gt, N, noise):
    """State-dependent proposals through the block-lane sweep; the noise is
    the generic (T-1, N, d) draw transposed, so the values used are the
    same."""
    eps_m0, res_u, eps_prop, _ = noise
    x0, log_w0, w0 = _initial(x_star, M0, G0, eps_m0)
    xs_r, log_ws_r, ancestors = csmc_fwd.block_lane_scan(
        Mt, Gt, eps_prop.transpose(-2, -1).contiguous(), res_u.contiguous(),
        x_star[..., 1:, :].contiguous(), x0.transpose(-2, -1).contiguous(), w0.contiguous())
    xs = torch.cat([x0.unsqueeze(-3), xs_r.transpose(-2, -1)], -3)
    log_ws = torch.cat([log_w0.unsqueeze(-2), log_ws_r], -2)
    return normalize(log_ws_r[..., -1, :], -1), xs, log_ws, ancestors


def forward_pass(x_star, M0, G0, Mt, Gt, N, resample, noise, ancestor_Pt=None):
    """Conditional SMC forward sweep; particle 0 is pinned to `x_star`.
    `noise = (eps_m0, res_u, eps_prop, anc_u)`; `ancestor_Pt` turns on PGAS.
    Returns (w_T (N,), xs (T, N, d), log_ws (T, N), ancestors (T-1, N)), each
    with x_star's chain axis (if any) in front."""
    if x_star.shape[-2] >= 2:  # T == 1: nothing to sweep; the loop degrades correctly
        if _use_fused_forward(Mt, Gt, resample, ancestor_Pt, N):
            return _fused_forward_pass(x_star, M0, G0, Mt, Gt, N, ancestor_Pt, noise)
        if _use_lane_forward(x_star, Mt, Gt, resample, ancestor_Pt, N):
            return _lane_forward_pass(x_star, M0, G0, Mt, Gt, N, ancestor_Pt, noise)
        if _use_block_lane_forward(x_star, Mt, Gt, resample, ancestor_Pt, N):
            return _block_lane_forward_pass(x_star, M0, G0, Mt, Gt, N, noise)

    eps_m0, res_u, eps_prop, anc_u = noise
    *lead, T, _ = x_star.shape
    chained = bool(lead)
    x_prev, log_w0, w = _initial(x_star, M0, G0, eps_m0)
    step_resample = (resampling_mod.multinomial_from_uniforms
                     if resample is resampling_mod.multinomial
                     else resampling_mod.systematic_from_uniforms)
    as_params = ancestor_Pt.params if ancestor_Pt is not None else None
    xs, log_ws, ancestors = [x_prev], [log_w0], []
    for t in range(T - 1):
        anc = step_resample(res_u[..., t, :], w)
        if ancestor_Pt is not None:
            log_as = torch.log(w) + ancestor_Pt.logpdf(_row(x_star[..., t + 1, :], chained),
                                                       x_prev, _at(as_params, t, chained))
            anc[..., 0] = resampling_mod.categorical_from_uniform(anc_u[..., t],
                                                                  normalize(log_as, -1))
        x_prev = take_rows(x_prev, anc)
        x_t = _pin(Mt.sample_from_noise(eps_prop[..., t, :, :], x_prev,
                                        _at(Mt.params, t, chained)), x_star[..., t + 1, :])
        log_w = Gt(x_t, x_prev, _at(Gt.params, t, chained))
        w = normalize(log_w, -1)
        xs.append(x_t)
        log_ws.append(log_w)
        ancestors.append(anc)
        x_prev = x_t
    anc_out = (torch.stack(ancestors, -2) if ancestors
               else torch.empty(*lead, 0, N, dtype=torch.int64, device=x_star.device))
    return w, torch.stack(xs, -3), torch.stack(log_ws, -2), anc_out


def _take_trajectory(xs, picked):
    """xs (..., T, N, d) at each step's picked index (..., T) -> (..., T, d)."""
    index = picked[..., None, None].expand(*picked.shape, 1, xs.shape[-1])
    return torch.gather(xs, -2, index)[..., 0, :]


def backward_scanning_pass(w_T, xs, ancestors, u):
    """Trace one genealogy back from a draw at the last step. The final
    index is `jax.random.choice(key, N, p=w_T)` from its uniform u: the
    inverse CDF at (1 - u) * total. The pointer chase B_t = A_t[B_{t+1}] is a
    suffix composition of index maps, resolved in log2(T) rounds of gathers
    (Hillis–Steele), each a batched gather over any leading chain axis."""
    b_T = resampling_mod.choice_from_uniform(u, w_T)
    n = ancestors.shape[-2]
    suffix = ancestors.clone()
    off = 1
    while off < n:  # suffix[t] = A_t o A_{t+1} o ... o A_{n-1}
        suffix[..., :n - off, :] = torch.gather(suffix[..., :n - off, :], -1,
                                                suffix[..., off:, :])
        off *= 2
    at_b = torch.gather(suffix, -1, b_T[..., None, :].expand(*suffix.shape[:-1], 1))[..., 0]
    picked = torch.cat([at_b, b_T], -1)
    return _take_trajectory(xs, picked), picked


def backward_sampling_pass(Pt, w_T, xs, log_ws, us):
    """Whiteley backward sampling, one categorical draw per step from the
    smoothing weights log_w_t + log p(x_{t+1} | x_t) at uniform us[t]; over
    a leading chain axis, one draw a chain a step."""
    T = xs.shape[-3]
    chained = xs.dim() > 3
    b = resampling_mod.categorical_from_uniform(us[..., -1], w_T)
    picked = [b]
    x_next = _particle(xs[..., -1, :, :], b)
    for t in range(T - 2, -1, -1):
        log_w = (Pt.logpdf(_row(x_next, chained), xs[..., t, :, :], _at(Pt.params, t, chained))
                 + log_ws[..., t, :])
        b = resampling_mod.categorical_from_uniform(us[..., t], normalize(log_w, -1))
        picked.append(b)
        x_next = _particle(xs[..., t, :, :], b)
    picked = torch.stack(picked[::-1], -1)
    return _take_trajectory(xs, picked), picked


def _fused_backward_pass(Pt, w_T, xs, log_ws, us):
    """Whiteley backward sampling through the pair factors of the true
    dynamics, all steps in one backward factor sweep."""
    b_T = resampling_mod.categorical_from_uniform(us[..., -1], w_T)
    rf, cf, rb, _ = (z.contiguous() for z in Pt.logpdf_factors(
        xs[..., :-1, :, :], xs[..., 1:, :, :], Pt.params))
    picked_rest = csmc_fwd.backward_factor_scan(rf, cf, rb, log_ws[..., :-1, :].contiguous(),
                                                us[..., :-1].contiguous(), b_T)
    picked = torch.cat([picked_rest, b_T[..., None]], -1)
    return _take_trajectory(xs, picked), picked
