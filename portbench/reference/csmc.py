"""Plain reference of one guided auxiliary particle-Gibbs step (conditional
SMC with multinomial resampling and Whiteley backward sampling) over C
chains, for a model that gives the guided proposal (`guided`, `propose`,
`log_weight`) and the true transition density (`trans_logpdf`):
`reference/sv.py`, `reference/spatial.py`.

The step at the reference trajectory x (C, T, d) with per-step delta (C, T)
and noise (eps_aux (C, T, d), eps_m0 (C, N, d), res_u (C, T-1, N), eps_prop
(C, T-1, N, d), anc_u (C, T-1), us (C, T)):
  u = x + sqrt(delta / 2) eps_aux, the guided proposal's parameters at u;
  particles at t = 0 from eps_m0, particle 0 pinned to x_0; at each later
  step ancestors by the inverse CDF of the normalised weights at res_u
  (#{i : cdf_i < u}; ancestor 0 pinned to 0), particles proposed from the
  ancestors with eps_prop, particle 0 pinned to x_t, and their weights;
  the last index by the inverse CDF of the last weights at us[T-1] times
  their total, then each earlier one by that of w_t(i) p(x_{t+1} | x_t(i))
  at us[t].

`sweep` runs that step free, in the dtype it is given. `judge` holds a
step's outputs (the program's, or `sweep`'s in a lower precision) to the
step's law, stage by stage from the outputs' own carry: each stage's inputs
are the outputs of the stage before it, as produced, so an index that
rounding flipped is judged by how far its uniform lies from the reference's
interval, not by where a free-running reference would have gone after it.
"""
import torch


def guided_params(model, x, delta, eps_aux):
    scale = torch.sqrt(0.5 * delta).expand(x.shape[:-1])
    return model.guided(x + scale[..., None] * eps_aux, scale)


def normalise(log_w):
    return log_w - torch.logsumexp(log_w, -1, keepdim=True)


def _carry(log_w):
    w = torch.exp(log_w - log_w.max(-1, keepdim=True).values)
    return w / w.sum(-1, keepdim=True)


def _take(particles, index):
    """particles (..., N, d) at index (..., M) -> (..., M, d)."""
    return torch.gather(particles, -2, index[..., None].expand(*index.shape,
                                                               particles.shape[-1]))


def sweep(model, x, delta, noise):
    """The step, free-running: {x0, lw0, xs, lw, anc, picked, x_new,
    updated} in the layout `judge` reads."""
    eps_aux, eps_m0, res_u, eps_prop, _, us = noise
    C, T, d = x.shape
    N = eps_m0.shape[1]
    p = guided_params(model, x, delta, eps_aux)
    ys = model.ys
    prev = model.propose(p, 0, None, eps_m0)
    prev[:, 0] = x[:, 0]
    lw_prev = model.log_weight(p, 0, prev, None, ys[0])
    x0, lw0 = prev, lw_prev
    xs, lws, ancs = [], [], []
    for t in range(T - 1):
        anc = torch.searchsorted(torch.cumsum(_carry(lw_prev), -1),
                                 res_u[:, t].contiguous()).clamp(max=N - 1)
        anc[:, 0] = 0
        x_res = _take(prev, anc)
        xt = model.propose(p, t + 1, x_res, eps_prop[:, t])
        xt[:, 0] = x[:, t + 1]
        lw_prev = model.log_weight(p, t + 1, xt, x_res, ys[t + 1])
        prev = xt
        xs.append(xt)
        lws.append(lw_prev)
        ancs.append(anc)
    X = torch.stack([x0] + xs, 1)
    L = torch.stack([lw0] + lws, 1)
    b = _inverse_cdf(L[:, -1], us[:, -1])
    picked = [b]
    for t in range(T - 2, -1, -1):
        x_next = _take(X[:, t + 1], b[:, None])
        b = _inverse_cdf(L[:, t] + model.trans_logpdf(x_next, X[:, t]), us[:, t])
        picked.append(b)
    picked = torch.stack(picked[::-1], 1)
    x_new = _take(X, picked[..., None])[..., 0, :]
    return {"x0": x0, "lw0": lw0, "xs": torch.stack(xs, 1), "lw": torch.stack(lws, 1),
            "anc": torch.stack(ancs, 1), "picked": picked,
            "x_new": x_new, "updated": picked != 0}


def _inverse_cdf(log_w, u):
    """#{i : cdf_i < u * total} of exp(log_w), one draw a row."""
    cw = torch.cumsum(torch.exp(log_w - log_w.max(-1, keepdim=True).values), -1)
    idx = torch.searchsorted(cw, (u[..., None] * cw[..., -1:]).contiguous())
    return idx.clamp(max=log_w.shape[-1] - 1)[..., 0]


def _gap(log_w, u, index):
    """How far each uniform u lies outside the interval (cdf_{a-1}, cdf_a]
    of the index a drawn at it, in probability: 0 where the draw is the
    inverse CDF's. log_w (..., N); u and index (..., M), M draws from each
    row."""
    cdf = torch.cumsum(torch.softmax(log_w, -1), -1)
    hi = torch.gather(cdf, -1, index)
    lo = torch.where(index > 0, torch.gather(cdf, -1, (index - 1).clamp(min=0)),
                     torch.zeros_like(hi))
    return torch.clamp(torch.maximum(lo - u, u - hi), min=0.0)


def judge(model, x, delta, noise, out, chains_a_block=16, floor=-30.0):
    """The step's numbers for outputs `out` (`sweep`'s layout), in the
    model's dtype, in blocks of chains:

    prop_err    largest |particle - the reference's proposal from the
                particle's own ancestor and noise| (t = 0 included);
    logw_err    largest gap between normalised log-weights and the
                reference's at the same particles and ancestors, over the
                particles whose reference log-weight is above `floor`;
    anc_gap     largest distance of a resampling uniform from its
                ancestor's interval of the CDF of the reference's weights
                at the recorded particles (ancestor 0 of particle 0 is
                required: else 1);
    back_gap    the same for the backward draws, the reference's weights
                times its transition density to the picked particle;
    output_err  largest |x_new - the particles at the picked indices|, plus
                the count of update flags that disagree with the indices.
    """
    dt = model.ys.dtype
    res = {"prop_err": 0.0, "logw_err": 0.0, "anc_gap": 0.0, "back_gap": 0.0,
           "output_err": 0.0}
    C, T, _ = x.shape
    if out["xs"].shape[0] != C:
        res["output_err"] = float("inf")
        return res
    for c0 in range(0, C, chains_a_block):
        sl = slice(c0, min(C, c0 + chains_a_block))
        part = _judge_block(model, x[sl].to(dt), delta[sl].to(dt),
                            [z[sl].to(dt) if z.is_floating_point() else z[sl] for z in noise],
                            {k: v[sl].to(dt) if v.is_floating_point() else v[sl]
                             for k, v in out.items()}, floor)
        for k in res:
            res[k] = max(res[k], part[k])
    return res


def _judge_block(model, x, delta, noise, out, floor):
    eps_aux, eps_m0, res_u, eps_prop, _, us = noise
    T = x.shape[1]
    ys = model.ys
    p = guided_params(model, x, delta, eps_aux)
    x0, lw0, xs, lw, anc = out["x0"], out["lw0"], out["xs"], out["lw"], out["anc"]

    x0_ref = model.propose(p, 0, None, eps_m0)
    x0_ref[:, 0] = x[:, 0]
    prop_err = (x0 - x0_ref).abs().max()

    prev = torch.cat([x0[:, None], xs[:, :-1]], 1)
    pinned = (anc[..., 0] != 0).any()
    x_res = _take(prev, anc)
    x_ref = model.propose(p, slice(1, T), x_res, eps_prop)
    x_ref[:, :, 0] = x[:, 1:]
    prop_err = torch.maximum(prop_err, (xs - x_ref).abs().max())

    lw_ref = normalise(model.log_weight(p, slice(1, T), xs, x_res, ys[1:, None, :]))
    lw0_ref = normalise(model.log_weight(p, 0, x0, None, ys[0]))
    logw_err = x.new_zeros(())
    for got, want in ((lw0, lw0_ref), (lw, lw_ref)):
        logw_err = torch.maximum(logw_err, torch.where(want > floor, (normalise(got) - want).abs(),
                                                       0.0).max())

    # The draws against the reference's weights at the recorded particles.
    L_ref = torch.cat([lw0_ref[:, None], lw_ref], 1)
    anc_gap = _gap(L_ref[:, :-1], res_u, anc)[..., 1:].max()
    X = torch.cat([x0[:, None], xs], 1)
    picked = out["picked"]
    gaps = _gap(L_ref[:, -1], us[:, -1:], picked[:, -1:])
    x_next = _take(X[:, 1:], picked[:, 1:, None])      # (C, T-1, 1, d)
    score = L_ref[:, :-1] + model.trans_logpdf(x_next, X[:, :-1])
    back_gap = torch.maximum(gaps.max(), _gap(score, us[:, :-1, None],
                                              picked[:, :-1, None]).max())

    x_pick = _take(X, picked[..., None])[..., 0, :]
    output_err = (out["x_new"] - x_pick).abs().max() \
        + (out["updated"] != (picked != 0)).sum()
    return {"prop_err": float(prop_err), "logw_err": float(logw_err),
            "anc_gap": 1.0 if bool(pinned) else float(anc_gap), "back_gap": float(back_gap),
            "output_err": float(output_err)}
