"""Factorised N^2 stitching of the parallel-in-time cSMC, in plain PyTorch
(counterpart of `aux_ssm_tpu/ops/pallas/stitching.py`: the laws of its XLA
twins).

A tree node joins a left block, whose last-step particles x_i give the rows,
to a right block, whose first-step particles x_j give the columns. When the
boundary potential factorises as

    G(x_j, x_i) = row_bias[i] + col_bias[j] + row_feat[i] . col_feat[j]

(every Gaussian transition does), N pairs are drawn from the N^2 softmax
without materialising it:

  row_lse       lse_i = logsumexp_j(rf_i . cf_j + cb_j); the row marginals are
                row_bias + lse;
  col_sample    one column per sampled row by Gumbel-argmax over the
                recomputed scores, the Gumbel noise from `counter_uniform`;
  block_masses  the per-row log-masses of each 128-column block (the blocked
                route at large N), then either
  joint_rowblock_draws  one flat inverse-CDF draw over (row, block) and
  within_block_cols     the column inside the drawn block by Gumbel-argmax
                (the default `joint` draws), or
  stitch_draws  rows by a hierarchical inverse CDF (128-row tiles, then the
                offset in the tile), the block by inverse CDF over the drawn
                row's block masses, the column as within_block_cols does (the
                `fused` draws).

`row_lse`, `col_sample`, `block_masses`, `within_block_cols` and
`stitch_draws` are the plain versions of the CUDA kernels
(`ops/cuda/stitching.py`, `csrc/stitching.cu`). They compute the scores in
the kernels' order: cb_j first, then the k products rf_i[kk] cf_j[kk], each
product rounded and then added; and every prefix sum of the draws in the
shift-add association of `_lane_cumsum`. The rest is glue that runs in
PyTorch on every device. Large score tensors are built in chunks of rows (or
pairs), so no step holds more than `_CHUNK` elements at once.

`counter_uniform` is a hash of integer counters, computed here in int64
with the uint32 wrap-around made explicit, bit for bit the JAX package's.
"""
import torch

from .take import categorical_from_uniforms, take_rows

_ROW_BLOCK = 128
_COL_BLOCK = 128
# Finite stand-in for -inf log-masses: exp(_NEG_FLOOR - m) is exactly 0 for
# any finite m.
_NEG_FLOOR = -1e30
_CHUNK = 1 << 25  # elements of one score chunk (256 MB of int64 hashes)

_M32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# The counter-based uniform
# --------------------------------------------------------------------------

def _u32(x, like=None):
    """Integers as their uint32 values (two's complement for negative int32),
    held in int64."""
    device = None if like is None else like.device
    return torch.as_tensor(x, device=device).to(torch.int64) & _M32


def _mul32(a, c):
    """(a * c) mod 2^32 for uint32 values `a` and a constant `c`, in int64
    without overflow: c is split into 16-bit halves."""
    return ((((a * (c >> 16)) & _M32) << 16) + a * (c & 0xFFFF)) & _M32


def _mix32(h):
    """murmur3 finalizer round (uint32 values in int64)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def counter_uniform(seed, pair, block, rows, cols):
    """Uniform in [2^-24, 1 - 2^-24], float32: a double murmur3 hash of the
    counters (seed, pair, block, row, col), which broadcast against each other.
    The top 23 bits of the hash on a lattice that float32 holds exactly, so
    the value is the same on every device."""
    ref = next((z for z in (cols, rows, block, pair, seed) if isinstance(z, torch.Tensor)), None)
    h = _mul32(_u32(seed, ref), 0x9E3779B1)
    h = h ^ _mul32(_u32(pair, ref), 0x85EBCA77)
    h = h ^ _mul32(_u32(block, ref), 0xC2B2AE3D)
    lo = (_mul32(_u32(rows, ref), 0x27D4EB2F) + _mul32(_u32(cols, ref), 0x165667B1)) & _M32
    h = _mix32(h ^ lo)
    h = _mix32((h + 0x9E3779B9) & _M32)
    return (h >> 9).to(torch.float32) * 2.0 ** -23 + 2.0 ** -24


def seed_blk(seed):
    """The counter seed of the blocked draw's block stage (a separate stream)."""
    return _mix32(_u32(seed) ^ 0x5BD1E995)


def _gumbel(u, dtype):
    """log(-log(u)) in float32 (u is float32, as in the JAX package), cast to
    the scores' dtype: score - this is the Gumbel-perturbed score."""
    return torch.log(-torch.log(u)).to(dtype)


# --------------------------------------------------------------------------
# Plain versions of the kernels
# --------------------------------------------------------------------------

def _row_chunks(P, n, N):
    """Slices of the row axis such that P x rows x N stays within _CHUNK."""
    step = max(1, _CHUNK // max(1, P * N))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def pair_scores(rf, cf, cb):
    """s[p, i, j] = cb[p, j] + sum_kk rf[p, i, kk] cf[p, j, kk], the products
    added in the order kk = 0..k-1 (the kernels' association)."""
    s = cb[:, None, :].expand(rf.shape[0], rf.shape[1], cb.shape[1])
    for kk in range(rf.shape[-1]):
        s = s + rf[:, :, kk, None] * cf[:, None, :, kk]
    return s


def row_lse(row_feat, col_feat, col_bias):
    """Row log-sum-exp of the factorised scores: row_feat (P, N, k), col_feat
    (P, N, k), col_bias (P, N) -> (P, N). No finite guard: a row whose scores
    are all -inf gives NaN, as the JAX package's `row_lse_xla`."""
    P, N, _ = row_feat.shape
    out = []
    for sl in _row_chunks(P, N, col_feat.shape[1]):
        s = pair_scores(row_feat[:, sl], col_feat, col_bias)
        m = s.amax(-1, keepdim=True)
        out.append((m + torch.log(torch.exp(s - m).sum(-1, keepdim=True)))[..., 0])
    return torch.cat(out, 1)


def pair_counters(seed, P, pair_offset=0, chains=None, device=None):
    """The counter seed and pair index of each of a level's P pairs, (P,)
    each: one seed for every pair and the pairs counted from `pair_offset`;
    or with `chains` C, the pairs are C chains' P / C each, chain after
    chain, seed (C,) one a chain, and each pair is counted within its own
    chain (from `pair_offset`). So chain c draws what a one-chain call with
    seed[c] draws, and C = 1 is the one-chain call."""
    pair = torch.arange(P, device=device)
    seeds = torch.as_tensor(seed, device=device).reshape(-1).to(torch.int64)
    if chains is None:
        return seeds.expand(P), pair + pair_offset
    per = P // chains
    return seeds.reshape(chains).repeat_interleave(per), pair % per + pair_offset


def col_sample(seed, row_feat_sel, col_feat, col_bias, pair_offset=0, chains=None):
    """One column per sampled row from softmax_j(rf_i . cf_j + cb_j), by
    Gumbel-argmax with the uniforms counter_uniform(seed, pair + pair_offset,
    i // 128, i % 128, j); the first index wins a tie. seed an int32 scalar
    (or 0-d tensor); row_feat_sel (P, n, k); col_feat (P, N, k); col_bias (P, N)
    -> (P, n) int64. With `chains` C, the pairs are C chains' P / C each,
    chain after chain, seed (C,) one a chain, and `pair` counts within the
    chain (`pair_counters`)."""
    P, n, _ = row_feat_sel.shape
    N = col_feat.shape[1]
    dev = row_feat_sel.device
    seed, pair = (z[:, None, None] for z in pair_counters(seed, P, pair_offset, chains, dev))
    cols = torch.arange(N, device=dev)
    out = []
    for sl in _row_chunks(P, n, N):
        i = torch.arange(sl.start, sl.stop, device=dev)[None, :, None]
        u = counter_uniform(seed, pair, i // _ROW_BLOCK, i % _ROW_BLOCK, cols)
        g = pair_scores(row_feat_sel[:, sl], col_feat, col_bias) - _gumbel(u, col_bias.dtype)
        out.append(g.argmax(-1))
    return torch.cat(out, 1)


def block_masses(row_feat, col_feat, col_bias, per_block_max=False):
    """Lb[p, i, b] = log sum_{j in 128-column block b} exp(s_pij): row_feat
    (P, Nr, k), col_feat (P, Nc, k), col_bias (P, Nc), Nc a multiple of 128
    -> (P, Nr, Nc / 128). Stabiliser: the row max (non-finite -> 0), or with
    `per_block_max` each block's own max (then a block's mass depends on its
    columns alone). A block whose exponentials all underflow is -inf."""
    P, Nr, _ = row_feat.shape
    Nc = col_feat.shape[1]
    if Nc % _COL_BLOCK:
        raise ValueError(f"block_masses: the column count {Nc} is not a multiple of 128")
    nb = Nc // _COL_BLOCK
    out = []
    for sl in _row_chunks(P, Nr, Nc):
        s = pair_scores(row_feat[:, sl], col_feat, col_bias)
        s = s.reshape(P, s.shape[1], nb, _COL_BLOCK)
        m = s.amax(-1, keepdim=True) if per_block_max else s.amax((-2, -1), keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        out.append(torch.log(torch.exp(s - m).sum(-1)) + m[..., 0])
    return torch.cat(out, 1)


# --------------------------------------------------------------------------
# The draws of the blocked route (plain PyTorch on every device)
# --------------------------------------------------------------------------

def blocked_col_sample(seed, rows, Lb, row_feat_sel, col_feat, col_bias, pair_offset=0):
    """Column draws from the exact conditional categorical through the block
    masses: the block by inverse CDF over Lb[rows] with the uniform
    counter_uniform(seed_blk(seed), pair, nb, draw, 0), then the column inside
    it (`within_block_cols`). rows (P, n); Lb (P, N, nb) -> (P, n) int64."""
    P, n, _ = row_feat_sel.shape
    nb = col_feat.shape[1] // _COL_BLOCK
    dev = rows.device
    Lb = torch.clamp(Lb, min=_NEG_FLOOR)
    u_blk = counter_uniform(seed_blk(seed), (torch.arange(P, device=dev) + pair_offset)[:, None],
                            nb, torch.arange(n, device=dev)[None, :], 0)
    Lb_sel = take_rows(Lb, rows)
    w = torch.exp(Lb_sel - Lb_sel.amax(-1, keepdim=True))
    cdf = torch.cumsum(w, -1)
    target = (u_blk.to(cdf.dtype) * cdf[..., -1])[..., None]
    blocks = (cdf < target).sum(-1).clamp_(0, nb - 1)
    return within_block_cols(seed, blocks, row_feat_sel, col_feat, col_bias, pair_offset)


def within_block_cols(seed, blocks, row_feat_sel, col_feat, col_bias, pair_offset=0,
                      col_extra=None, chains=None):
    """The column inside each draw's 128-column block, by Gumbel-argmax over
    the recomputed block scores with counter_uniform(seed, pair, draw, block,
    j_loc); the first index wins a tie. blocks (P, n); row_feat_sel (P, n, k);
    col_feat (P, N, k); col_bias (P, N) (floored at _NEG_FLOOR) -> (P, n) int64
    columns, and with `col_extra` (P, N, e) also col_extra at those columns
    (P, n, e). With `chains` C, the pairs are C chains' P / C each, seed (C,)
    (`pair_counters`). Computed in chunks of pairs."""
    seeds, pairs = pair_counters(seed, blocks.shape[0], pair_offset, chains, blocks.device)
    cols = _within_block_cols(seeds, pairs, blocks, row_feat_sel, col_feat, col_bias)
    if col_extra is None:
        return cols
    return cols, take_rows(col_extra, cols)


def _within_block_cols(seeds, pairs, blocks, row_feat_sel, col_feat, col_bias):
    """`within_block_cols` given each pair's counter seed and index (P,)."""
    P, n, k = row_feat_sel.shape
    N = col_feat.shape[1]
    G = _COL_BLOCK
    dev = blocks.device
    col_bias = torch.clamp(col_bias, min=_NEG_FLOOR)
    draws = torch.arange(n, device=dev)[None, :, None]
    j_loc = torch.arange(G, device=dev)
    step = max(1, _CHUNK // max(1, n * G))
    out = []
    for p0 in range(0, P, step):
        ps = slice(p0, min(p0 + step, P))
        b = blocks[ps]
        p_ar = torch.arange(b.shape[0], device=dev)[:, None]
        cf_sel = col_feat[ps].reshape(b.shape[0], N // G, G, k)[p_ar, b]   # (p, n, G, k)
        s2 = col_bias[ps].reshape(b.shape[0], N // G, G)[p_ar, b]          # (p, n, G)
        rf = row_feat_sel[ps]
        for kk in range(k):  # the kernels' association
            s2 = s2 + rf[:, :, kk, None] * cf_sel[..., kk]
        u = counter_uniform(seeds[ps, None, None], pairs[ps, None, None], draws, b[..., None],
                            j_loc)
        out.append(b * G + (s2 - _gumbel(u, s2.dtype)).argmax(-1))
    return torch.cat(out, 0)


def joint_rowblock_draws(u, row_bias, Lb, row_feat=None, row_extra=None):
    """Joint (row, column-block) draws from P(i, b) ∝ exp(row_bias_i + Lb_ib):
    one flat inverse-CDF draw over the N * nb cells (floored at _NEG_FLOOR)
    per uniform. u (P, n); row_bias (P, N); Lb (P, N, nb) -> (rows, blocks),
    each (P, n) int64, then with `row_feat` (P, N, k) the drawn rows' features
    and with `row_extra` (P, N, e) their extra values."""
    P, N, nb = Lb.shape
    flat = torch.clamp((Lb + row_bias[:, :, None]).reshape(P, N * nb), min=_NEG_FLOOR)
    idx = categorical_from_uniforms(flat, u)
    rows = torch.div(idx, nb, rounding_mode="floor")
    blocks = idx - rows * nb
    if row_feat is None:
        return rows, blocks
    if row_extra is None:
        return rows, blocks, take_rows(row_feat, rows)
    return rows, blocks, take_rows(row_feat, rows), take_rows(row_extra, rows)


# --------------------------------------------------------------------------
# The fused draws (plain version of the stitch_draws kernel)
# --------------------------------------------------------------------------

def _lane_cumsum(x):
    """Inclusive prefix sum over the last axis in the Hillis-Steele shift-add
    association: at shift 1, 2, 4, ... every x[i] with i >= shift adds the
    x[i - shift] of the previous shift (the JAX package's `_lane_cumsum`, and
    the kernel's `shift_add_cumsum`)."""
    n, sh = x.shape[-1], 1
    while sh < n:
        x = torch.cat([x[..., :sh], x[..., sh:] + x[..., :-sh]], -1)
        sh *= 2
    return x


def _tile_rows(row_logits, u):
    """Stage 1: rows by a hierarchical inverse CDF over softmax(row_logits).
    w = exp(row_logits - max) in 128-row tiles; `ic` each tile's prefix sums,
    `ts` their last entries (the tile sums) and `cdf` the prefix sums of
    those. A draw's tile is the count of cdf entries below t1 = u * total,
    `prev` the sum, in tile order, of those tiles' ts (capped at t1), and the
    offset the count of the tile's ic entries below t1 - prev. row_logits
    (P, N), u (P, n) -> (P, n) int64."""
    P, N = row_logits.shape
    nb = N // _ROW_BLOCK
    w = torch.exp(row_logits - row_logits.amax(-1, keepdim=True))
    ic = _lane_cumsum(w.reshape(P, nb, _ROW_BLOCK))
    ts = ic[..., -1]
    cdf = _lane_cumsum(ts)
    t1 = u * cdf[:, -1:]
    below = cdf[:, None, :] < t1[:, :, None]                    # (P, n, nb)
    prev = torch.zeros_like(t1)
    for b in range(nb):  # the kernel's order
        prev = prev + torch.where(below[..., b], ts[:, b, None], torch.zeros_like(t1))
    prev = torch.minimum(prev, t1)
    tile = below.sum(-1).clamp_(max=nb - 1)
    ic_sel = ic[torch.arange(P, device=u.device)[:, None], tile]  # (P, n, 128)
    off = (ic_sel < (t1 - prev)[..., None]).sum(-1).clamp_(max=_ROW_BLOCK - 1)
    return tile * _ROW_BLOCK + off


def _row_blocks(seeds, pairs, rows, Lb):
    """Stage 2a: each draw's column block by inverse CDF over its row's block
    masses Lb[rows] (floored at _NEG_FLOOR), the shift-add prefix sum of
    exp(Lb - max), at u * total with u = counter_uniform(seed_blk(seed),
    pair, nb, draw, 0). seeds, pairs (P,): each pair's counters (see
    `pair_counters`); rows (P, n); Lb (P, N, nb) -> (P, n) int64."""
    n = rows.shape[1]
    nb = Lb.shape[-1]
    Lb_sel = take_rows(torch.clamp(Lb, min=_NEG_FLOOR), rows)
    cdf = _lane_cumsum(torch.exp(Lb_sel - Lb_sel.amax(-1, keepdim=True)))
    u = counter_uniform(seed_blk(seeds)[:, None], pairs[:, None], nb,
                        torch.arange(n, device=rows.device)[None, :], 0)
    target = (u.to(cdf.dtype) * cdf[..., -1])[..., None]
    return (cdf < target).sum(-1).clamp_(max=nb - 1)


def stitch_draws(seed, row_logits, u_rows, Lb, row_feat, col_feat, col_bias, pair_offset=0,
                 chains=None):
    """Every draw of one tree level in one pass: rows by `_tile_rows`, the
    column block by `_row_blocks`, the column inside it by
    `within_block_cols`. seed an int32 scalar (or 0-d tensor); row_logits
    (P, N) = row_bias + logsumexp(Lb, -1); u_rows (P, N); Lb (P, N, N / 128);
    row_feat, col_feat (P, N, k); col_bias (P, N) -> (rows, cols), each (P, N)
    int64. Pair 0 is not pinned (the caller's job). With `chains` C, the
    pairs are C chains' P / C each, seed (C,) (`pair_counters`). Computed in
    chunks of pairs."""
    P, N, k = row_feat.shape
    seeds, pairs = pair_counters(seed, P, pair_offset, chains, row_feat.device)
    step = max(1, _CHUNK // (N * _COL_BLOCK))
    rows, cols = [], []
    for p0 in range(0, P, step):
        ps = slice(p0, min(p0 + step, P))
        r = _tile_rows(row_logits[ps], u_rows[ps])
        b = _row_blocks(seeds[ps], pairs[ps], r, Lb[ps])
        rows.append(r)
        cols.append(_within_block_cols(seeds[ps], pairs[ps], b, take_rows(row_feat[ps], r),
                                       col_feat[ps], col_bias[ps]))
    return torch.cat(rows), torch.cat(cols)
