"""Parallel-in-time conditional SMC, divide-and-conquer particle Gibbs
(counterpart of `aux_ssm_tpu/kernels/pit.py`).

Structure:
- `dc_map`: a log2(T)-level binary-tree reduction; T is padded to the next
  power of two and the active pairs of each level are a static prefix.
- `stitching_operator` / `fused_stitching_operator`: join two partial
  smoothers by drawing N index pairs from the N^2 boundary-weight
  categorical (pair 0 pinned to (0, 0)), or one unconditional pair at the
  root; then gather and concatenate the trajectory blocks.
- `get_kernel`: the PIT-cSMC kernel over independent per-time proposals.
  Its engine (`_pit_csmc`) proposes every particle at once, runs the tree on
  the node-boundary particle values only (`run_stitch_tree`), records each
  level's drawn pairs and resolves the one output genealogy at the end
  (`resolve_genealogy`).

When the boundary potential factorises (`Gt.supports_pairwise_factors`),
each level's draw goes through the stitching kernels
(`ops/cuda/stitching.py`, one launch each a level): the two-pass route
(row_lse, the row draw, col_sample), or at 4096 <= N <= 8192 with N % 128 ==
0 the blocked route: block_masses, then the draws. The root always takes the
row_lse route. `stitch="auto"|"blocked"|"2pass"` forces a route (the JAX
package's `AUX_SSM_STITCH`). On the blocked route `draws` picks the draws
(the JAX package's `AUX_SSM_STITCH_DRAWS`): "joint" (default), the flat
(row, block) inverse-CDF draw in plain PyTorch and the within-block columns
by the within_block_cols kernel; or "fused", every row and column by the
stitch_draws kernel. The two map the uniforms to other indices under the
same law. `block_max` picks block_masses' stabiliser (the JAX package's
`AUX_SSM_BLOCK_MAX`): "row", each row's max (default), or "block", each
128-column block's own, so that a block's mass depends on its columns
only: the particle-sharded kernel (`kernels/pit_sharded.py`) computes each
shard's blocks so, and this route with `stitch="blocked", block_max="block"`
is its one-device twin, bit for bit. Other potentials take the generic
nested (N, N) weights.

Random numbers come as `noise`, one entry a tree level: `(u_rows (n_act,
N), seed)` for each level below the root (the row draws' uniforms and the
column draws' counter seed, an int32 0-d tensor) and `(u_row (1,), u_col
(1,))` for the root; `level_sizes(T)` gives n_act of each level. The level
maps are static NumPy, so the tree loop reads nothing back from the device.

Chain axis: x (C, T, d) runs C independent chains; the noise then carries a
leading C (each level's u_rows (C, n_act, N) and seeds (C,) int32, the
root's uniforms (C, 1)), and each tree level folds the chains into its
pairs: its P = C * n_act nodes are one launch of each stitching kernel, on
either route. The kernels that draw (col_sample; within_block_cols and
stitch_draws on the blocked route) draw chain c's pairs with chain c's seed
and each pair's index within its own chain's level, so chain c draws what a
one-chain step with its noise draws; the blocked route's flat (row, block)
draw is per node. One chain runs as C = 1.
"""
import functools
import math

import numpy as np
import torch

from .csmc_base import CSMCState, tree_map
from ..ops import stitching as st
from ..ops.cuda import stitching as kernels
from ..ops.take import categorical_from_uniforms, take_rows

# Below it the two-pass route, from it the blocked route (with N % 128 == 0
# and N <= _MAX_BLOCKED_N): the JAX package's switch, kept so that the same
# N maps the same uniforms to the same indices.
_BLOCKED_MIN_N = 4096
_MAX_BLOCKED_N = 8192
_INT32_MAX = 2 ** 31 - 1
STITCH_ROUTES = ("auto", "blocked", "2pass")
DRAWS_MODES = ("joint", "fused")
BLOCK_MAX = ("row", "block")


# --------------------------------------------------------------------------
# Generic divide-and-conquer tree map
# --------------------------------------------------------------------------

def _next_pow2(n):
    return 1 << (n - 1).bit_length()


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for z in tree for leaf in _leaves(z)]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [] if tree is None else [tree]


def _tree_map2(fn, a, b):
    if isinstance(a, (tuple, list)):
        return type(a)(_tree_map2(fn, x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    return None if a is None else fn(a, b)


def _pad_leaf(z, pow2, T):
    """Pad the leading axis to pow2: integers and bools with 0, floats with NaN
    (never read: the padded steps sit in inactive pairs)."""
    fill = math.nan if z.is_floating_point() else 0
    return torch.cat([z, z.new_full((pow2 - T,) + tuple(z.shape[1:]), fill)])


def dc_map(elems, operator, last_operator=None):
    """Binary-tree reduction of `elems` (a tuple/list/dict tree of tensors
    with leading axis T) with `operator`. `operator(a, b)` receives trees
    whose leaves are (n_pairs, block, ...) and returns leaves (n_pairs,
    2 * block, ...); `last_operator` (default `operator`) makes the root."""
    last_operator = last_operator or operator
    T = _leaves(elems)[0].shape[0]
    if T <= 1:
        return elems
    pow2 = _next_pow2(T)
    tree = tree_map(lambda z: _pad_leaf(z, pow2, T).reshape((pow2, 1) + tuple(z.shape[1:])),
                    elems)
    K = int(math.log2(pow2))
    for k in range(K):
        block = 1 << k
        n_pairs = pow2 // (2 * block)
        even = tree_map(lambda z: z[0::2], tree)
        odd = tree_map(lambda z: z[1::2], tree)
        # A pair is active iff its odd block holds a real step; a prefix.
        n_active = len(range(block, T, 2 * block))
        if k == K - 1:
            tree = last_operator(even, odd)
        elif n_active == n_pairs:
            tree = operator(even, odd)
        else:
            act = operator(tree_map(lambda z: z[:n_active], even),
                           tree_map(lambda z: z[:n_active], odd))
            rest = _tree_map2(lambda a, b: torch.cat([a[n_active:], b[n_active:]], 1), even, odd)
            tree = _tree_map2(lambda a, b: torch.cat([a, b]), act, rest)
    return tree_map(lambda z: z.reshape((pow2,) + tuple(z.shape[2:]))[:T], tree)


# --------------------------------------------------------------------------
# Stitching operators (one tree level, batched over its pairs)
# --------------------------------------------------------------------------

def stitching_weights(x_left, log_w_left, x_right, log_w_right, params_right, Gt):
    """Normalised (P, N, N) stitching weights across a block boundary:
    w_ij ∝ exp(Gt(x_right_j, x_left_i) + log_w_left_i + log_w_right_j), for
    x_* (P, N, d), log_w_* (P, N) and per-pair params (P, ...)."""
    params = tree_map(lambda z: z.unsqueeze(1), params_right)
    pairwise = Gt(x_right[:, None], x_left[:, :, None], params)
    log_w = pairwise + log_w_left[:, :, None] + log_w_right[:, None, :]
    return torch.exp(log_w - torch.logsumexp(log_w, (-2, -1), keepdim=True))


def _node_noise(u, N, last):
    """A node draw's noise from a step's N + 1 carried uniforms (the dc_map
    operators): the row uniforms and a counter seed (from the last uniform,
    the same for every node of the level), or the root's two uniforms."""
    if last:
        return u[:, 0], u[:, 1]
    return u[:, :N], (u[0, N] * _INT32_MAX).to(torch.int32)


def _gather_concat(inputs_a, inputs_b, l_idx, r_idx, n_samples, last_step):
    """Trajectory gather along the particle axis and concat along time;
    l_idx / r_idx (P, n). At the root the particle axis is squeezed."""
    (traj_a, log_w_a, orig_a), u_a, params_a = inputs_a
    (traj_b, log_w_b, orig_b), u_b, params_b = inputs_b

    def take(z, idx):  # z (P, block, N, ...)
        shape = (idx.shape[0], 1, idx.shape[1]) + (1,) * (z.dim() - 3)
        return torch.gather(z, 2, idx.reshape(shape).expand(
            z.shape[:2] + (idx.shape[1],) + z.shape[3:]))

    def cat(a, b):
        return torch.cat([a, b], 1)

    traj = _tree_map2(lambda a, b: cat(take(a, l_idx), take(b, r_idx)), traj_a, traj_b)
    origins = cat(take(orig_a, l_idx), take(orig_b, r_idx))
    log_w = torch.full_like(cat(log_w_a, log_w_b), -math.log(n_samples))
    if last_step:
        traj = tree_map(lambda z: z[:, :, 0], traj)
        origins = origins[:, :, 0]
    return (traj, log_w, origins), cat(u_a, u_b), _tree_map2(cat, params_a, params_b)


def stitching_operator(inputs_a, inputs_b, Gt, n_samples, last_step):
    """Join two partial conditional smoothers for every pair of a level with
    the generic (N, N) weights. `inputs_* = ((trajectories (P, block, N, d),
    log_weights (P, block, N), origins (P, block, N)), uniforms (P, block,
    N + 1), params (P, block, ...))`; the right block's first-step uniforms
    drive the draw (`_node_noise`)."""
    (traj_a, log_w_a, _), _, _ = inputs_a
    (traj_b, log_w_b, _), u_b, params_b = inputs_b
    rows, cols = _generic_node_draw(traj_a[:, -1], traj_b[:, 0], log_w_a[:, -1], log_w_b[:, 0],
                                    tree_map(lambda z: z[:, 0], params_b), Gt, n_samples,
                                    last_step, _node_noise(u_b[:, 0], n_samples, last_step))
    return _gather_concat(inputs_a, inputs_b, rows, cols, n_samples, last_step)


def fused_stitching_operator(inputs_a, inputs_b, Gt, n_samples, last_step, stitch="auto",
                             draws="joint"):
    """`stitching_operator` for a pair-factorising potential: the same law,
    drawn through the stitching kernels (`_fused_node_draw`)."""
    (traj_a, log_w_a, _), _, _ = inputs_a
    (traj_b, log_w_b, _), u_b, params_b = inputs_b
    rows, cols = _fused_node_draw(traj_a[:, -1], traj_b[:, 0], log_w_a[:, -1], log_w_b[:, 0],
                                  tree_map(lambda z: z[:, 0], params_b), Gt, n_samples,
                                  last_step, _node_noise(u_b[:, 0], n_samples, last_step),
                                  stitch, draws)
    return _gather_concat(inputs_a, inputs_b, rows, cols, n_samples, last_step)


# --------------------------------------------------------------------------
# PIT-cSMC kernel
# --------------------------------------------------------------------------

def level_sizes(S):
    """The number of active nodes of each tree level over S steps; the last
    level is the root (one node) when S > 1."""
    K = int(math.log2(_next_pow2(S)))
    return [len(range(1 << k, S, 2 << k)) for k in range(K)]


def draw_noise(T, N, like, generator=None, chains=None):
    """The tree's noise (levels, root) from `generator`, on `like`'s device
    and in its dtype; the level seeds are drawn there (no host sync). With
    `chains` C, each entry has a leading axis of C."""
    kw = dict(generator=generator, dtype=like.dtype, device=like.device)
    lead = () if chains is None else (chains,)
    levels = [(torch.rand(*lead, n_act, N, **kw),
               torch.randint(0, _INT32_MAX, lead, generator=generator, dtype=torch.int32,
                             device=like.device))
              for n_act in level_sizes(T)[:-1]]
    return levels, (torch.rand(*lead, 1, **kw), torch.rand(*lead, 1, **kw))


def check_routes(stitch, draws, block_max="row"):
    """Raise ValueError on a stitching route, draws mode or block stabiliser
    the tree does not know."""
    if block_max not in BLOCK_MAX:
        raise ValueError(f"block_max must be one of {BLOCK_MAX}, got {block_max!r}")
    if stitch not in STITCH_ROUTES:
        raise ValueError(f"stitch must be one of {STITCH_ROUTES}, got {stitch!r}")
    if draws not in DRAWS_MODES:
        raise ValueError(f"draws must be one of {DRAWS_MODES}, got {draws!r}")


def get_kernel(Mt, G0, Gt, N, Qt=None, stitch="auto", draws="joint", block_max="row"):
    """PIT-cSMC kernel over independent per-time proposals.

    Targets prod_t Mt[t](x_t) G0(x_0) prod Gt, or with `Qt` the Qt-weighted
    model with Mt as proposal (importance correction). `Mt` and `Qt` are
    time-batched distributions: `Mt.sample_from_noise(eps)` maps (T, N, d)
    normals to particles and `Mt.logpdf(xs)` gives (T, N).

    Returns (init, kernel) with `kernel(state, generator=None, noise=None)
    -> CSMCState`; `noise = (eps (T, N, d), levels, root)` (module
    docstring), drawn from `generator` when not given. `stitch`, `draws` and
    `block_max`: the module docstring."""
    check_routes(stitch, draws, block_max)

    def kernel(state, generator=None, noise=None):
        x = state.x
        if noise is None:
            noise = (torch.randn(x.shape[0], N, x.shape[1], generator=generator, dtype=x.dtype,
                                 device=x.device),) + draw_noise(x.shape[0], N, x, generator)
        x_new, picked = _pit_csmc(x, Mt, G0, Gt, N, Qt, noise, stitch, draws, block_max)
        return CSMCState(x=x_new, updated=picked != 0)

    def init(x_star):
        return CSMCState(x=x_star, updated=torch.zeros(x_star.shape[0], dtype=torch.bool,
                                                       device=x_star.device))

    return init, kernel


def _shifted_params(params, chains=False):
    """Gt's params shifted one step right (params[t] weighs the (t-1, t)
    boundary), along axis 1 under a chain axis; the t = 0 placeholder is NaN
    for floats and 0 for integers."""
    ax = 1 if chains else 0

    def shift(z):
        fill = math.nan if z.is_floating_point() else 0
        pad = list(z.shape)
        pad[ax] = 1
        return torch.cat([z.new_full(pad, fill), z], ax)
    return tree_map(shift, params)


def proposals(x_star, Mt, G0, Qt, eps):
    """Every step's N proposals (T, N, d), particle 0 pinned to x_star, and
    their normalised initial log weights (T, N)."""
    xs = Mt.sample_from_noise(eps)
    xs[..., 0, :] = x_star
    if Qt is not None:
        log_wts = Qt.logpdf(xs) - Mt.logpdf(xs)
    else:
        log_wts = xs.new_zeros(xs.shape[:-1])
    log_wts[..., 0, :] = log_wts[..., 0, :] + G0(xs[..., 0, :, :])
    return xs, log_wts - torch.logsumexp(log_wts, -1, keepdim=True)


def _pit_csmc(x_star, Mt, G0, Gt, N, Qt, noise, stitch="auto", draws="joint", block_max="row",
              score_mesh=None, score_axis=None):
    """Index-composition PIT engine: propose all T x N particles, run the
    stitching tree on boundary values, resolve the genealogy, gather once.
    Returns (x (T, d), picked (T,)), each with x_star's chain axis (if any)
    in front. `score_mesh`: the particle-sharded block-mass pass
    (`_fused_node_draw`)."""
    eps, levels, root = noise
    T = x_star.shape[-2]
    xs, log_wts = proposals(x_star, Mt, G0, Qt, eps)

    if T == 1:
        j = categorical_from_uniforms(log_wts[..., 0, :], root[0].reshape(*x_star.shape[:-2], 1))
        return _take_steps(xs, j), j

    noise = list(levels) + [root]
    route = dict(stitch=stitch, draws=draws, block_max=block_max, score_mesh=score_mesh,
                 score_axis=score_axis)
    if x_star.dim() == 2:
        sels, root_pair = run_stitch_tree(xs, xs, log_wts, noise, _shifted_params(Gt.params),
                                          Gt, N, include_root=True, **route)
        idx = resolve_genealogy(sels, _root_init(root_pair, T, N), T, N)
    else:
        sels, root_pair = _stitch_tree(xs, xs, log_wts, noise, _shifted_params(Gt.params, True),
                                       Gt, N, include_root=True, **route)
        idx = _resolve(sels, _root_rows(root_pair, T), T, N)
    return _take_steps(xs, idx), idx


def _take_steps(xs, idx):
    """xs (..., T, N, d) at each step's index idx (..., T) -> (..., T, d)."""
    index = idx[..., None, None].expand(*idx.shape, 1, xs.shape[-1])
    return torch.gather(xs, -2, index)[..., 0, :]


def _fresh_weights(log_wts, steps, consumed, n_act, N, like):
    """The initial weights (C, n_act, N) of the level's boundary `steps` (a
    slice) that have not served as a boundary yet, 0 for the others (all 0
    where `log_wts` is None: uniform weights, shaped and placed as
    `like`)."""
    if log_wts is None:
        return like.new_zeros(like.shape[0], n_act, N)
    fresh = ~consumed[steps]
    if fresh.all():
        return log_wts[:, steps]
    out = log_wts.new_zeros(log_wts.shape[0], n_act, N)
    for p, t in zip(np.flatnonzero(fresh), np.arange(len(consumed))[steps][fresh]):
        out[:, p] = log_wts[:, int(t)]
    return out


def run_stitch_tree(left_vals, right_vals, log_wts, noise, params, Gt, N, include_root,
                    stitch="auto", draws="joint", pair_offset=0, block_max="row",
                    score_mesh=None, score_axis=None, return_bounds=False):
    """Run the stitching levels over S steps, recording each level's draws.

    left_vals / right_vals (S, N, d): the particle sets serving as a node's
    left / right boundary values (both the proposals in the one-device
    tree; the chunks' boundary sets in the time-sharded kernel's upper
    tree). log_wts (S, N): initial importance weights, or None for uniform.
    noise: one entry a level (the module docstring). params: the
    right-shifted Gt params. include_root: one unconditional pair at the top
    level instead of N. pair_offset: the first node's index in its level's
    pair counters (an int, or one a level): a tree over a slice of a
    level's nodes then draws what the whole level's tree draws there.

    Boundary values are carried forward per node (x_first / x_last, one
    gather per drawn selection). A step's weights enter the pair weights at
    the first level where it serves as a boundary (level 0 for all but the
    last step of an odd S, which joins where S - 1 = odd * 2^k); afterwards
    weights are uniform.

    Returns (sels, root): `sels` a list over the recorded levels of (L, R,
    n_act) with L / R (n_act, N) int64, `root` the (l*, r*) pair (or None);
    with `return_bounds` also (x_first, x_last), the top node's first- and
    last-step particle values (N, d) each. One chain of the tree that
    `_stitch_tree` runs over a chain axis.
    """
    def one(z):
        return None if z is None else z[None]

    noise = [(u[None], seed.reshape(1)) if i < len(noise) - 1 or not include_root
             else tuple(z.reshape(1, -1) for z in (u, seed))
             for i, (u, seed) in enumerate(noise)]
    sels, root, bounds = _stitch_tree(one(left_vals), one(right_vals), one(log_wts), noise,
                                      tree_map(one, params), Gt, N, include_root, stitch, draws,
                                      pair_offset, block_max, score_mesh, score_axis,
                                      return_bounds=True)
    sels = [(L[0], R[0], n) for L, R, n in sels]
    if return_bounds:
        return sels, root, tuple(z[0] for z in bounds)
    return sels, root


def _stitch_tree(left_vals, right_vals, log_wts, noise, params, Gt, N, include_root,
                 stitch="auto", draws="joint", pair_offset=0, block_max="row", score_mesh=None,
                 score_axis=None, return_bounds=False):
    """`run_stitch_tree` over a leading chain axis of C: left_vals /
    right_vals (C, S, N, d), log_wts (C, S, N), params (C, S, ...) (or (1,
    S, ...), every chain's), the
    noise as the module docstring's chain layout. A level's C * n_act nodes
    are drawn as one batch of pairs. Returns `sels` of (L, R, n_act), L / R
    (C, n_act, N), and `root` (l*, r*), each (C,); with `return_bounds` also
    the top node's (x_first, x_last), (C, N, d) each."""
    C, S = left_vals.shape[:2]
    # Params every chain shares come with a unit chain axis: a view of C.
    params = tree_map(lambda z: z.expand(C, *z.shape[1:]), params)
    fused = getattr(Gt, "supports_pairwise_factors", False)
    K = int(math.log2(_next_pow2(S)))
    sels, root = [], None
    x_first, x_last = right_vals, left_vals
    consumed = np.zeros(S, dtype=bool)
    for k in range(K):
        block = 1 << k
        n_nodes = -(-S // block)
        rights = slice(block, S, 2 * block)       # the level's active nodes: a prefix
        lefts = slice(block - 1, S - 1, 2 * block)
        n_act = len(range(S)[rights])  # >= 1: step 2^k < S at every level
        xf_even, xf_odd = x_first[:, 0::2], x_first[:, 1::2]
        xl_even, xl_odd = x_last[:, 0::2], x_last[:, 1::2]
        xl, xr = xl_even[:, :n_act], xf_odd[:, :n_act]
        lw_l = _fresh_weights(log_wts, lefts, consumed, n_act, N, xl[..., 0])
        lw_r = _fresh_weights(log_wts, rights, consumed, n_act, N, xl[..., 0])
        consumed[lefts] = consumed[rights] = True
        last = include_root and k == K - 1

        def fold(z):  # (C, n_act, ...) -> (C * n_act, ...)
            return z.reshape((C * n_act,) + tuple(z.shape[2:]))

        def unfold(z):
            return z.reshape((C, n_act) + tuple(z.shape[1:]))

        params_r = tree_map(lambda z: fold(z[:, rights]), params)
        level = noise[k] if last else (fold(noise[k][0]), noise[k][1])
        new_first = new_last = None
        if fused:
            off = pair_offset[k] if isinstance(pair_offset, (list, tuple)) else pair_offset
            out = _fused_node_draw(fold(xl), fold(xr), fold(lw_l), fold(lw_r), params_r, Gt, N,
                                   last, level, stitch, draws, pair_offset=off,
                                   block_max=block_max, score_mesh=score_mesh,
                                   score_axis=score_axis,
                                   row_payload=None if last else fold(xf_even[:, :n_act]),
                                   col_payload=None if last else fold(xl_odd[:, :n_act]),
                                   chains=C)
            rows, cols = out[:2]
            if not last:
                new_first, new_last = (unfold(z) for z in out[2:])
        else:
            rows, cols = _generic_node_draw(fold(xl), fold(xr), fold(lw_l), fold(lw_r),
                                            params_r, Gt, N, last, level)
        if last:
            root = (rows[:, 0], cols[:, 0])
        else:
            rows, cols = unfold(rows), unfold(cols)
            sels.append((rows, cols, n_act))
            # Merged node p: first values = the left child's firsts by the drawn
            # rows, last values = the right child's lasts by the drawn columns. A
            # trailing even node without a sibling passes through.
            if new_first is None:
                new_first = take_rows(xf_even[:, :n_act], rows)
                new_last = take_rows(xl_odd[:, :n_act], cols)
            x_first = torch.cat([new_first, xf_even[:, n_act:]], 1)
            x_last = torch.cat([new_last, xl_even[:, n_act:] if n_nodes % 2
                                else xl_odd[:, n_act:]], 1)
    if return_bounds:
        return sels, root, (x_first[:, 0], x_last[:, 0])
    return sels, root


def _root_init(root, S, N):
    """Initial per-step index from the root's single (l*, r*) pair."""
    return _root_rows(root, S)[0]


def _root_rows(root, S):
    """The initial per-step index of each chain: root (l*, r*) each (C,) ->
    (C, S)."""
    half = _next_pow2(S) // 2
    l_star, r_star = root
    first = torch.arange(S, device=l_star.device) < half
    return torch.where(first, l_star[:, None], r_star[:, None])


@functools.lru_cache(maxsize=512)
def _level_index(S, j, n_act, N, device):
    """The static index tensors of level j's selection rows over S steps, on
    `device`: (li, ri, right, ident). Built once per shape, so a step copies
    no index array to the card."""
    ts = np.arange(S)
    p = ts >> (j + 1)
    side = (ts >> j) & 1
    act = p < n_act
    li = np.where(act & (side == 0), p, n_act)
    ri = np.where(act & (side == 1), p, n_act)
    return tuple(torch.as_tensor(z, device=device)
                 for z in (li, ri, (side == 1) & act, np.arange(N)[None]))


def _level_selection_rows(S, j, sel, N):
    """Identity-padded per-time selection rows of level `j`, (C, S, N): row t
    holds the level's L (left side) or R (right side) map when t's node at
    that level is active, else the identity (p = t >> (j + 1), side = (t >>
    j) & 1)."""
    L, R, n_act = sel
    li, ri, right, ident = _level_index(S, j, n_act, N, L.device)
    ident = ident.expand(L.shape[0], 1, N)
    Lp, Rp = torch.cat([L, ident], 1), torch.cat([R, ident], 1)
    return torch.where(right[:, None], Rp[:, ri], Lp[:, li])


def resolve_genealogy(sels, idx_init, S, N):
    """idx[t] = s_0(t)[s_1(t)[... [idx_init[t]] ...]] through the recorded
    selections, top level first; O(S) work a level. One chain of `_resolve`."""
    return _resolve([(L[None], R[None], n) for L, R, n in sels], idx_init[None], S, N)[0]


def _resolve(sels, idx_init, S, N):
    """`resolve_genealogy` of C chains: sels' maps (C, n_act, N), idx_init
    (C, S) -> (C, S)."""
    idx = idx_init
    for k in range(len(sels) - 1, -1, -1):
        idx = torch.gather(_level_selection_rows(S, k, sels[k], N), 2, idx[..., None])[..., 0]
    return idx


def _use_blocked_stitch(N, stitch):
    """The blocked route: forced by stitch='blocked', else from N = 4096 on;
    N must be a multiple of 128 and at most 8192."""
    if stitch == "2pass" or N % st._COL_BLOCK or N > _MAX_BLOCKED_N:
        return False
    return stitch == "blocked" or N >= _BLOCKED_MIN_N


def _fused_node_draw(xl, xr, lw_l, lw_r, params_r, Gt, N, last, noise, stitch="auto",
                     draws="joint", pair_offset=0, row_payload=None, col_payload=None,
                     chains=None, block_max="row", score_mesh=None, score_axis=None):
    """The factorised draw for one level's nodes. xl / xr (n_act, N, d): the
    left child's last-step and the right child's first-step particles; lw_l /
    lw_r (n_act, N) their fresh weights. Returns (rows, cols), each (n_act, N)
    (or (1, 1) at the root), and with `row_payload` / `col_payload` (n_act,
    N, e) also those values at the drawn rows / columns. Pair 0 is pinned to
    (0, 0), payloads to index 0's values. `draws` applies on the blocked
    route only. With `chains` C, the nodes are C chains' n_act nodes each,
    chain after chain, and the level's seed is (C,): one a chain, on either
    route. With `score_mesh`, the blocked route (forced below the root at
    any N) computes the block masses column-sharded over
    `score_mesh[score_axis]` (`sharded_block_masses`)."""
    rf, cf, rb, cb = Gt.pairwise_factors(xl, xr, params_r)
    rb = rb + lw_l
    cb = (cb + lw_r).contiguous()
    rf, cf = rf.contiguous(), cf.contiguous()
    blocked = (_use_blocked_stitch(N, stitch) or score_mesh is not None) and not last

    if last:
        u_row, u_col = noise
        row_logits = rb + kernels.row_lse(rf, cf, cb)
        row = categorical_from_uniforms(row_logits, u_row.reshape(-1, 1))
        rf_sel = take_rows(rf, row)[:, 0]
        s = torch.einsum("pk,pjk->pj", rf_sel, cf) + cb
        return row, categorical_from_uniforms(s, u_col.reshape(-1, 1))

    u_rows, seed = noise
    if blocked and score_mesh is not None:
        Lb = sharded_block_masses(score_mesh, score_axis, rf, cf, cb)
    elif blocked:
        Lb = kernels.block_masses(rf, cf, cb, per_block_max=block_max == "block")
    if blocked and draws == "joint":
        if row_payload is None:
            rows, blocks, rf_sel = st.joint_rowblock_draws(u_rows, rb, Lb, row_feat=rf)
            cols = kernels.within_block_cols(seed, blocks, rf_sel, cf, cb, pair_offset,
                                             chains=chains)
        else:
            rows, blocks, rf_sel, rpay = st.joint_rowblock_draws(u_rows, rb, Lb, row_feat=rf,
                                                                 row_extra=row_payload)
            cols, cpay = kernels.within_block_cols(seed, blocks, rf_sel, cf, cb, pair_offset,
                                                   col_extra=col_payload, chains=chains)
            rpay[:, 0], cpay[:, 0] = row_payload[:, 0], col_payload[:, 0]
        rows[:, 0] = 0
        cols[:, 0] = 0
        return (rows, cols) if row_payload is None else (rows, cols, rpay, cpay)

    if blocked:  # draws == "fused"
        rows, cols = kernels.stitch_draws(seed, rb + torch.logsumexp(Lb, -1), u_rows, Lb, rf, cf,
                                          cb, pair_offset, chains=chains)
    else:
        rows = categorical_from_uniforms(rb + kernels.row_lse(rf, cf, cb), u_rows)
        rows[:, 0] = 0
        cols = kernels.col_sample(seed, take_rows(rf, rows).contiguous(), cf, cb, pair_offset,
                                  chains=chains)
    rows[:, 0] = 0
    cols[:, 0] = 0
    if row_payload is None:
        return rows, cols
    return rows, cols, take_rows(row_payload, rows), take_rows(col_payload, cols)


def sharded_block_masses(mesh, axis, rf, cf, cb):
    """The block log-masses (P, n, N / 128) with the columns over
    `mesh[axis]`: each shard runs the block_masses kernel on every row and
    its own N/S columns, each block about its own max (`per_block_max`), and
    the masses are all-gathered along the block axis in shard order. A
    block's mass depends on its columns only, so this is bit-equal to the
    one-device pass with per-block maxima. N/S must be a multiple of 128."""
    from ..parallel import collectives as col
    S, N = mesh.shape[axis], cf.shape[1]
    if N % (st._COL_BLOCK * S):
        raise ValueError(f"particle-sharded stitching needs N/S a multiple of 128 "
                         f"(N={N}, S={S})")
    cfs, cbs = col.split(mesh, cf, 1, axis), col.split(mesh, cb, 1, axis)
    parts = [kernels.block_masses(rf.to(c.device), c, b, per_block_max=True)
             for c, b in zip(cfs, cbs)]
    return col.gather(mesh, parts, 2, axis).to(rf.device)


def _generic_node_draw(xl, xr, lw_l, lw_r, params_r, Gt, N, last, noise):
    """Arbitrary-potential draw through the materialised (n_act, N, N)
    weights: N multinomial draws from the row uniforms with index 0 pinned
    (`resampling.multinomial_from_uniforms`), or at the root one draw as
    `jax.random.choice` makes it (inverse CDF at (1 - u) * total)."""
    w = stitching_weights(xl, lw_l, xr, lw_r, params_r, Gt).reshape(xl.shape[0], N * N)
    cdf = torch.cumsum(w, -1)
    if last:
        u = noise[0].reshape(-1, 1)
        idx = torch.searchsorted(cdf, (cdf[:, -1:] * (1 - u)).contiguous())
    else:
        idx = torch.searchsorted(cdf, noise[0].contiguous())
        idx[:, 0] = 0
    idx = idx.clamp_(max=N * N - 1)
    rows = torch.div(idx, N, rounding_mode="floor")
    return rows, idx - rows * N
