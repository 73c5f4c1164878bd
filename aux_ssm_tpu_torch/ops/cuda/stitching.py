"""The stitching kernels of the parallel-in-time cSMC: wrappers of
`csrc/stitching.cu` (counterpart of `aux_ssm_tpu/ops/pallas/stitching.py`'s
`row_lse`, `col_sample`, `block_masses` and `stitch_draws`; and
`within_block_cols`, the column stage of `stitch_draws`, which the JAX
package computes in XLA and the port's default blocked draws call). Their
plain versions are in `ops/stitching.py`.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises. One call is one launch, serving every node of
a tree level; each wrapper counts its launches in its `launches` attribute.
The kernels take float32 or float64, feature widths k <= 64 and any row and
column counts (block_masses and the draws: columns a multiple of 128; the
draws: at most 8192).

Chain axis: the three kernels that draw (col_sample, within_block_cols,
stitch_draws) take `chains` C: a level's P nodes are then C chains' P / C
each, chain after chain, with one seed a chain, and each node's pair counter
runs within its own chain (`ops.stitching.pair_counters`), so chain c draws
what a one-chain launch with its seed draws, and C = 1 is that launch.
row_lse and block_masses draw nothing and take the folded nodes as they
are.
"""
import torch

from .. import stitching as plain
from ..take import take_rows
from ._build import check_cuda_inputs, launch
from .kalman_fused import _on_cuda

MAX_K = 64
MAX_DRAWS_N = 8192  # kMaxNb column blocks of 128


def _check(name, rf, cf, cb):
    """(P, rows, columns, k) of the factors, after checking their shapes."""
    if rf.dim() != 3 or cf.dim() != 3 or cb.dim() != 2:
        raise ValueError(f"{name}: expected rf (P, n, k), cf (P, N, k), cb (P, N), got "
                         f"{tuple(rf.shape)}, {tuple(cf.shape)}, {tuple(cb.shape)}")
    P, n, k = rf.shape
    if cf.shape[0] != P or cf.shape[2] != k or tuple(cb.shape) != tuple(cf.shape[:2]):
        raise ValueError(f"{name}: factor shapes {tuple(rf.shape)}, {tuple(cf.shape)}, "
                         f"{tuple(cb.shape)} do not match")
    return P, n, cf.shape[1], k


def _seed_on(seed, ref):
    """The counter seed (or a chain's seeds) as an int32 vector on ref's
    device: the kernels read it there, so a seed drawn on the card costs no
    host sync."""
    return torch.as_tensor(seed, device=ref.device).to(torch.int32).reshape(-1).contiguous()


def _chain_pairs(name, seed, P, chains):
    """The pairs of each chain, P / C, after checking that the P pairs and
    the seeds make `chains` C chains (one seed a chain; None: one chain, one
    seed)."""
    C = 1 if chains is None else chains
    n_seeds = torch.as_tensor(seed).numel()
    if P % C or (chains is not None and n_seeds != C):
        raise ValueError(f"{name}: {P} pairs and {n_seeds} seeds do not make {C} chains")
    return P // C


def _check_draw_columns(name, N):
    if N % plain._COL_BLOCK or N > MAX_DRAWS_N:
        raise ValueError(f"{name}: the column count {N} is not a multiple of 128 up to "
                         f"{MAX_DRAWS_N}")


def row_lse(row_feat, col_feat, col_bias):
    """lse[p, i] = logsumexp_j(row_feat[p, i] . col_feat[p, j] + col_bias[p, j]):
    row_feat (P, n, k), col_feat (P, N, k), col_bias (P, N) -> (P, n); see
    `ops.stitching.row_lse`."""
    P, n, N, k = _check("row_lse", row_feat, col_feat, col_bias)
    if not _on_cuda("row_lse", row_feat):
        return plain.row_lse(row_feat, col_feat, col_bias)
    rf, cf, cb = check_cuda_inputs("row_lse", (row_feat, col_feat, col_bias), row_feat.dtype,
                                   MAX_K, (k,))
    out = rf.new_empty(P, n)
    if out.numel() and N:
        launch("row_lse", rf.dtype, P, n, N, k, rf, cf, cb, out)
        row_lse.launches += 1
    return out


row_lse.launches = 0


def col_sample(seed, row_feat_sel, col_feat, col_bias, pair_offset=0, chains=None):
    """One column per sampled row by Gumbel-argmax with counter uniforms:
    seed an int32 0-d tensor on the factors' device (or a Python int),
    row_feat_sel (P, n, k), col_feat (P, N, k), col_bias (P, N) -> (P, n)
    int64; see `ops.stitching.col_sample`. The kernel reads the seed on the
    card, so a seed drawn there costs no host sync. With `chains` C, the P
    pairs are C chains' P / C each, chain after chain, and seed is (C,):
    chain c's pairs draw with seed[c] and their index within the chain."""
    P, n, N, k = _check("col_sample", row_feat_sel, col_feat, col_bias)
    chain_pairs = _chain_pairs("col_sample", seed, P, chains)
    if not _on_cuda("col_sample", row_feat_sel):
        return plain.col_sample(seed, row_feat_sel, col_feat, col_bias, pair_offset, chains)
    rf, cf, cb = check_cuda_inputs("col_sample", (row_feat_sel, col_feat, col_bias),
                                   row_feat_sel.dtype, MAX_K, (k,))
    out = torch.empty(P, n, dtype=torch.int64, device=rf.device)
    if out.numel() and N:
        launch("col_sample", rf.dtype, P, n, N, k, _seed_on(seed, rf), chain_pairs,
               int(pair_offset), rf, cf, cb, out)
        col_sample.launches += 1
    return out


col_sample.launches = 0


def block_masses(row_feat, col_feat, col_bias, per_block_max=False):
    """Per-row log-masses of each 128-column block: row_feat (P, n, k),
    col_feat (P, N, k), col_bias (P, N), N a multiple of 128 -> (P, n,
    N / 128), in the inputs' dtype; see `ops.stitching.block_masses`."""
    P, n, N, k = _check("block_masses", row_feat, col_feat, col_bias)
    if N % plain._COL_BLOCK:
        raise ValueError(f"block_masses: the column count {N} is not a multiple of 128")
    if not _on_cuda("block_masses", row_feat):
        return plain.block_masses(row_feat, col_feat, col_bias, per_block_max)
    rf, cf, cb = check_cuda_inputs("block_masses", (row_feat, col_feat, col_bias),
                                   row_feat.dtype, MAX_K, (k,))
    out = rf.new_empty(P, n, N // plain._COL_BLOCK)
    if out.numel():
        launch("block_masses", rf.dtype, P, n, N, k, int(bool(per_block_max)), rf, cf, cb, out)
        block_masses.launches += 1
    return out


block_masses.launches = 0


def within_block_cols(seed, blocks, row_feat_sel, col_feat, col_bias, pair_offset=0,
                      col_extra=None, chains=None):
    """The column inside each draw's 128-column block by Gumbel-argmax with
    counter uniforms: seed and `chains` as for `col_sample`, blocks (P, n)
    int64 in [0, N / 128), row_feat_sel (P, n, k), col_feat (P, N, k),
    col_bias (P, N) -> (P, n) int64, and with `col_extra` (P, N, e) also its
    values at the columns; see `ops.stitching.within_block_cols`. The card
    does not check the blocks' values: one outside [0, N / 128) reads another
    node's or unallocated memory, where the plain version raises
    IndexError."""
    P, n, N, k = _check("within_block_cols", row_feat_sel, col_feat, col_bias)
    _check_draw_columns("within_block_cols", N)
    chain_pairs = _chain_pairs("within_block_cols", seed, P, chains)
    if tuple(blocks.shape) != (P, n):
        raise ValueError(f"within_block_cols: blocks {tuple(blocks.shape)}, expected {(P, n)}")
    if not _on_cuda("within_block_cols", row_feat_sel):
        return plain.within_block_cols(seed, blocks, row_feat_sel, col_feat, col_bias,
                                       pair_offset, col_extra, chains)
    rf, cf, cb = check_cuda_inputs("within_block_cols", (row_feat_sel, col_feat, col_bias),
                                   row_feat_sel.dtype, MAX_K, (k,))
    blocks = blocks.to(device=rf.device, dtype=torch.int64).contiguous()
    cols = torch.empty(P, n, dtype=torch.int64, device=rf.device)
    if cols.numel():
        launch("within_block_cols", rf.dtype, P, n, N, k, _seed_on(seed, rf), chain_pairs,
               int(pair_offset), blocks, rf, cf, cb, cols)
        within_block_cols.launches += 1
    if col_extra is None:
        return cols
    return cols, take_rows(col_extra, cols)


within_block_cols.launches = 0


def stitch_draws(seed, row_logits, u_rows, Lb, row_feat, col_feat, col_bias, pair_offset=0,
                 chains=None):
    """Every (row, column) draw of one tree level: seed and `chains` as for
    `col_sample`, row_logits (P, N) = row_bias + logsumexp(Lb, -1), u_rows (P,
    N), Lb (P, N, N / 128), row_feat, col_feat (P, N, k), col_bias (P, N) ->
    (rows, cols), each (P, N) int64; pair 0 is not pinned. See
    `ops.stitching.stitch_draws`."""
    P, n, N, k = _check("stitch_draws", row_feat, col_feat, col_bias)
    _check_draw_columns("stitch_draws", N)
    chain_pairs = _chain_pairs("stitch_draws", seed, P, chains)
    nb = N // plain._COL_BLOCK
    if (n != N or tuple(row_logits.shape) != (P, N) or tuple(u_rows.shape) != (P, N)
            or tuple(Lb.shape) != (P, N, nb)):
        raise ValueError(f"stitch_draws: row_logits {tuple(row_logits.shape)}, u_rows "
                         f"{tuple(u_rows.shape)}, Lb {tuple(Lb.shape)} and rf "
                         f"{tuple(row_feat.shape)} do not match {(P, N, nb)}")
    if not _on_cuda("stitch_draws", row_feat):
        return plain.stitch_draws(seed, row_logits, u_rows, Lb, row_feat, col_feat, col_bias,
                                  pair_offset, chains)
    rl, u, Lb, rf, cf, cb = check_cuda_inputs(
        "stitch_draws", (row_logits, u_rows, Lb, row_feat, col_feat, col_bias), row_feat.dtype,
        MAX_K, (k,))
    rows, cols = (torch.empty(P, N, dtype=torch.int64, device=rf.device) for _ in range(2))
    launch("stitch_draws", rf.dtype, P, N, k, _seed_on(seed, rf), chain_pairs, int(pair_offset),
           rl, u, Lb, rf, cf, cb, rows, cols)
    stitch_draws.launches += 1
    return rows, cols


stitch_draws.launches = 0


def draw_log_mismatches(device=None):
    """The count of positive normal floats x for which the draw kernels'
    float32 log (`draw_log` in csrc/stitching.cu) and the CUDA math
    library's logf differ in any bit, on the card: their float32 indices
    equal the plain version's only where it is 0. A check, not a kernel of
    any path (no launch count)."""
    out = torch.zeros(1, dtype=torch.int64, device=device or "cuda")
    launch("draw_log_mismatches", torch.float32, out)
    return int(out)
