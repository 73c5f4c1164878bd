"""The stitching kernels of the parallel-in-time cSMC: wrappers of
`csrc/stitching.cu` (counterpart of `aux_ssm_tpu/ops/pallas/stitching.py`'s
`row_lse`, `col_sample` and `block_masses`). Their plain versions are in
`ops/stitching.py`.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises. One call is one launch, serving every node of
a tree level; each wrapper counts its launches in its `launches` attribute.
The kernels take float32 or float64, feature widths k <= 64 and any row and
column counts (block_masses: columns a multiple of 128).
"""
import torch

from .. import stitching as plain
from ._build import check_cuda_inputs, launch
from .kalman_fused import _on_cuda

MAX_K = 64


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


def col_sample(seed, row_feat_sel, col_feat, col_bias, pair_offset=0):
    """One column per sampled row by Gumbel-argmax with counter uniforms:
    seed an int32 0-d tensor on the factors' device (or a Python int),
    row_feat_sel (P, n, k), col_feat (P, N, k), col_bias (P, N) -> (P, n)
    int64; see `ops.stitching.col_sample`. The kernel reads the seed on the
    card, so a seed drawn there costs no host sync."""
    P, n, N, k = _check("col_sample", row_feat_sel, col_feat, col_bias)
    if not _on_cuda("col_sample", row_feat_sel):
        return plain.col_sample(seed, row_feat_sel, col_feat, col_bias, pair_offset)
    rf, cf, cb = check_cuda_inputs("col_sample", (row_feat_sel, col_feat, col_bias),
                                   row_feat_sel.dtype, MAX_K, (k,))
    seed_t = torch.as_tensor(seed, device=rf.device).to(torch.int32).reshape(1)
    out = torch.empty(P, n, dtype=torch.int64, device=rf.device)
    if out.numel() and N:
        launch("col_sample", rf.dtype, P, n, N, k, seed_t, int(pair_offset), rf, cf, cb, out)
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
