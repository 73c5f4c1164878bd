"""Chunked inclusive associative scans: wrappers of `csrc/scan.cu` with their
plain PyTorch versions (counterpart of `aux_ssm_tpu/ops/pallas/filter_scan.py`
and of `fused_affine_scan` in `aux_ssm_tpu/ops/pallas/kalman_fused.py`).

Both scans use one chunk order: the n elements are cut into CHUNKS
contiguous chunks of ceil(n / CHUNKS); each chunk is scanned sequentially,
the chunk totals by Hillis-Steele, and each chunk's elements are then
combined with the total of the chunks before it. The plain versions run the
same chunks in the same order, so kernel and plain agree to rounding.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises. On the card one scan is one call into the
kernel library, which runs the three passes as 2 + log2(CHUNKS) launches on
the current stream; each wrapper counts those calls in its `launches`
attribute.
"""
import torch

from ._build import MAX_DIM, check_cuda_inputs, launch
from .kalman_fused import _check_shapes, _on_cuda

CHUNKS = 128  # kChunks of csrc/scan.cu: one warp (block) per chunk


def chunked_scan_plain(op, elems, identity):
    """Inclusive scan of `elems` (a tuple of tensors with leading axis n)
    under the associative `op(left, right)`, in the kernel's chunk order.
    `identity` is the op's identity element (a tuple of unbatched tensors)."""
    n = elems[0].shape[0]
    S = -(-n // CHUNKS)
    pad = CHUNKS * S - n
    chunks = tuple(
        torch.cat([z, e.expand((pad,) + e.shape)]).reshape((CHUNKS, S) + z.shape[1:])
        for z, e in zip(elems, identity))

    # Pass 1: sequential prefixes within each chunk.
    prefixes = [tuple(z[:, 0] for z in chunks)]
    for s in range(1, S):
        prefixes.append(op(prefixes[-1], tuple(z[:, s] for z in chunks)))
    prefix = tuple(torch.stack(p, dim=1) for p in zip(*prefixes))

    # Pass 2: Hillis-Steele over the chunk totals.
    tot = prefixes[-1]
    off = 1
    while off < CHUNKS:
        comb = op(tuple(z[:-off] for z in tot), tuple(z[off:] for z in tot))
        tot = tuple(torch.cat([z[:off], c]) for z, c in zip(tot, comb))
        off *= 2

    # Pass 3: chunk c > 0 takes the inclusive total of the chunks before it.
    pre = tuple(z[:-1, None].expand(p[1:].shape) for z, p in zip(tot, prefix))
    applied = op(pre, tuple(p[1:] for p in prefix))
    return tuple(torch.cat([p[:1], a]).reshape((CHUNKS * S,) + p.shape[2:])[:n]
                 for p, a in zip(prefix, applied))


# --------------------------------------------------------------------------
# Filtering scan (fused_filter_scan)
# --------------------------------------------------------------------------

def _filter_identity(b):
    d = b.shape[-1]
    eye = torch.eye(d, dtype=b.dtype, device=b.device)
    zv, zm = b.new_zeros(d), b.new_zeros(d, d)
    return eye, zv, zm, zv, zm


def filter_scan_plain(elems):
    """Inclusive scan of filtering elements (A, b, C, eta, J) under
    `ops.filtering.filtering_operator`."""
    from ..filtering import filtering_operator  # filtering imports this module

    return chunked_scan_plain(filtering_operator, elems, _filter_identity(elems[1]))


def filter_scan(elems):
    """Inclusive scan of filtering elements; see `filter_scan_plain`.
    `elems = (A, b, C, eta, J)` with shapes (n, d, d) / (n, d)."""
    A, b, C, e, J = elems
    if not _on_cuda("filter_scan", b):
        return filter_scan_plain(elems)
    n, d = b.shape
    _check_shapes("filter_scan", "FxFxF", elems, n, d, d)
    args = check_cuda_inputs("filter_scan", (A, b, C, e, J), b.dtype, MAX_DIM, (d,))
    out = tuple(torch.empty_like(z) for z in args)
    scratch = torch.empty(2 * CHUNKS * (3 * d * d + 2 * d), dtype=b.dtype, device=b.device)
    if n:
        launch("filter_scan", b.dtype, n, d, *args, *out, scratch)
        filter_scan.launches += 1
    return out


filter_scan.launches = 0


# --------------------------------------------------------------------------
# Affine scan (fused_affine_scan)
# --------------------------------------------------------------------------

def affine_scan_plain(gains, incs, reverse=False):
    """Inclusive scan of affine maps (G, e) under
    `ops.sampling.sampling_operator`; `reverse=True` scans from the end, as
    `jax.lax.associative_scan(..., reverse=True)`."""
    from ..sampling import sampling_operator  # sampling imports this module

    d = incs.shape[-1]
    identity = (torch.eye(d, dtype=incs.dtype, device=incs.device), incs.new_zeros(d))
    if reverse:
        G, e = chunked_scan_plain(sampling_operator, (gains.flip(0), incs.flip(0)), identity)
        return G.flip(0), e.flip(0)
    return chunked_scan_plain(sampling_operator, (gains, incs), identity)


def affine_scan(gains, incs, reverse=False):
    """Inclusive scan of affine maps; see `affine_scan_plain`. gains (n, d, d),
    incs (n, d)."""
    if not _on_cuda("affine_scan", incs):
        return affine_scan_plain(gains, incs, reverse)
    n, d = incs.shape
    _check_shapes("affine_scan", "F", (gains,), n, d, d)
    G, e = check_cuda_inputs("affine_scan", (gains, incs), incs.dtype, MAX_DIM, (d,))
    oG, oe = torch.empty_like(G), torch.empty_like(e)
    scratch = torch.empty(2 * CHUNKS * (d * d + d), dtype=e.dtype, device=e.device)
    if n:
        launch("affine_scan", e.dtype, n, d, int(reverse), G, e, oG, oe, scratch)
        affine_scan.launches += 1
    return oG, oe


affine_scan.launches = 0
