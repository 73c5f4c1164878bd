"""Chunked inclusive associative scans: wrappers of `csrc/scan.cu` with their
plain PyTorch versions (counterpart of `aux_ssm_tpu/ops/pallas/filter_scan.py`
and of `fused_affine_scan` in `aux_ssm_tpu/ops/pallas/kalman_fused.py`).

Both scans use one chunk order: the n elements are cut into C contiguous
chunks of ceil(n / C); each chunk is scanned sequentially, the chunk totals
by Hillis-Steele, and each chunk's elements are then combined with the total
of the chunks before it. The filter scan takes C from n (`filter_chunks`:
about n / 4, a power of two, at most 128), the affine scan C =
AFFINE_CHUNKS. The plain versions run the same chunks in the same order, so
kernel and plain agree to rounding.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises. On the card the filter scan is one launch (the
chunks' blocks hand the totals on through a buffer in global memory that the
module keeps, one a device and dtype); the affine scan
runs its three passes as 2 + log2(AFFINE_CHUNKS) launches on the current
stream. Each wrapper counts its calls into the kernel library in its
`launches` attribute.
"""
import torch

from ._build import MAX_DIM, check_cuda_inputs, launch
from .kalman_fused import _check_shapes, _on_cuda

AFFINE_CHUNKS = 128  # kAffineChunks of csrc/scan.cu: one warp (block) per chunk
FILTER_PER = 4       # kFilterPer: the elements a filter-scan chunk aims at
FILTER_MAX_CHUNKS = 128  # kFilterMaxChunks
FILTER_D = 16        # kFilterD: the filter combine's padded dimension
FILTER_SLOT = 992    # Lay<16>::slot: values of one padded element (rows of 20)


def filter_chunks(n):
    """The filter scan's chunk count for n elements (filter_plan of
    csrc/scan.cu): the least power of two >= ceil(n / FILTER_PER), at most
    FILTER_MAX_CHUNKS."""
    want, chunks = -(-n // FILTER_PER), 1
    while chunks < want and chunks < FILTER_MAX_CHUNKS:
        chunks *= 2
    return chunks


def chunked_scan_plain(op, elems, identity, chunks):
    """Inclusive scan of `elems` (a tuple of tensors with leading axis n)
    under the associative `op(left, right)`, in the kernel's order over
    `chunks` chunks. `identity` is the op's identity element (a tuple of
    unbatched tensors)."""
    n = elems[0].shape[0]
    S = -(-n // chunks)
    pad = chunks * S - n
    parts = tuple(
        torch.cat([z, e.expand((pad,) + e.shape)]).reshape((chunks, S) + z.shape[1:])
        for z, e in zip(elems, identity))

    # Pass 1: sequential prefixes within each chunk.
    prefixes = [tuple(z[:, 0] for z in parts)]
    for s in range(1, S):
        prefixes.append(op(prefixes[-1], tuple(z[:, s] for z in parts)))
    prefix = tuple(torch.stack(p, dim=1) for p in zip(*prefixes))
    if chunks == 1:
        return tuple(p[0, :n] for p in prefix)

    # Pass 2: Hillis-Steele over the chunk totals.
    tot = prefixes[-1]
    off = 1
    while off < chunks:
        comb = op(tuple(z[:-off] for z in tot), tuple(z[off:] for z in tot))
        tot = tuple(torch.cat([z[:off], c]) for z, c in zip(tot, comb))
        off *= 2

    # Pass 3: chunk c > 0 takes the inclusive total of the chunks before it.
    pre = tuple(z[:-1, None].expand(p[1:].shape) for z, p in zip(tot, prefix))
    applied = op(pre, tuple(p[1:] for p in prefix))
    return tuple(torch.cat([p[:1], a]).reshape((chunks * S,) + p.shape[2:])[:n]
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

    return chunked_scan_plain(filtering_operator, elems, _filter_identity(elems[1]),
                              filter_chunks(elems[1].shape[0]))


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
    if n:
        launch("filter_scan", b.dtype, n, d, *args, *out, *_filter_state(n, b), None)
        filter_scan.launches += 1
    return out


filter_scan.launches = 0


_HAND = {}  # (device, dtype) -> (hand-over words, state): the filter kernel's, kept


def _filter_state(n, b):
    """The filter kernel's hand-over buffer (a padded element as 64-bit words
    for each chunk at the start of each Hillis-Steele level and after the
    last) and its state (ticket, blocks done, epoch), for this device and
    dtype: zeros when made, kept from call to call (the kernel leaves the
    state ready for the next launch and tells this launch's words from older
    ones by the epoch), made larger when n needs more chunks. The kernel
    must not run twice at once on one device (it runs on the current
    stream, as every kernel of the port)."""
    chunks = filter_chunks(n)
    words = chunks.bit_length() * chunks * FILTER_SLOT * b.element_size() // 4
    key = (b.device, b.dtype)
    if key not in _HAND or _HAND[key][0].numel() < words:
        _HAND[key] = (torch.zeros(words, dtype=torch.int64, device=b.device),
                      torch.zeros(4, dtype=torch.int32, device=b.device))
    return _HAND[key]


def filter_scan_timeline(elems):
    """Diagnostics on the card: the filter scan once, with each block's
    clock64 at its phases; returns (outputs, stamps (chunks, levels + 4)
    int64, a block a chunk: start, after its chunk, after each level, after
    the hop for the chunks before it, at its end). Not counted in
    `filter_scan.launches`."""
    A, b, C, e, J = elems
    n, d = b.shape
    args = check_cuda_inputs("filter_scan", (A, b, C, e, J), b.dtype, MAX_DIM, (d,))
    out = tuple(torch.empty_like(z) for z in args)
    chunks = filter_chunks(n)
    stamps = torch.zeros(chunks, chunks.bit_length() + 3, dtype=torch.int64, device=b.device)
    launch("filter_scan", b.dtype, n, d, *args, *out, *_filter_state(n, b), stamps)
    return out, stamps


def combine_cycles(elems, threads, reps):
    """Diagnostics on the card: clock64 cycles of one filter combine on a
    team of `threads` (32, 64, 128 or 256), the mean over a chain of `reps`
    (l <- l (+) elems[1] from l = elems[0], each result the next one's
    input); returns (cycles, the last result)."""
    A, b, C, e, J = (z[:2].contiguous() for z in elems)
    d = b.shape[1]
    args = check_cuda_inputs("filter_combine_cycles", (A, b, C, e, J), b.dtype, MAX_DIM, (d,))
    out = tuple(torch.empty_like(z[:1]) for z in args)
    cycles = torch.zeros(1, dtype=torch.int64, device=b.device)
    launch("filter_combine_cycles", b.dtype, d, threads, reps, *args, *out, cycles)
    return float(cycles) / reps, out


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
        G, e = chunked_scan_plain(sampling_operator, (gains.flip(0), incs.flip(0)), identity,
                                  AFFINE_CHUNKS)
        return G.flip(0), e.flip(0)
    return chunked_scan_plain(sampling_operator, (gains, incs), identity, AFFINE_CHUNKS)


def affine_scan(gains, incs, reverse=False):
    """Inclusive scan of affine maps; see `affine_scan_plain`. gains (n, d, d),
    incs (n, d)."""
    if not _on_cuda("affine_scan", incs):
        return affine_scan_plain(gains, incs, reverse)
    n, d = incs.shape
    _check_shapes("affine_scan", "F", (gains,), n, d, d)
    G, e = check_cuda_inputs("affine_scan", (gains, incs), incs.dtype, MAX_DIM, (d,))
    oG, oe = torch.empty_like(G), torch.empty_like(e)
    scratch = torch.empty(2 * AFFINE_CHUNKS * (d * d + d), dtype=e.dtype, device=e.device)
    if n:
        launch("affine_scan", e.dtype, n, d, int(reverse), G, e, oG, oe, scratch)
        affine_scan.launches += 1
    return oG, oe


affine_scan.launches = 0
