"""Chunked inclusive associative scans: wrappers of `csrc/scan.cu` with their
plain PyTorch versions (counterpart of `aux_ssm_tpu/ops/pallas/filter_scan.py`
and of `fused_affine_scan` in `aux_ssm_tpu/ops/pallas/kalman_fused.py`).

Both scans use one chunk order: the n elements are cut into C contiguous
chunks of ceil(n / C); each chunk is scanned sequentially, the chunk totals
by Hillis-Steele, and each chunk's elements are then combined with the total
of the chunks before it. C is a power of two taken from n (`scan_chunks`);
the plain versions run the same chunks in the same order, so kernel and
plain agree to rounding.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises. On the card each scan is one launch on the
current stream, of the instance (D = 16, 32, or 48 in float32) that d
selects: the chunks'
blocks hand their totals on through words in global memory, with a
{ticket, blocks done, epoch} state that the kernel leaves ready for the
next launch. The module keeps one buffer and state for
each scan, device, dtype and stream (`_hand_state`), so launches on one
stream follow each other and launches on two streams never share a state.
One rule remains: a CUDA graph captured around a scan holds that stream's
state, so it must not be replayed on two streams at once. Each wrapper counts
its calls into the kernel library in its `launches` attribute.

Chain axis: elements laid out (n, C, ...) (b (n, C, d)) are C independent
chains' scans, each over axis 0 in the one-chain chunk order, in one launch
(C x chunks blocks, their own hand-over rows: the buffer is C times a
chain's). Chain c of a C-chain launch is bit-equal to a one-chain launch on
its elements; the plain versions run the same chunks, batched over C.
"""
import torch

from ._build import check_cuda_inputs, instance_dim, launch, max_dim
from .kalman_fused import _check_shapes, _on_cuda

# Values of one padded element (scan.cu's OpLay<Op>::slot, rows of D + 4) at
# each instance's D: the filter's A, C, J and b, eta; the affine scan's G and e.
SLOTS = {"filter": {16: 992, 32: 3520, 48: 7584}, "affine": {16: 336, 32: 1184, 48: 2544}}
CHUNK_PER, MAX_CHUNKS = 4, 128  # the elements a chunk aims at; chunks at most (a block an SM)


def scan_chunks(n):
    """Both scans' chunk count for n elements, as scan.cu's `scan_plan`
    takes it: the least power of two >= ceil(n / CHUNK_PER), at most
    MAX_CHUNKS."""
    want, chunks = -(-n // CHUNK_PER), 1
    while chunks < want and chunks < MAX_CHUNKS:
        chunks *= 2
    return chunks


def chunked_scan_plain(op, elems, identity, chunks):
    """Inclusive scan of `elems` (a tuple of tensors with leading axis n)
    under the associative `op(left, right)`, in the kernel's order over
    `chunks` chunks. `identity` is the op's identity element (a tuple of
    unbatched tensors, broadcast to the elements' trailing shape: a chain
    axis after n scans each chain on its own)."""
    n = elems[0].shape[0]
    S = -(-n // chunks)
    pad = chunks * S - n
    parts = tuple(
        torch.cat([z, e.expand((pad,) + z.shape[1:])]).reshape((chunks, S) + z.shape[1:])
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
                              scan_chunks(elems[1].shape[0]))


def _scan_io(name, kinds, elems):
    """A scan's (n, chains, d), its elements checked for the card (no chain
    axis: (n, d, d) / (n, d); a chain axis: (n, C, d, d) / (n, C, d)) and its
    outputs, empty."""
    ref = elems[kinds.index("x")]
    n, d = ref.shape[0], ref.shape[-1]
    chains = None if ref.dim() == 2 else ref.shape[1]
    _check_shapes(name, kinds, elems, n, d, d, chains)
    args = check_cuda_inputs(name, elems, ref.dtype, max_dim(ref.dtype), (d,))
    return (n, chains or 1, d), args, tuple(torch.empty_like(z) for z in args)


def filter_scan(elems):
    """Inclusive scan of filtering elements; see `filter_scan_plain`.
    `elems = (A, b, C, eta, J)` with shapes (n, d, d) / (n, d), or (n, C, d,
    d) / (n, C, d) for C chains."""
    b = elems[1]
    if not _on_cuda("filter_scan", b):
        return filter_scan_plain(elems)
    (n, chains, d), args, out = _scan_io("filter_scan", "FxFxF", elems)
    if n:
        launch("filter_scan", b.dtype, n, chains, d, *args, *out,
               *_hand_state("filter", n, b, chains), None)
        filter_scan.launches += 1
    return out


filter_scan.launches = 0


_HAND = {}  # (scan, device, dtype, stream) -> (hand-over words, state), kept


def _hand_state(scan, n, ref, chains=1):
    """The hand-over buffer of `scan` ("filter" or "affine": a padded
    element of the instance that takes `ref`'s last dimension d, as 64-bit
    words, for each of n elements' chunks at the start of each Hillis-Steele
    level and after the last, for each of `chains` chains) and its state
    (ticket, blocks done, epoch) for the device and dtype of `ref` and the
    current stream; see `hand_state`."""
    chunks = scan_chunks(n)
    slot = SLOTS[scan][instance_dim(ref.shape[-1], ref.dtype)]
    words = chunks.bit_length() * chunks * slot * ref.element_size() // 4
    return hand_state(scan, chains * words, ref)


def hand_state(scan, words, ref):
    """A scan's hand-over buffer of at least `words` 64-bit words and its state
    (ticket, blocks done, epoch) for the device and dtype of `ref` and the
    current stream, allocated on that stream: zeros when made, kept from call
    to call (the kernel leaves the state ready for the next launch and tells
    this launch's words from older ones by the epoch), made larger when a
    launch needs more. Launches on one stream run one after the other, so
    they never share a state in flight; a CUDA graph captured around the scan
    keeps the capturing stream's state and must not be replayed on two
    streams at once. (A CPU `ref`, which only a launch mocked in a test
    gives, keys no stream.)"""
    stream = torch.cuda.current_stream(ref.device).cuda_stream if ref.is_cuda else None
    key = (scan, ref.device, ref.dtype, stream)
    if key not in _HAND or _HAND[key][0].numel() < words:
        _HAND[key] = (torch.zeros(words, dtype=torch.int64, device=ref.device),
                      torch.zeros(4, dtype=torch.int32, device=ref.device))
    return _HAND[key]


def filter_scan_timeline(elems):
    """Diagnostics on the card: the filter scan once, with each block's
    clock64 at its phases; returns (outputs, stamps (chunks, levels + 4)
    int64, a block a chunk: start, after its chunk, after each level, after
    the hop for the chunks before it, at its end; C chains: (C chunks, ...),
    chain after chain). Not counted in `filter_scan.launches`."""
    b = elems[1]
    (n, chains, d), args, out = _scan_io("filter_scan", "FxFxF", elems)
    chunks = scan_chunks(n)
    stamps = torch.zeros(chains * chunks, chunks.bit_length() + 3, dtype=torch.int64,
                         device=b.device)
    launch("filter_scan", b.dtype, n, chains, d, *args, *out,
           *_hand_state("filter", n, b, chains), stamps)
    return out, stamps


def combine_cycles(elems, threads, reps, scan="filter"):
    """Diagnostics on the card: clock64 cycles of one combine of `scan`
    ("filter": elems = (A, b, C, eta, J); "affine": elems = (G, e)) on a
    team of `threads` (32, 64, 128 or 256 as scan.cu's `combine_cycles_on`
    takes them: at D = 48 the filter's on 256 alone), the mean over a chain of `reps`
    (l <- l (+) elems[1] from l = elems[0], each result the next one's
    input); returns (cycles, the last result)."""
    args = tuple(z[:2].contiguous() for z in elems)
    d = args[1].shape[1]
    args = check_cuda_inputs(f"{scan}_combine_cycles", args, args[1].dtype,
                             max_dim(args[1].dtype), (d,))
    out = tuple(torch.empty_like(z[:1]) for z in args)
    cycles = torch.zeros(1, dtype=torch.int64, device=args[1].device)
    launch(f"{scan}_combine_cycles", args[1].dtype, d, threads, reps, *args, *out, cycles)
    return float(cycles) / reps, out


# --------------------------------------------------------------------------
# Affine scan (fused_affine_scan)
# --------------------------------------------------------------------------

def affine_scan_plain(gains, incs, reverse=False):
    """Inclusive scan of affine maps (G, e) under
    `ops.sampling.sampling_operator` over the kernel's chunks
    (`scan_chunks(n)`) along axis 0 (each chain on its own where a chain
    axis follows); `reverse=True` scans from the end, as
    `jax.lax.associative_scan(..., reverse=True)`."""
    from ..sampling import sampling_operator  # sampling imports this module

    d = incs.shape[-1]
    chunks = scan_chunks(incs.shape[0])
    identity = (torch.eye(d, dtype=incs.dtype, device=incs.device), incs.new_zeros(d))
    if reverse:
        G, e = chunked_scan_plain(sampling_operator, (gains.flip(0), incs.flip(0)), identity,
                                  chunks)
        return G.flip(0), e.flip(0)
    return chunked_scan_plain(sampling_operator, (gains, incs), identity, chunks)


def affine_scan(gains, incs, reverse=False):
    """Inclusive scan of affine maps; see `affine_scan_plain`. gains (n, d, d),
    incs (n, d), or (n, C, d, d), (n, C, d) for C chains."""
    if not _on_cuda("affine_scan", incs):
        return affine_scan_plain(gains, incs, reverse)
    (n, chains, d), args, out = _scan_io("affine_scan", "Fx", (gains, incs))
    if n:
        launch("affine_scan", incs.dtype, n, chains, d, int(reverse), *args, *out,
               *_hand_state("affine", n, incs, chains), None)
        affine_scan.launches += 1
    return out


affine_scan.launches = 0


def affine_scan_timeline(gains, incs, reverse):
    """Diagnostics on the card: the affine scan once with each block's
    clock64 at its phases, as `filter_scan_timeline`; returns (outputs,
    stamps (C chunks, levels + 4) int64). Not counted in
    `affine_scan.launches`."""
    (n, chains, d), args, out = _scan_io("affine_scan", "Fx", (gains, incs))
    chunks = scan_chunks(n)
    stamps = torch.zeros(chains * chunks, chunks.bit_length() + 3, dtype=torch.int64,
                         device=incs.device)
    launch("affine_scan", incs.dtype, n, chains, d, int(reverse), *args, *out,
           *_hand_state("affine", n, incs, chains), stamps)
    return out, stamps
