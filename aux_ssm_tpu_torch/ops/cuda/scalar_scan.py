"""Scans of the batched scalar-filter layout: wrappers of `csrc/scalar_scan.cu`
with their plain PyTorch versions (counterpart of
`aux_ssm_tpu/ops/pallas/scalar_scan.py`).

B independent scalar filters run side by side: every array is (n, B), time
on axis 0, and a scan combines along time in each column. Kernel and plain
version share one chunk order, that of `filter_scan.chunked_scan_plain`
(CHUNKS = 128 contiguous chunks, each scanned sequentially, the chunk totals by
Hillis-Steele, then each chunk combined with the total of the chunks before
it), so they agree to rounding.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises. One scan is one kernel launch; each wrapper
counts its launches in its `launches` attribute. On the card a launch's
blocks hand chunk totals on through words in global memory with a {ticket,
blocks done, epoch} state that the kernel leaves ready for the next launch,
kept one set a scan, device, dtype and stream (`filter_scan.hand_state`).
"""
import torch

from ._build import check_cuda_inputs, launch
from .filter_scan import chunked_scan_plain, hand_state
from .kalman_fused import _on_cuda

CHUNKS = 128       # kChunks of csrc/scalar_scan.cu: time chunks of a column
COLS = 8           # kCols of csrc/scalar_scan.cu: columns of a split-path block
SPLIT_MIN_N = 512  # kSplitMinN of csrc/scalar_scan.cu


def filter_combine(left, right):
    """Scalar form of `ops.filtering.filtering_operator` on tuples
    (A, b, C, eta, J) of equal-shaped tensors: the inverse of I + C1 J2 is a
    reciprocal."""
    A1, b1, C1, e1, J1 = left
    A2, b2, C2, e2, J2 = right
    Z = 1.0 / (1.0 + C1 * J2)
    A2Z = A2 * Z
    ZA1 = Z * A1
    return (A2Z * A1, A2Z * (b1 + C1 * e2) + b2, A2Z * C1 * A2 + C2,
            ZA1 * (e2 - J2 * b1) + e1, ZA1 * J2 * A1 + J1)


def affine_combine(left, right):
    """Scalar affine composition: (g1, e1) then (g2, e2) -> (g2 g1, g2 e1 + e2)."""
    g1, e1 = left
    g2, e2 = right
    return g2 * g1, g2 * e1 + e2


def _identity(ref, values):
    """The identity element of a scan, one (B,) row for each array."""
    return tuple(ref.new_full(ref.shape[1:], v) for v in values)


def hand_words(B, values, elem):
    """64-bit words of a launch's hand-over buffer at B columns (scalar_scan.cu's
    scalar_hand_words): for every chunk of every column of each block's
    column group, a total of `values` values of `elem` bytes, each 32-bit
    half a word (beside the launch's epoch)."""
    return -(-B // COLS) * COLS * CHUNKS * values * (elem // 4)


def split_path(n, B, sms):
    """Whether a launch takes scalar_scan.cu's split path (scalar_segments >
    0): n >= SPLIT_MIN_N and fewer 8-column groups than SMs."""
    return n >= SPLIT_MIN_N and -(-B // COLS) < sms


def _hand(scan, n, B, values, ref):
    """The hand-over buffer and state of a launch on the split path; the
    whole-column path takes none (null pointers)."""
    if n < SPLIT_MIN_N or not split_path(
            n, B, torch.cuda.get_device_properties(ref.device).multi_processor_count):
        return None, None
    return hand_state(f"scalar_{scan}", hand_words(B, values, ref.element_size()), ref)


def _check(name, tensors):
    n_B = tuple(tensors[0].shape)
    if len(n_B) != 2:
        raise ValueError(f"{name}: expected (n, B) arrays, got shape {n_B}")
    for i, t in enumerate(tensors):
        if tuple(t.shape) != n_B:
            raise ValueError(f"{name}: argument {i} has shape {tuple(t.shape)}, expected {n_B}")
    return n_B


def scalar_filter_scan_plain(elems):
    """Inclusive scan over axis 0 of scalar filtering elements (A, b, C, eta,
    J), each (n, B), under `filter_combine`."""
    return chunked_scan_plain(filter_combine, tuple(elems),
                              _identity(elems[0], (1.0, 0.0, 0.0, 0.0, 0.0)), CHUNKS)


def scalar_filter_scan(elems):
    """Inclusive scan of scalar filtering elements; see
    `scalar_filter_scan_plain`. Equals the associative scan of
    `filtering_operator` on the (n, B, 1, 1) layout, squeezed."""
    elems = tuple(elems)
    n, B = _check("scalar_filter_scan", elems)
    if not (n and B):
        return tuple(torch.empty_like(z) for z in elems)
    if not _on_cuda("scalar_filter_scan", elems[0]):
        return scalar_filter_scan_plain(elems)
    args = check_cuda_inputs("scalar_filter_scan", elems, elems[0].dtype, 1, ())
    out = tuple(torch.empty_like(z) for z in args)
    launch("scalar_filter_scan", elems[0].dtype, n, B, *args, *out,
           *_hand("filter", n, B, 5, args[0]))
    scalar_filter_scan.launches += 1
    return out


scalar_filter_scan.launches = 0


def scalar_affine_scan_plain(gains, incs, reverse=False):
    """Inclusive scan over axis 0 of scalar affine maps (g, e), each (n, B),
    under `affine_combine`; `reverse=True` scans from the end, as
    `jax.lax.associative_scan(..., reverse=True)`."""
    identity = _identity(incs, (1.0, 0.0))
    if reverse:
        g, e = chunked_scan_plain(affine_combine, (gains.flip(0), incs.flip(0)), identity,
                                  CHUNKS)
        return g.flip(0), e.flip(0)
    return chunked_scan_plain(affine_combine, (gains, incs), identity, CHUNKS)


def scalar_affine_scan(gains, incs, reverse=False):
    """Inclusive scan of scalar affine maps; see `scalar_affine_scan_plain`.
    On the card a reverse scan indexes time backwards inside the kernel; no
    flipped copy is made."""
    n, B = _check("scalar_affine_scan", (gains, incs))
    if not (n and B):
        return torch.empty_like(gains), torch.empty_like(incs)
    if not _on_cuda("scalar_affine_scan", incs):
        return scalar_affine_scan_plain(gains, incs, reverse)
    g, e = check_cuda_inputs("scalar_affine_scan", (gains, incs), incs.dtype, 1, ())
    og, oe = torch.empty_like(g), torch.empty_like(e)
    launch("scalar_affine_scan", e.dtype, n, B, int(reverse), g, e, og, oe,
           *_hand("affine", n, B, 2, e))
    scalar_affine_scan.launches += 1
    return og, oe


scalar_affine_scan.launches = 0
