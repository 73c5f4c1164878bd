"""The spatial model's banded grid precision, in NumPy
(counterpart of `aux_ssm_tpu/native/precision.py`; the C++ routine of the JAX
package is not carried over: the vectorised NumPy form gives the same
entries and runs once per model).
"""
import numpy as np


def make_precision_coo(tau, r_y, d):
    """(data, rows, cols) of the d^2 x d^2 banded precision with entries
    tau^D for Manhattan distance D <= r_y on the d x d grid."""
    idx = np.arange(d * d)
    ii, jj = idx // d, idx % d
    D = np.abs(ii[:, None] - ii[None, :]) + np.abs(jj[:, None] - jj[None, :])
    rows, cols = np.nonzero(D <= r_y)
    data = np.power(float(tau), D[rows, cols].astype(np.float64))
    return data, rows.astype(np.int64), cols.astype(np.int64)


def make_precision_dense(tau, r_y, d, dtype=np.float64):
    """Dense d^2 x d^2 precision matrix (for moderate d)."""
    data, rows, cols = make_precision_coo(tau, r_y, d)
    out = np.zeros((d * d, d * d), dtype=dtype)
    out[rows, cols] = data
    return out


def precision_stencil(tau, r_y, dtype=np.float64):
    """The (2r+1) x (2r+1) convolution stencil equivalent to the precision:
    applying the precision to a grid-shaped field is a 2-D convolution with
    this kernel; zero padding matches the matrix exactly, since out-of-grid
    entries are absent from it."""
    r = int(r_y)
    di = np.abs(np.arange(-r, r + 1))
    D = di[:, None] + di[None, :]
    stencil = np.power(float(tau), D.astype(np.float64))
    stencil[D > r_y] = 0.0
    return stencil.astype(dtype)


def precision_rows(dense):
    """The row lists (ELL rows) of a square matrix: values (d, W) and column
    indices (d, W), each row's nonzeros in ascending column order, padded
    with zeros (at the row's own column) to the widest row W. Summed in
    column order, a row's products give the dense row's sum bit for bit for
    finite vectors: a zero product adds nothing."""
    dense = np.asarray(dense)
    d = dense.shape[0]
    nz = dense != 0
    width = max(1, int(nz.sum(1).max()))
    vals = np.zeros((d, width), dtype=dense.dtype)
    cols = np.repeat(np.arange(d)[:, None], width, 1)
    for i in range(d):
        (c,) = np.nonzero(nz[i])
        vals[i, :len(c)] = dense[i, c]
        cols[i, :len(c)] = c
    return vals, cols
