// Small dense matrix algebra shared by the lanes of one warp: the Hopper
// counterpart of the lane-major row lists in aux_ssm_tpu/ops/pallas/lanelin.py.
//
// A (p, q) matrix is a row-major array with leading dimension q, in the
// warp's shared-memory scratch or straight in global memory. Dimensions are
// runtime values bounded by the caller's compile-time MD.
//
// Every function is warp-collective: lane `lane` of `nl` lanes computes the
// outputs lane, lane + nl, ..., and the function ends with AUX_SYNC(), so its
// results are visible to all lanes when it returns. Each output is computed by
// one lane in a fixed order, so the result does not depend on nl: built as
// host code with nl = 1 and an empty AUX_SYNC, the same functions give the
// same numbers (this is how the CPU tests check the kernels' arithmetic).
// Outputs never alias inputs unless a function says so.
//
// On the card a d x d operand at d = 16 is 1 KB (f32); a warp's working set
// sits in shared memory, and a matrix product costs each lane d^3 / 32 FMAs
// on conflict-free shared loads.
#pragma once

#include <math.h>

#ifndef AUX_HD
#define AUX_HD __device__ __forceinline__
#endif
#ifndef AUX_SYNC
#define AUX_SYNC() __syncwarp()
#endif

namespace smallmat {

template <typename S>
AUX_HD S nan_to_num(S x) {
  // jnp.nan_to_num: NaN -> 0, +-inf -> +-max of the type (by selects, no
  // branch).
  const S big = sizeof(S) == 4 ? (S)3.4028234663852886e38 : (S)1.7976931348623157e308;
  const S clamped = x > big ? big : (x < -big ? -big : x);
  return isnan(x) ? (S)0 : clamped;
}

template <typename S>
AUX_HD S finite_or_zero(S x) {
  return isfinite(x) ? x : (S)0;
}

template <typename S>
AUX_HD void copy(int lane, int nl, int n, const S* X, S* out) {
  for (int e = lane; e < n; e += nl) out[e] = X[e];
  AUX_SYNC();
}

// out (p, r) = X (p, q) @ Y (q, r)
template <typename S>
AUX_HD void mm(int lane, int nl, int p, int q, int r, const S* X, const S* Y, S* out) {
  for (int e = lane; e < p * r; e += nl) {
    const int i = e / r, j = e % r;
    S acc = (S)0;
    for (int k = 0; k < q; ++k) acc += X[i * q + k] * Y[k * r + j];
    out[e] = acc;
  }
  AUX_SYNC();
}

// out (p, r) = X (p, q) @ Y^T, with Y stored (r, q)
template <typename S>
AUX_HD void mm_nt(int lane, int nl, int p, int q, int r, const S* X, const S* Y, S* out) {
  for (int e = lane; e < p * r; e += nl) {
    const int i = e / r, j = e % r;
    S acc = (S)0;
    for (int k = 0; k < q; ++k) acc += X[i * q + k] * Y[j * q + k];
    out[e] = acc;
  }
  AUX_SYNC();
}

// out (p,) = X (p, q) @ v (q,)
template <typename S>
AUX_HD void mv(int lane, int nl, int p, int q, const S* X, const S* v, S* out) {
  for (int i = lane; i < p; i += nl) {
    S acc = (S)0;
    for (int k = 0; k < q; ++k) acc += X[i * q + k] * v[k];
    out[i] = acc;
  }
  AUX_SYNC();
}

// X <- (X + X^T) / 2, in place; one lane owns each pair (i, j), i < j.
template <typename S>
AUX_HD void sym(int lane, int nl, int d, S* X) {
  for (int e = lane; e < d * d; e += nl) {
    const int i = e / d, j = e % d;
    if (i < j) {
      const S s = (S)0.5 * (X[i * d + j] + X[j * d + i]);
      X[i * d + j] = s;
      X[j * d + i] = s;
    }
  }
  AUX_SYNC();
}

// Lower Cholesky factor L of an SPD M (d, d); zeros above the diagonal.
// Returns sum(log diag L) in every lane. A non-SPD M gives NaN entries, as
// sqrt does.
template <typename S>
AUX_HD S chol(int lane, int nl, int d, const S* M, S* L) {
  S log_det = (S)0;
  for (int j = 0; j < d; ++j) {
    S acc = M[j * d + j];
    for (int k = 0; k < j; ++k) acc -= L[j * d + k] * L[j * d + k];
    const S diag = sqrt(acc);  // every lane, from columns already synced
    log_det += log(diag);
    if (lane == 0) L[j * d + j] = diag;
    for (int i = j + 1 + lane; i < d; i += nl) {
      S a = M[i * d + j];
      for (int k = 0; k < j; ++k) a -= L[i * d + k] * L[j * d + k];
      L[i * d + j] = a / diag;
      L[j * d + i] = (S)0;
    }
    AUX_SYNC();
  }
  return log_det;
}

// X (d, r) = L^{-1} B, L lower (d, d); one lane per column. X may alias B.
template <typename S>
AUX_HD void tri_solve_lower(int lane, int nl, int d, int r, const S* L, const S* B, S* X) {
  for (int j = lane; j < r; j += nl)
    for (int i = 0; i < d; ++i) {
      S acc = B[i * r + j];
      for (int k = 0; k < i; ++k) acc -= L[i * d + k] * X[k * r + j];
      X[i * r + j] = acc / L[i * d + i];
    }
  AUX_SYNC();
}

// X (d, r) = L^{-T} B, L lower (d, d); one lane per column. X may alias B.
template <typename S>
AUX_HD void tri_solve_lower_T(int lane, int nl, int d, int r, const S* L, const S* B, S* X) {
  for (int j = lane; j < r; j += nl)
    for (int i = d - 1; i >= 0; --i) {
      S acc = B[i * r + j];
      for (int k = i + 1; k < d; ++k) acc -= L[k * d + i] * X[k * r + j];
      X[i * r + j] = acc / L[i * d + i];
    }
  AUX_SYNC();
}

// X (d, r) = S^{-1} B for SPD S (d, d), through its Cholesky factor L
// (scratch, (d, d)). Returns sum(log diag L). X may alias B.
template <typename S>
AUX_HD S spd_solve(int lane, int nl, int d, int r, const S* Sm, const S* B, S* L, S* X) {
  const S log_det = chol(lane, nl, d, Sm, L);
  tri_solve_lower(lane, nl, d, r, L, B, X);
  tri_solve_lower_T(lane, nl, d, r, L, X, X);
  return log_det;
}

}  // namespace smallmat
