// Small dense products at a compile-time dimension D, shared by a team of NT
// threads, on operands in shared memory with padded rows: the building blocks
// of the scans' combines (scan.cu) and of the filtering elements
// (kalman_fused.cu).
//
// A D x D operand is stored at row stride kLd<D> = D + 4: rows 16-byte
// aligned for vector loads, and a column's entries in distinct banks but for
// pairs of rows 8 apart. A dimension d < D is padded exactly by the caller
// (zeros, or the identity's ones on a diagonal), so no index is divided at
// run time and every loop unrolls. Thread t of the team owns a tile of each
// D x D result (Tile), computes it in registers and stores it where the next
// product reads it; each entry is summed over k ascending, so a result does
// not depend on NT. Built as host C++ (NT = 1, no barriers), the same code
// runs in the CPU tests.
#pragma once

#include <math.h>
#include <string.h>

#ifndef AUX_HD
#define AUX_HD __device__ __forceinline__
#endif

namespace tiles {

template <int D>
constexpr int kLd = D + 4;

// jnp.nan_to_num: NaN -> 0, +-inf -> +-max of the type (by selects, no
// branch).
template <typename S>
AUX_HD S nan_to_num(S x) {
  const S big = sizeof(S) == 4 ? (S)3.4028234663852886e38 : (S)1.7976931348623157e308;
  const S clamped = x > big ? big : (x < -big ? -big : x);
  return isnan(x) ? (S)0 : clamped;
}

template <typename S>
AUX_HD S finite_or_zero(S x) {
  return isfinite(x) ? x : (S)0;
}

// The columns of a tile of E entries: the least c whose square is at least E
// such that c divides D and E, and E / c divides D (at D = 16 and 32, where
// every such c is a power of two: 2 x 4 tiles of 8, 2 x 2 of 4, 1 x 2 of 2;
// at D = 48: 3 x 6 of 18, 4 x 6 of 24, 3 x 3 of 9, 6 x 6 of 36).
constexpr int tile_cols(int E, int D) {
  int c = 1;
  while (c < D && (c * c < E || D % c != 0 || E % c != 0 || D % (E / c) != 0)) ++c;
  return c;
}

// Thread t of a team of NT owns rows [r0, r0 + RPT) x columns [c0, c0 + CPT)
// of each D x D result: E = D^2 / NT entries in as square a tile as D's
// divisors allow, since a product's shared-memory reads are D (RPT + CPT) a
// thread for its E entries (at D = 16: 2 x 4 on 32 threads, 1 x 2 on 128;
// at D = 48: 3 x 6 on 128, 4 x 6 on 96; everything in the host build's one
// thread).
template <int D, int NT>
struct Tile {
  static constexpr int E = D * D / NT, CPT = tile_cols(E, D), RPT = E / CPT;
  static_assert(E * NT == D * D && RPT * CPT == E && D % CPT == 0, "NT divides D^2");
  int r0, c0;
  AUX_HD explicit Tile(int t) : r0(t / (D / CPT) * RPT), c0(t % (D / CPT) * CPT) {}
  AUX_HD bool first() const { return c0 == 0; }       // owns column 0 of its rows
  AUX_HD bool last() const { return c0 + CPT == D; }  // owns column D - 1
};

template <typename S, int D, int NT>
using Regs = S[Tile<D, NT>::RPT][Tile<D, NT>::CPT];

// A team barrier: a warp (NT = 32), or named barrier `id` of NT threads (id 0
// with NT the block's size is __syncthreads). The host build has one thread
// and no barrier.
template <int NT>
AUX_HD void team_sync(int id) {
#ifdef __CUDA_ARCH__
  if constexpr (NT == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NT) : "memory");
  }
#else
  (void)id;
#endif
}

// v = p[0 .. N): on the card by 16- or 8-byte vector loads where N allows
// (p aligned to them: padded rows are 16-byte aligned, and a tile's column
// offset is a multiple of its width).
template <typename S, int N>
AUX_HD void load_run(const S* p, S (&v)[N]) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(S) == 4 && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
    return;
  } else if constexpr (sizeof(S) == 4 && N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = reinterpret_cast<const float2*>(p)[i];
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
    return;
  } else if constexpr (sizeof(S) == 8 && N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const double2 f = reinterpret_cast<const double2*>(p)[i];
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
    return;
  }
#endif
  for (int i = 0; i < N; ++i) v[i] = p[i];
}

// p[0 .. N) = v: on the card by 16- or 8-byte vector stores as far as N
// allows (p aligned to them, as for load_run), the rest one by one.
template <typename S, int N>
AUX_HD void store_run(S* p, const S (&v)[N]) {
#ifdef __CUDA_ARCH__
  constexpr int W = 16 / sizeof(S), V = N / W * W;  // values a vector, values stored by vectors
#pragma unroll
  for (int i = 0; i < V; i += W) {
    if constexpr (W == 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    else
      *reinterpret_cast<double2*>(p + i) = make_double2(v[i], v[i + 1]);
  }
#else
  constexpr int V = 0;
#endif
#pragma unroll
  for (int i = V; i < N; ++i) p[i] = v[i];
}

// acc(i, j) = sum_k X(i, k) Y(k, j) over the thread's tile, k ascending, with
// X(i, k) = X[i ld + k] or, if TX, X[k ld + i], and Y(k, j) = Y[k ld + j] or,
// if TY, Y[j ld + k]. Rows of X (and, if TY, of Y) are read four k at a time,
// a row of Y otherwise a tile's width at a time.
template <typename S, int D, int NT, bool TX, bool TY>
AUX_HD void tile_mm(const Tile<D, NT>& tl, const S* X, const S* Y, Regs<S, D, NT>& acc) {
  constexpr int ld = kLd<D>, R = Tile<D, NT>::RPT, Cn = Tile<D, NT>::CPT;
  static_assert(D % 4 == 0, "rows read four at a time");
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < Cn; ++c) acc[r][c] = (S)0;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 4) {
    S x[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (TX) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) x[r][kk] = X[(k0 + kk) * ld + tl.r0 + r];
      } else {
        load_run<S, 4>(X + (tl.r0 + r) * ld + k0, x[r]);
      }
    }
    if (TY) {
      S y[Cn][4];
#pragma unroll
      for (int c = 0; c < Cn; ++c) load_run<S, 4>(Y + (tl.c0 + c) * ld + k0, y[c]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < Cn; ++c) acc[r][c] += x[r][kk] * y[c][kk];
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        S y[Cn];
        load_run<S, Cn>(Y + (k0 + kk) * ld + tl.c0, y);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < Cn; ++c) acc[r][c] += x[r][kk] * y[c];
      }
    }
  }
}

// The thread's tile into a padded D x D array.
template <typename S, int D, int NT>
AUX_HD void tile_store(const Tile<D, NT>& tl, const Regs<S, D, NT>& v, S* X) {
#pragma unroll
  for (int r = 0; r < Tile<D, NT>::RPT; ++r)
#pragma unroll
    for (int c = 0; c < Tile<D, NT>::CPT; ++c) X[(tl.r0 + r) * kLd<D> + tl.c0 + c] = v[r][c];
}

// The thread's tile of a padded D x D array.
template <typename S, int D, int NT>
AUX_HD void tile_load(const Tile<D, NT>& tl, const S* X, Regs<S, D, NT>& v) {
#pragma unroll
  for (int r = 0; r < Tile<D, NT>::RPT; ++r)
    load_run<S, Tile<D, NT>::CPT>(X + (tl.r0 + r) * kLd<D> + tl.c0, v[r]);
}

// v(i, j) = (X(i, j) + X(j, i)) / 2 over the thread's tile of a padded X.
template <typename S, int D, int NT>
AUX_HD void sym_tile(const Tile<D, NT>& tl, const S* X, Regs<S, D, NT>& v) {
#pragma unroll
  for (int r = 0; r < Tile<D, NT>::RPT; ++r)
#pragma unroll
    for (int c = 0; c < Tile<D, NT>::CPT; ++c) {
      const int i = tl.r0 + r, j = tl.c0 + c;
      v[r][c] = (S)0.5 * (X[i * kLd<D> + j] + X[j * kLd<D> + i]);
    }
}

// sum_k X(i, k) v[k], X(i, k) = X[i ld + k] or, if TX, X[k ld + i].
template <typename S, int D, bool TX>
AUX_HD S row_dot(const S* X, const S* v, int i) {
  constexpr int ld = kLd<D>;
  S acc = (S)0;
#pragma unroll
  for (int k = 0; k < D; ++k) acc += (TX ? X[k * ld + i] : X[i * ld + k]) * v[k];
  return acc;
}

// 1 / x for a pivot block's determinant: in float on the card the SFU's
// approximation and one Newton step (within an ulp or two; off the IEEE
// division's longer path), else the division.
template <typename S>
AUX_HD S pivot_rcp(S x) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(S) == 4) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"((float)x));
    return fmaf(r, fmaf(-(float)x, r, 1.0f), r);
  }
#endif
  return (S)1 / x;
}

// The power of two 2^-e for the binade [2^e, 2^(e+1)) of |x|: multiplying by
// it is exact (no rounding), and it takes x to [1, 2). Zero and subnormal x
// give 2^126 (float) or 2^1022 (double), inf and NaN 2^-126 or 2^-1022: all
// normal numbers.
AUX_HD float binade_scale(float x) {
  unsigned u;
  memcpy(&u, &x, sizeof u);
  unsigned e = (u >> 23) & 0xffu;
  e = e < 1u ? 1u : e > 253u ? 253u : e;
  u = (254u - e) << 23;
  memcpy(&x, &u, sizeof x);
  return x;
}
AUX_HD double binade_scale(double x) {
  unsigned long long u;
  memcpy(&u, &x, sizeof u);
  unsigned long long e = (u >> 52) & 0x7ffull;
  e = e < 1ull ? 1ull : e > 2045ull ? 2045ull : e;
  u = (2046ull - e) << 52;
  memcpy(&x, &u, sizeof x);
  return x;
}

// Gauss-Jordan on the team: z <- M^{-1} z, for the thread's tiles m of M and
// z of the right-hand side in registers, without row exchanges (M SPD, or
// similar to I + SPD), by 2 x 2 pivot blocks. Each pair's columns of M and
// rows of M and z go to double-buffered arrays (col, rowm, rowz: 4 D each),
// from which every thread inverts the pair's block; one team barrier a pair.
// The block is scaled by the power of two that takes its larger diagonal
// entry to [1, 2) before its determinant is taken, and its inverse scaled
// back: exact, so the inverse is the unscaled formula's bit for bit where
// that one does not overflow, and the determinant's product of two diagonal
// entries cannot overflow where they exceed the square root of the type's
// largest value (an observation variance of delta / 2 = 5e19 in float32).
// The caller publishes the first pair (gj_publish_first) and syncs the team;
// the result goes to the padded array Z (the last pair's barrier included).
template <typename S, int D, int NT>
AUX_HD void gj_publish_first(const Tile<D, NT>& tl, const Regs<S, D, NT>& m,
                             const Regs<S, D, NT>& z, S* col, S* rowm, S* rowz) {
#pragma unroll
  for (int rr = 0; rr < Tile<D, NT>::RPT; ++rr) {
    const int i = tl.r0 + rr;
#pragma unroll
    for (int c = 0; c < Tile<D, NT>::CPT; ++c) {
      const int j = tl.c0 + c;
      if (j < 2) col[j * D + i] = m[rr][c];
      if (i < 2) {
        rowm[i * D + j] = m[rr][c];
        rowz[i * D + j] = z[rr][c];
      }
    }
  }
}

template <typename S, int D, int NT>
AUX_HD void gj_solve(const Tile<D, NT>& tl, int bar, Regs<S, D, NT>& m, Regs<S, D, NT>& z,
                     S* col, S* rowm, S* rowz, S* Z) {
  constexpr int R = Tile<D, NT>::RPT, Cn = Tile<D, NT>::CPT;
#pragma unroll
  for (int k = 0; k < D; k += 2) {
    const int p = (k >> 1) & 1, q = p ^ 1;
    const S *cb = col + 2 * p * D, *rmb = rowm + 2 * p * D, *rzb = rowz + 2 * p * D;
    const S d0 = rmb[k] < (S)0 ? -rmb[k] : rmb[k];
    const S d1 = rmb[D + k + 1] < (S)0 ? -rmb[D + k + 1] : rmb[D + k + 1];
    const S sc = binade_scale(d0 > d1 ? d0 : d1);
    const S b00 = rmb[k] * sc, b01 = rmb[k + 1] * sc, b10 = rmb[D + k] * sc,
            b11 = rmb[D + k + 1] * sc;
    const S r = pivot_rcp(b00 * b11 - b01 * b10) * sc;
    const S i00 = b11 * r, i01 = -b01 * r, i10 = -b10 * r, i11 = b00 * r;
    S m0[Cn], m1[Cn], z0[Cn], z1[Cn];  // the pair's rows, scaled by the block's inverse
#pragma unroll
    for (int c = 0; c < Cn; ++c) {
      const int j = tl.c0 + c;
      m0[c] = i00 * rmb[j] + i01 * rmb[D + j];
      m1[c] = i10 * rmb[j] + i11 * rmb[D + j];
      z0[c] = i00 * rzb[j] + i01 * rzb[D + j];
      z1[c] = i10 * rzb[j] + i11 * rzb[D + j];
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int i = tl.r0 + rr;
      const S c0 = cb[i], c1 = cb[D + i];
#pragma unroll
      for (int c = 0; c < Cn; ++c) {
        const int j = tl.c0 + c;
        if (i == k) {
          m[rr][c] = m0[c];
          z[rr][c] = z0[c];
        } else if (i == k + 1) {
          m[rr][c] = m1[c];
          z[rr][c] = z1[c];
        } else {
          m[rr][c] = m[rr][c] - c0 * m0[c] - c1 * m1[c];
          z[rr][c] = z[rr][c] - c0 * z0[c] - c1 * z1[c];
        }
        if (k + 2 < D) {
          if (j == k + 2 || j == k + 3) col[(2 * q + j - k - 2) * D + i] = m[rr][c];
          if (i == k + 2 || i == k + 3) {
            rowm[(2 * q + i - k - 2) * D + j] = m[rr][c];
            rowz[(2 * q + i - k - 2) * D + j] = z[rr][c];
          }
        } else {
          Z[i * kLd<D> + j] = z[rr][c];
        }
      }
    }
    team_sync<NT>(bar);
  }
}

// One value from global to shared memory without waiting (cp.async; the
// caller waits with cp_async_wait_all); the host build copies at once.
template <typename S>
AUX_HD void copy_one(S* dst, const S* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(sizeof(S))
               : "memory");
#else
  *dst = *src;
#endif
}

// Diagnostics: thread 0 of a team writes the SM's clock to st[i], if st is
// not null (the host build has no clock).
AUX_HD void stamp(long long* st, int t, int i) {
#ifdef __CUDA_ARCH__
  if (st && t == 0) st[i] = clock64();
#else
  (void)st, (void)t, (void)i;
#endif
}

AUX_HD void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

}  // namespace tiles
