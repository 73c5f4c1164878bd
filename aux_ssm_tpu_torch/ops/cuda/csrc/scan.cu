// Inclusive associative scans of the auxiliary-Kalman MH step. They replace
// the Pallas scans of aux_ssm_tpu/ops/pallas/:
//
//   filter scan   <- filter_scan.fused_filter_scan (_chunked_scan_kernel, and
//                    _scan_kernel below T = 512: one kernel serves all T)
//   AffineOp scan <- kalman_fused.fused_affine_scan (_affine_scan_kernel), with
//                    an index-reversed variant for reverse=True
//
// The TPU kernels carry a prefix from one grid step to the next in VMEM
// scratch. Blocks on Hopper run in no order, so nothing carries between
// blocks by itself; both scans cut the n elements into chunks, scan each
// chunk sequentially, scan the chunk totals by Hillis-Steele and combine each
// chunk's elements with the total of the chunks before it. The plain twins in
// ops/cuda/filter_scan.py run the same chunks in the same order.
//
// The filter scan: one launch. What bounds it is the dependent chain of
// combines (at T = 1024 the inputs are ~6.5 MB, ~2 us of the card's memory
// rate), so the design shortens the chain and makes each combine cheap:
//  - A combine is about 11 d x d products and a Gauss-Jordan inverse. It
//    runs at a compile-time dimension D = kFilterD (d <= D is padded
//    exactly: A -> diag(A, I), C and J -> diag(., 0), b and eta -> 0; then
//    I + C1 J2 = diag(I + C1 J2, I) and every product keeps the padding, the
//    extra terms adding exact zeros), so no index is divided at run time and
//    every loop unrolls. A team of NT threads shares it, thread t owning the
//    entries [t E, t E + E) of each D x D result (E = D^2 / NT) and
//    computing each from its row and column in shared memory (rows 16-byte
//    aligned, read by vector loads); the symmetric results are computed in
//    both orders by the owner of each entry, so no barrier waits for a
//    transpose. The inverse keeps the thread's entries of M and Z in
//    registers and eliminates by 2 x 2 pivot blocks, each block's rows and
//    columns published to double-buffered arrays: one team barrier a pair
//    of pivots, 11 a combine. 128 threads a team beat 32, 64 and 256
//    (kernel_times.py's combine cycles).
//  - The chain (C chunks of S elements, filter_plan: 128 of 8 at T = 1024,
//    128 of 3 at T = 300): S - 1 combines within the chunk on the block's
//    chain team (128 threads), the next element's values loaded into
//    registers while a combine runs and its prefixes kept in shared memory
//    for the apply; log2(C) Hillis-Steele levels over the chunk totals,
//    block c taking the level's value of block c - 2^L from global memory;
//    one hop for the total of the chunks before c; then the chunk's S
//    combines, which do not depend on each other, at once on the block's 8
//    warps (or 4 teams of 64 when S <= 4). A hand-over is a slot of 64-bit
//    words, each a half-value beside the launch's epoch, written whole and
//    read until the epoch shows: one trip through L2, no fence or flag. A
//    block takes its chunk from a ticket (an atomic counter), so it waits
//    only on blocks that started before it and the launch needs no
//    co-residency; a block an SM, since two combines on one SM take twice
//    as long (its issue rate, not latency, sets a combine's time). Every
//    output is written to global memory once, off the chain.
// The affine scan keeps the three-pass layout: kAffineChunks chunks, one
// warp a chunk, 2 + log2(kAffineChunks) launches on one stream (AffineOp
// below, smallmat.cuh products).
#include "smallmat.cuh"

#ifndef AUX_HHD
#ifdef __CUDACC__
#define AUX_HHD __host__ __device__ inline
#else
#define AUX_HHD inline
#endif
#endif

namespace {

using namespace smallmat;

// ---------------------------------------------------------------------------
// The filter scan
// ---------------------------------------------------------------------------

constexpr int kFilterD = 16;           // the combine's compile-time dimension (d <= 16)
constexpr int kFilterPer = 4;          // elements a chunk aims at
constexpr int kFilterMaxChunks = 128;  // chunks at most (a block an SM)
constexpr int kRing = 8;               // the chunk's prefixes kept in shared memory
constexpr int kBlock = 256;            // threads of a block
constexpr int kChain = 128;            // the chain's team: threads 0 .. kChain - 1
constexpr int kMaxTeams = kBlock / 32;  // the apply's teams at most (of a warp each)

// Chunks C (a power of two, at most kFilterMaxChunks, about n / kFilterPer),
// elements a chunk S = ceil(n / C), Hillis-Steele levels log2(C).
struct FilterPlan {
  int chunks, per, levels;
};

AUX_HHD FilterPlan filter_plan(int n) {
  const int want = (n + kFilterPer - 1) / kFilterPer;
  FilterPlan p{1, 0, 0};
  while (p.chunks < want && p.chunks < kFilterMaxChunks) {
    p.chunks *= 2;
    ++p.levels;
  }
  p.per = (n + p.chunks - 1) / p.chunks;
  return p;
}

// A padded element in shared memory (or in a global buffer of the same
// layout): A, b, C, e, J with D x D matrices at row stride D + 4 (rows
// 16-byte aligned for vector loads; a column's entries in distinct banks
// but for pairs of rows 8 apart).
template <int D>
struct Lay {
  static constexpr int ld = D + 4, mat = D * ld;
  static constexpr int b = mat, C = mat + D, e = 2 * mat + D, J = 2 * mat + 2 * D;
  static constexpr int slot = (3 * mat + 2 * D + 3) / 4 * 4;  // 16-byte multiple in f32 and f64
  // A team's working set: Z, T1 = C1 A2^T, T2 = J2 A1, A2Z, ZA1; v1, v2; the
  // pivot pairs' double-buffered columns and rows of M and Z (2 x 2 x D each).
  static constexpr int Z = 0, T1 = mat, T2 = 2 * mat, A2Z = 3 * mat, ZA1 = 4 * mat;
  static constexpr int v1 = 5 * mat, v2 = v1 + D, col = v2 + D, rowm = col + 4 * D,
                       rowz = rowm + 4 * D;
  static constexpr int work = (rowz + 4 * D + 3) / 4 * 4;
};

// Filtering element (A, b, C, eta, J), SGF 2021, unpadded (d x d) in global
// memory: the scan's inputs and outputs.
template <typename S>
struct FilterView {
  S *A, *b, *C, *e, *J;
};

// Thread t of a team of NT owns rows [r0, r0 + RPT) x columns [c0, c0 + CPT)
// of each D x D result: E = D^2 / NT contiguous entries (one on 256
// threads, half a row on 32, everything in the host build's one thread).
template <int D, int NT>
struct Tile {
  static constexpr int E = D * D / NT, CPT = E < D ? E : D, RPT = E / CPT;
  static_assert(E * NT == D * D && RPT * CPT == E, "NT divides D^2");
  int r0, c0;
  AUX_HD explicit Tile(int t) : r0(t * E / D), c0(t * E % D) {}
};

// A team barrier: the block (NT = kBlock), a warp, or named barrier `id` of
// NT threads. The host build has one thread and no barrier.
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
// (p aligned to them: rows of Lay are 16-byte aligned, and a tile's column
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

// acc(i, j) = sum_k X(i, k) Y(k, j) over the thread's tile, k ascending (the
// order smallmat's mm sums in), with X(i, k) = X[i ld + k] or, if TX, X[k ld
// + i], and Y(k, j) = Y[k ld + j] or, if TY, Y[j ld + k]. A row of X is read
// four k at a time and a row of Y a tile's width at a time.
template <typename S, int D, int NT, bool TX, bool TY>
AUX_HD void tile_mm(const Tile<D, NT>& tl, const S* X, const S* Y,
                    S (&acc)[Tile<D, NT>::RPT][Tile<D, NT>::CPT]) {
  constexpr int ld = Lay<D>::ld, R = Tile<D, NT>::RPT, Cn = Tile<D, NT>::CPT;
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
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      S y[Cn];
      if (TY) {
#pragma unroll
        for (int c = 0; c < Cn; ++c) y[c] = Y[(tl.c0 + c) * ld + k0 + kk];
      } else {
        load_run<S, Cn>(Y + (k0 + kk) * ld + tl.c0, y);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < Cn; ++c) acc[r][c] += x[r][kk] * y[c];
    }
  }
}

template <typename S, int D, int NT>
AUX_HD void tile_store(const Tile<D, NT>& tl, const S (&v)[Tile<D, NT>::RPT][Tile<D, NT>::CPT],
                       S* X) {
#pragma unroll
  for (int r = 0; r < Tile<D, NT>::RPT; ++r)
#pragma unroll
    for (int c = 0; c < Tile<D, NT>::CPT; ++c) X[(tl.r0 + r) * Lay<D>::ld + tl.c0 + c] = v[r][c];
}

// sum_k X(i, k) v[k], X(i, k) = X[i ld + k] or, if TX, X[k ld + i].
template <typename S, int D, bool TX>
AUX_HD S row_dot(const S* X, const S* v, int i) {
  constexpr int ld = Lay<D>::ld;
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

// The thread's entries of a combined element: its tile of A, C and J, and b
// and e of its rows where it owns column 0 (b) or column D - 1 (e).
template <typename S, int D, int NT>
struct FilterTile {
  using T = Tile<D, NT>;
  S A[T::RPT][T::CPT], C[T::RPT][T::CPT], J[T::RPT][T::CPT], b[T::RPT], e[T::RPT];
};

// o = l (+) r (filtering_operator) on a team of NT threads: thread t's
// entries, in registers; l, r and the working set w in shared memory, padded
// (Lay<D>). One inverse Z = (I + C1 J2)^{-1} by Gauss-Jordan without row
// exchanges, by 2 x 2 pivot blocks (I + C1 J2 is similar to I + SPD:
// eigenvalues >= 1), then
//   A = A2Z A1,  b = A2Z (b1 + C1 e2) + b2,  C = sym(A2Z (C1 A2^T) + C2),
//   e = ZA1^T (e2 - J2 b1) + e1,  J = sym(ZA1^T (J2 A1) + J1),
// each entry summed in the order smallmat's products sum it, so the result
// does not depend on NT. 11 team barriers; the caller's after it included:
// w, l and r are read until the function returns.
template <typename S, int D, int NT>
AUX_HD void filter_combine(int t, int bar, const S* l, const S* r, S* w,
                           FilterTile<S, D, NT>& o) {
  using L = Lay<D>;
  using T = Tile<D, NT>;
  constexpr int R = T::RPT, Cn = T::CPT, ld = L::ld;
  const T tl(t);
  const bool first = tl.c0 == 0, last = tl.c0 + Cn == D;
  const S *A1 = l, *b1 = l + L::b, *C1 = l + L::C, *e1 = l + L::e, *J1 = l + L::J;
  const S *A2 = r, *b2 = r + L::b, *C2 = r + L::C, *e2 = r + L::e, *J2 = r + L::J;
  S *Z = w + L::Z, *T1 = w + L::T1, *T2 = w + L::T2, *A2Z = w + L::A2Z, *ZA1 = w + L::ZA1;
  S *v1 = w + L::v1, *v2 = w + L::v2, *col = w + L::col, *rowm = w + L::rowm,
    *rowz = w + L::rowz;

  // Stage 1: M = I + C1 J2 (registers), T1, T2, v1 = b1 + C1 e2, v2 = e2 - J2 b1.
  S m[R][Cn], z[R][Cn], acc[R][Cn];
  tile_mm<S, D, NT, false, false>(tl, C1, J2, m);
  tile_mm<S, D, NT, false, true>(tl, C1, A2, acc);
  tile_store<S, D, NT>(tl, acc, T1);
  tile_mm<S, D, NT, false, false>(tl, J2, A1, acc);
  tile_store<S, D, NT>(tl, acc, T2);
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int i = tl.r0 + rr;
    if (first) v1[i] = row_dot<S, D, false>(C1, e2, i) + b1[i];
    if (last) v2[i] = e2[i] - row_dot<S, D, false>(J2, b1, i);
#pragma unroll
    for (int c = 0; c < Cn; ++c) {
      const int j = tl.c0 + c;
      if (i == j) m[rr][c] += (S)1;
      z[rr][c] = i == j ? (S)1 : (S)0;
      if (j < 2) col[j * D + i] = m[rr][c];  // the first pivot pair's columns and rows
      if (i < 2) {
        rowm[i * D + j] = m[rr][c];
        rowz[i * D + j] = z[rr][c];
      }
    }
  }
  team_sync<NT>(bar);

  // Stage 2: Gauss-Jordan by 2 x 2 pivot blocks, one barrier a pair (every
  // thread inverts the block from the published rows); Z ends in shared
  // memory.
#pragma unroll
  for (int k = 0; k < D; k += 2) {
    const int p = (k >> 1) & 1, q = p ^ 1;
    const S *cb = col + 2 * p * D, *rmb = rowm + 2 * p * D, *rzb = rowz + 2 * p * D;
    const S b00 = rmb[k], b01 = rmb[k + 1], b10 = rmb[D + k], b11 = rmb[D + k + 1];
    const S r = pivot_rcp(b00 * b11 - b01 * b10);
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
          Z[i * ld + j] = z[rr][c];
        }
      }
    }
    team_sync<NT>(bar);
  }

  // Stage 3: A2Z = A2 Z, ZA1 = Z A1.
  tile_mm<S, D, NT, false, false>(tl, A2, Z, acc);
  tile_store<S, D, NT>(tl, acc, A2Z);
  tile_mm<S, D, NT, false, false>(tl, Z, A1, acc);
  tile_store<S, D, NT>(tl, acc, ZA1);
  team_sync<NT>(bar);

  // Stage 4: the combined element; C and J symmetrised by computing both
  // (i, j) and (j, i) here (the products of entry (j, i) in its own order).
  S acc2[R][Cn];
  tile_mm<S, D, NT, false, false>(tl, A2Z, A1, o.A);
  tile_mm<S, D, NT, false, false>(tl, A2Z, T1, acc);
  tile_mm<S, D, NT, true, true>(tl, T1, A2Z, acc2);
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int c = 0; c < Cn; ++c) {
      const int i = tl.r0 + rr, j = tl.c0 + c;
      o.C[rr][c] = (S)0.5 * ((acc[rr][c] + C2[i * ld + j]) + (acc2[rr][c] + C2[j * ld + i]));
    }
  tile_mm<S, D, NT, true, false>(tl, ZA1, T2, acc);
  tile_mm<S, D, NT, true, false>(tl, T2, ZA1, acc2);
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int i = tl.r0 + rr;
#pragma unroll
    for (int c = 0; c < Cn; ++c) {
      const int j = tl.c0 + c;
      o.J[rr][c] = (S)0.5 * ((acc[rr][c] + J1[i * ld + j]) + (acc2[rr][c] + J1[j * ld + i]));
    }
    if (first) o.b[rr] = row_dot<S, D, false>(A2Z, v1, i) + b2[i];
    if (last) o.e[rr] = row_dot<S, D, true>(ZA1, v2, i) + e1[i];
  }
}

// The thread's entries of o into a padded element `x` (shared memory, or a
// global buffer of the same layout).
template <typename S, int D, int NT>
AUX_HD void store_padded(int t, const FilterTile<S, D, NT>& o, S* x) {
  using L = Lay<D>;
  const Tile<D, NT> tl(t);
  tile_store<S, D, NT>(tl, o.A, x);
  tile_store<S, D, NT>(tl, o.C, x + L::C);
  tile_store<S, D, NT>(tl, o.J, x + L::J);
#pragma unroll
  for (int rr = 0; rr < Tile<D, NT>::RPT; ++rr) {
    if (tl.c0 == 0) x[L::b + tl.r0 + rr] = o.b[rr];
    if (tl.c0 + Tile<D, NT>::CPT == D) x[L::e + tl.r0 + rr] = o.e[rr];
  }
}

// The thread's entries of o with i, j < d into element k of `out`.
template <typename S, int D, int NT>
AUX_HD void store_element(int t, const FilterTile<S, D, NT>& o, FilterView<S> out, long k,
                          int d) {
  using T = Tile<D, NT>;
  const T tl(t);
  const long mat = k * d * d, vec = k * d;
#pragma unroll
  for (int rr = 0; rr < T::RPT; ++rr) {
    const int i = tl.r0 + rr;
    if (i >= d) continue;
#pragma unroll
    for (int c = 0; c < T::CPT; ++c) {
      const int j = tl.c0 + c;
      if (j >= d) continue;
      out.A[mat + i * d + j] = o.A[rr][c];
      out.C[mat + i * d + j] = o.C[rr][c];
      out.J[mat + i * d + j] = o.J[rr][c];
    }
    if (tl.c0 == 0) out.b[vec + i] = o.b[rr];
    if (tl.c0 + T::CPT == D) out.e[vec + i] = o.e[rr];
  }
}

// One value from global to shared memory without waiting (cp.async); the
// host build copies at once.
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

// Element k of x (d x d) into the padded slot x's entries i, j < d, thread t
// of nt (the padding is written once, by pad_slot).
template <typename S, int D>
AUX_HD void stage_element(int t, int nt, FilterView<S> x, long k, int d, S* slot) {
  using L = Lay<D>;
  const long mat = k * d * d, vec = k * d;
  for (int q = t; q < d * d; q += nt) {
    const int i = q / d, j = q - i * d;  // once a staged value, not a combine's
    const int at = i * L::ld + j;
    copy_one(slot + at, x.A + mat + q);
    copy_one(slot + L::C + at, x.C + mat + q);
    copy_one(slot + L::J + at, x.J + mat + q);
  }
  for (int i = t; i < d; i += nt) {
    copy_one(slot + L::b + i, x.b + vec + i);
    copy_one(slot + L::e + i, x.e + vec + i);
  }
}

// The entries of a padded slot outside d x d: A's identity, zeros elsewhere.
template <typename S, int D>
AUX_HD void pad_slot(int t, int nt, int d, S* slot) {
  using L = Lay<D>;
  for (int q = t; q < D * D; q += nt) {
    const int i = q / D, j = q % D;
    if (i < d && j < d) continue;
    const int at = i * L::ld + j;
    slot[at] = i == j ? (S)1 : (S)0;
    slot[L::C + at] = slot[L::J + at] = (S)0;
  }
  for (int i = d + t; i < D; i += nt) slot[L::b + i] = slot[L::e + i] = (S)0;
}

// The identity element into a padded slot.
template <typename S, int D>
AUX_HD void identity_slot(int t, int nt, S* slot) {
  using L = Lay<D>;
  for (int q = t; q < D * D; q += nt) {
    const int at = q / D * L::ld + q % D;
    slot[at] = q / D == q % D ? (S)1 : (S)0;
    slot[L::C + at] = slot[L::J + at] = (S)0;
  }
  for (int i = t; i < D; i += nt) slot[L::b + i] = slot[L::e + i] = (S)0;
}

// The entries i, j < d of a padded slot into element k of `out`.
template <typename S, int D>
AUX_HD void slot_to_element(int t, int nt, const S* slot, FilterView<S> out, long k, int d) {
  using L = Lay<D>;
  const long mat = k * d * d, vec = k * d;
  for (int q = t; q < d * d; q += nt) {
    const int at = q / d * L::ld + q % d;
    out.A[mat + q] = slot[at];
    out.C[mat + q] = slot[L::C + at];
    out.J[mat + q] = slot[L::J + at];
  }
  for (int i = t; i < d; i += nt) {
    out.b[vec + i] = slot[L::b + i];
    out.e[vec + i] = slot[L::e + i];
  }
}

// An element of x as thread t of a team of NT holds it while it is on its
// way to shared memory: value q = t, t + NT, ... of A, C, J, b, e laid end
// to end, loaded into registers (a step ahead of their use, so that no load
// sits on the chain) and stored to a padded slot. The slot positions are
// computed once.
template <typename S, int D, int NT>
struct Staged {
  static constexpr int kVals = (3 * D * D + 2 * D + NT - 1) / NT;
  S v[kVals];
  int pos[kVals];
  int t, d;

  AUX_HD Staged(int t_, int d_) : t(t_), d(d_) {
    using L = Lay<D>;
    const int dd = d * d;
    for (int r = 0; r < kVals; ++r) {
      const int q = t + r * NT, m = q % dd, base = q < dd ? 0 : q < 2 * dd ? L::C : L::J;
      pos[r] = q < 3 * dd ? base + m / d * L::ld + m % d
               : q < 3 * dd + d ? L::b + q - 3 * dd : L::e + q - 3 * dd - d;
    }
  }
  AUX_HD void load(FilterView<S> x, long k) {
    const int dd = d * d, tot = 3 * dd + 2 * d;
    for (int r = 0; r < kVals; ++r) {
      const int q = t + r * NT;
      if (q < tot)
        v[r] = q < dd ? x.A[k * dd + q] : q < 2 * dd ? x.C[k * dd + q - dd]
             : q < 3 * dd ? x.J[k * dd + q - 2 * dd] : q < 3 * dd + d ? x.b[k * d + q - 3 * dd]
             : x.e[k * d + q - 3 * dd - d];
    }
  }
  AUX_HD void store(S* slot) const {
    const int tot = 3 * d * d + 2 * d;
    for (int r = 0; r < kVals; ++r)
      if (t + r * NT < tot) slot[pos[r]] = v[r];
  }
};

// Phase 1 of chunk c on a team (thread t of NT, barrier `bar`; one thread in
// the host build): out[k] = x[k0] (+) ... (+) x[k] for the chunk's elements, in
// order. Prefix i stays in the padded slot pre[i] while i < kRing (the
// apply's first window reads it there), else in run[i & 1]; returns the
// slot of the chunk total (pre[0] holding the identity for an empty chunk).
// Element i + 1 is loaded into registers while the combine of element i
// runs and stored to in[(i + 1) & 1] after it. `pre` and `in` padded.
template <typename S, int D, int NT>
AUX_HD S* chunk_scan(int t, int bar, const FilterPlan& pl, int c, int n, int d,
                     FilterView<S> x, FilterView<S> out, S* pre, S* in, S* run0, S* run1,
                     S* w) {
  using L = Lay<D>;
  const long k0 = (long)c * pl.per;
  const int cnt = (int)(n - k0 < pl.per ? (n - k0 > 0 ? n - k0 : 0) : pl.per);
  if (cnt == 0) {
    identity_slot<S, D>(t, NT, pre);
    team_sync<NT>(bar);
    return pre;
  }
  auto prefix = [&](int i) { return i < kRing ? pre + i * L::slot : (i & 1 ? run1 : run0); };
  Staged<S, D, NT> sv(t, d);
  sv.load(x, k0);
  sv.store(pre);
  if (cnt > 1) sv.load(x, k0 + 1);
  team_sync<NT>(bar);
  slot_to_element<S, D>(t, NT, pre, out, k0, d);
  for (int i = 1; i < cnt; ++i) {
    S* slot = in + (i & 1) * L::slot;
    sv.store(slot);
    if (i + 1 < cnt) sv.load(x, k0 + i + 1);
    team_sync<NT>(bar);
    FilterTile<S, D, NT> o;
    filter_combine<S, D, NT>(t, bar, prefix(i - 1), slot, w, o);
    store_padded<S, D, NT>(t, o, prefix(i));
    store_element<S, D, NT>(t, o, out, k0 + i, d);
    team_sync<NT>(bar);  // every thread is done with the input and the old prefix
  }
  return prefix(cnt - 1);
}

// dst = partner (+) own, on the team; ends with its barrier.
template <typename S, int D, int NT>
AUX_HD void level_combine(int t, int bar, const S* partner, const S* own, S* dst, S* w) {
  FilterTile<S, D, NT> o;
  filter_combine<S, D, NT>(t, bar, partner, own, w, o);
  store_padded<S, D, NT>(t, o, dst);
  team_sync<NT>(bar);
}

// The apply for element k: out[k] = pre (+) prefix (the chunk's prefix,
// staged in `slot`), on the team of NT threads whose thread t and barrier
// `bar` are given. No barrier after: `pre`, `slot` and w are read until the
// function returns.
template <typename S, int D, int NT>
AUX_HD void apply_element(int t, int bar, const S* pre, const S* slot, S* w, FilterView<S> out,
                          long k, int d) {
  FilterTile<S, D, NT> o;
  filter_combine<S, D, NT>(t, bar, pre, slot, w, o);
  store_element<S, D, NT>(t, o, out, k, d);
}

// ---------------------------------------------------------------------------
// The affine scan: kAffineChunks chunks, three passes.
// ---------------------------------------------------------------------------

constexpr int kAffineChunks = 128;

// Affine map x -> G x + e; (G1, e1) then (G2, e2) is (G2 G1, G2 e1 + e2).
template <typename S>
struct AffineView {
  S *G, *e;
};

template <typename S, int MD>
struct AffineOp {
  using Scalar = S;
  using View = AffineView<S>;
  static constexpr int kScratch = MD * MD + MD;

  static AUX_HD View at(const View& base, long k, int d) {
    return View{base.G + k * d * d, base.e + k * d};
  }

  static AUX_HD void set_identity(int lane, int nl, int d, View o) {
    eye(lane, nl, d, o.G);
    for (int i = lane; i < d; i += nl) o.e[i] = (S)0;
    AUX_SYNC();
  }

  static AUX_HD void assign(int lane, int nl, int d, View src, View o) {
    copy(lane, nl, d * d, src.G, o.G);
    copy(lane, nl, d, src.e, o.e);
  }

  static AUX_HD void combine(int lane, int nl, int d, View l, View r, View o, S* sm) {
    S *G = sm, *e = G + MD * MD;
    mm(lane, nl, d, d, d, r.G, l.G, G);
    mv(lane, nl, d, d, r.G, l.e, e);
    for (int i = lane; i < d; i += nl) e[i] += r.e[i];
    AUX_SYNC();
    assign(lane, nl, d, View{G, e}, o);
  }
};

AUX_HD int chunk_len(int n) { return (n + kAffineChunks - 1) / kAffineChunks; }

// Logical position k of the scan -> storage index (reverse scans run backwards).
AUX_HD long phys(long k, int n, bool reverse) { return reverse ? n - 1 - k : k; }

// Pass 1 for chunk c: out[k] = x[k0] (+) ... (+) x[k] within the chunk, and
// tot[c] = the chunk total (the identity for an empty chunk).
template <class Op>
AUX_HD void scan_chunk(int lane, int nl, int c, int n, int d, bool reverse,
                       typename Op::View x, typename Op::View out, typename Op::View tot,
                       typename Op::Scalar* sm) {
  const int S = chunk_len(n);
  const long k0 = (long)c * S;
  const long k1 = k0 + S < n ? k0 + S : n;
  if (k0 >= k1) {
    Op::set_identity(lane, nl, d, Op::at(tot, c, d));
    return;
  }
  Op::assign(lane, nl, d, Op::at(x, phys(k0, n, reverse), d),
             Op::at(out, phys(k0, n, reverse), d));
  for (long k = k0 + 1; k < k1; ++k)
    Op::combine(lane, nl, d, Op::at(out, phys(k - 1, n, reverse), d),
                Op::at(x, phys(k, n, reverse), d), Op::at(out, phys(k, n, reverse), d), sm);
  Op::assign(lane, nl, d, Op::at(out, phys(k1 - 1, n, reverse), d), Op::at(tot, c, d));
}

// One Hillis-Steele level over the chunk totals: dst[c] = src[c - off] (+) src[c].
template <class Op>
AUX_HD void scan_level(int lane, int nl, int c, int off, int d, typename Op::View src,
                       typename Op::View dst, typename Op::Scalar* sm) {
  if (c >= off)
    Op::combine(lane, nl, d, Op::at(src, c - off, d), Op::at(src, c, d), Op::at(dst, c, d), sm);
  else
    Op::assign(lane, nl, d, Op::at(src, c, d), Op::at(dst, c, d));
}

// Pass 3 for chunk c > 0: out[k] = (inclusive total of chunks < c) (+) out[k].
template <class Op>
AUX_HD void scan_apply(int lane, int nl, int c, int n, int d, bool reverse,
                       typename Op::View tot, typename Op::View out, typename Op::Scalar* sm) {
  if (c == 0) return;
  const int S = chunk_len(n);
  const long k0 = (long)c * S;
  const long k1 = k0 + S < n ? k0 + S : n;
  const typename Op::View pre = Op::at(tot, c - 1, d);
  for (long k = k0; k < k1; ++k) {
    const typename Op::View o = Op::at(out, phys(k, n, reverse), d);
    Op::combine(lane, nl, d, pre, o, o, sm);
  }
}

}  // namespace

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// Launch section: everything above is plain C++ on pointers and also builds
// as host code (one lane, no barriers); what follows needs nvcc.
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 16;

// Shared memory of a filter-scan block: kRing prefix slots, two input
// slots, two running slots, the partner slot, then a working set for each
// of the apply's teams (the chain's is the first).
template <typename S>
constexpr size_t filter_shmem() {
  return ((kRing + 5) * (size_t)Lay<kFilterD>::slot + kMaxTeams * (size_t)Lay<kFilterD>::work) *
         sizeof(S);
}

// The hand-over between blocks: a padded slot as 64-bit words, each one
// 32-bit half of the slot's bytes and the launch's epoch. One store writes a
// word whole, so a reader that sees the epoch has the half it carries: no
// fence, no separate flag, one trip through L2 each way.
template <typename S>
constexpr int kHandWords = Lay<kFilterD>::slot * (int)sizeof(S) / 4;

// The chain's team publishes a slot.
template <typename S>
__device__ void publish(const S* slot, unsigned long long* dst, unsigned epoch) {
  const unsigned* src = reinterpret_cast<const unsigned*>(slot);
  for (int q = threadIdx.x; q < kHandWords<S>; q += kChain) {
    const unsigned long long w = (unsigned long long)epoch << 32 | src[q];
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(dst + q), "l"(w) : "memory");
  }
}

// The chain's team: wait for each word of `src` to carry `epoch` (every
// stale word read again in one round), put the halves into the shared slot;
// ends with the team's barrier.
template <typename S>
__device__ void take(const unsigned long long* src, S* slot, unsigned epoch) {
  constexpr int per = (kHandWords<S> + kChain - 1) / kChain;
  unsigned* dst = reinterpret_cast<unsigned*>(slot);
  unsigned long long w[per];
  bool stale = true;
  for (bool first = true; stale; first = false) {
#pragma unroll
    for (int i = 0; i < per; ++i) {
      const int q = threadIdx.x + i * kChain;
      if (q < kHandWords<S> && (first || (unsigned)(w[i] >> 32) != epoch))
        asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(w[i]) : "l"(src + q) : "memory");
    }
    stale = false;
#pragma unroll
    for (int i = 0; i < per; ++i) {
      const int q = threadIdx.x + i * kChain;
      stale |= q < kHandWords<S> && (unsigned)(w[i] >> 32) != epoch;
    }
  }
#pragma unroll
  for (int i = 0; i < per; ++i) {
    const int q = threadIdx.x + i * kChain;
    if (q < kHandWords<S>) dst[q] = (unsigned)w[i];
  }
  team_sync<kChain>(1);
}

// The apply of the chunk's elements [i0, i1) (prefixes in ring slots from
// i0's): element i on team (i - i0) % (kBlock / NT), a team of NT threads.
template <typename S, int NT>
__device__ void apply_window(int i0, int i1, long k0, int d, const S* pre, S* ring, S* work,
                             FilterView<S> out) {
  constexpr int D = kFilterD, teams = kBlock / NT;
  const int g = threadIdx.x / NT;
  for (int i = i0 + g; i < i1; i += teams)
    apply_element<S, D, NT>(threadIdx.x % NT, NT == 32 ? 0 : 2 + g, pre,
                            ring + (i - i0) * Lay<D>::slot, work + g * Lay<D>::work, out,
                            k0 + i, d);
}

// The whole filter scan: chunk c = the block's ticket. Threads 0 .. kChain
// - 1 run the chain (the chunk, the levels, the hops); then every thread
// takes part in the apply. `hand` holds (levels + 1) x chunks hand-over
// slots (row L: the values at the start of level L; row levels: the
// inclusive totals); `state` = {ticket counter, blocks done, last epoch},
// zeros at first, left so by each launch's last block, which also advances
// the epoch (stale words carry an older one). Launches must not overlap on
// one state. `stamps`, if not null, takes each block's clock64 at its
// phases (diagnostics, kernel_times.py): start, after its chunk, after
// each level, after the hop for the chunks before it, at the end.
template <typename S>
__global__ void __launch_bounds__(kBlock, 1)
filter_scan_kernel(int n, int d, FilterView<S> x, FilterView<S> out, unsigned long long* hand,
                   int* state, long long* stamps) {
  constexpr int D = kFilterD, slot = Lay<D>::slot, hw = kHandWords<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  S* ring = reinterpret_cast<S*>(smem);  // the prefixes: the apply's window
  S* in = ring + kRing * slot;           // two input slots
  S* run0 = in + 2 * slot;
  S* run1 = run0 + slot;
  S* partner = run1 + slot;
  S* work = partner + slot;
  __shared__ int ticket;
  __shared__ unsigned epoch_sh;
  const int t = threadIdx.x;
  const long long t0 = clock64();
  if (t == 0) {
    ticket = atomicAdd(state, 1);
    epoch_sh = *reinterpret_cast<volatile unsigned*>(state + 2) + 1;
  }
  for (int g = 0; g < kRing + 2; ++g) pad_slot<S, D>(t, kBlock, d, ring + g * slot);
  __syncthreads();
  const int c = ticket;
  const unsigned epoch = epoch_sh;
  const FilterPlan pl = filter_plan(n);
  long long* st = stamps ? stamps + (long)c * (pl.levels + 4) : nullptr;
  if (st && t == 0) st[0] = t0;
  const long k0 = (long)c * pl.per;
  const int cnt = (int)(n - k0 < pl.per ? (n - k0 > 0 ? n - k0 : 0) : pl.per);

  if (t < kChain) {
    S* cur = chunk_scan<S, D, kChain>(t, 1, pl, c, n, d, x, out, ring, in, run0, run1, work);
    if (st && t == 0) st[1] = clock64();
    for (int L = 0; L < pl.levels; ++L) {
      const int off = 1 << L;
      unsigned long long* row = hand + (long)L * pl.chunks * hw;
      if (c + off < pl.chunks) publish(cur, row + (long)c * hw, epoch);
      if (c >= off) {
        take(row + (long)(c - off) * hw, partner, epoch);
        S* dst = cur == run0 ? run1 : run0;
        level_combine<S, D, kChain>(t, 1, partner, cur, dst, work);
        cur = dst;
      }
      if (st && t == 0) st[2 + L] = clock64();
    }
    unsigned long long* fin = hand + (long)pl.levels * pl.chunks * hw;
    if (c + 1 < pl.chunks) publish(cur, fin + (long)c * hw, epoch);
    if (c > 0) take(fin + (long)(c - 1) * hw, partner, epoch);
    if (st && t == 0) st[2 + pl.levels] = clock64();
  }
  __syncthreads();  // the total of the chunks before this one, to every thread
  if (c > 0)
    for (int i0 = 0; i0 < cnt; i0 += kRing) {
      const int i1 = i0 + kRing < cnt ? i0 + kRing : cnt;
      if (i0 > 0) {  // a later window (S > kRing): stage it now
        __syncthreads();
        for (int i = i0; i < i1; ++i)
          stage_element<S, D>(t, kBlock, out, k0 + i, d, ring + (i - i0) * slot);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
      }
      if (pl.per <= kBlock / 64)  // few elements: 64-thread teams, else a warp each
        apply_window<S, 64>(i0, i1, k0, d, partner, ring, work, out);
      else
        apply_window<S, 32>(i0, i1, k0, d, partner, ring, work, out);
    }
  if (st && t == 0) st[3 + pl.levels] = clock64();
  __syncthreads();
  if (t == 0) {
    __threadfence();
    if (atomicAdd(state + 1, 1) == pl.chunks - 1) {  // the last block: reset for the next launch
      state[0] = 0;
      state[1] = 0;
      state[2] = (int)epoch;
      __threadfence();
    }
  }
}

// clock64 cycles of a chain of `reps` combines l <- l (+) x[1] from l = x[0]
// on one team of NT threads (diagnostics: the candidates for the scan's
// teams; each result is the next combine's input, as on the scan's chain);
// the last result into element 0 of `out`.
template <typename S, int NT>
__global__ void __launch_bounds__(NT)
filter_combine_cycles_kernel(int d, int reps, FilterView<S> x, FilterView<S> out,
                             long long* cycles) {
  constexpr int D = kFilterD, slot = Lay<D>::slot;
  extern __shared__ __align__(16) unsigned char smem[];
  S* l = reinterpret_cast<S*>(smem);
  S* l2 = l + slot;
  S* r = l2 + slot;
  S* w = r + slot;
  const int t = threadIdx.x;
  pad_slot<S, D>(t, NT, d, l);
  pad_slot<S, D>(t, NT, d, r);
  stage_element<S, D>(t, NT, x, 0, d, l);
  stage_element<S, D>(t, NT, x, 1, d, r);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  FilterTile<S, D, NT> o;
  const long long c0 = clock64();
  for (int i = 0; i < reps; ++i) {
    filter_combine<S, D, NT>(t, 1, l, r, w, o);
    store_padded<S, D, NT>(t, o, l2);
    team_sync<NT>(1);
    S* tmp = l;
    l = l2;
    l2 = tmp;
  }
  const long long c1 = clock64();
  store_element<S, D, NT>(t, o, out, 0, d);
  if (t == 0) cycles[0] = c1 - c0;
}

template <typename S>
int set_shmem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename S>
int run_filter_scan(int n, int d, FilterView<S> x, FilterView<S> out, unsigned long long* hand,
                    int* state, long long* stamps, cudaStream_t stream) {
  if (n <= 0 || d < 1 || d > kFilterD) return (int)cudaErrorInvalidValue;
  const size_t shmem = filter_shmem<S>();
  if (int err = set_shmem<S>((const void*)filter_scan_kernel<S>, shmem)) return err;
  filter_scan_kernel<S><<<filter_plan(n).chunks, kBlock, shmem, stream>>>(n, d, x, out, hand,
                                                                           state, stamps);
  return (int)cudaGetLastError();
}

template <typename S, int NT>
int run_combine_cycles(int d, int reps, FilterView<S> x, FilterView<S> out, long long* cycles,
                       cudaStream_t stream) {
  const size_t shmem = (3 * (size_t)Lay<kFilterD>::slot + Lay<kFilterD>::work) * sizeof(S);
  if (int err = set_shmem<S>((const void*)filter_combine_cycles_kernel<S, NT>, shmem))
    return err;
  filter_combine_cycles_kernel<S, NT><<<1, NT, shmem, stream>>>(d, reps, x, out, cycles);
  return (int)cudaGetLastError();
}

template <class Op>
__global__ void __launch_bounds__(32)
chunk_kernel(int n, int d, bool reverse, typename Op::View x, typename Op::View out,
             typename Op::View tot) {
  __shared__ typename Op::Scalar sm[Op::kScratch];
  scan_chunk<Op>(threadIdx.x, 32, blockIdx.x, n, d, reverse, x, out, tot, sm);
}

template <class Op>
__global__ void __launch_bounds__(32)
level_kernel(int off, int d, typename Op::View src, typename Op::View dst) {
  __shared__ typename Op::Scalar sm[Op::kScratch];
  scan_level<Op>(threadIdx.x, 32, blockIdx.x, off, d, src, dst, sm);
}

template <class Op>
__global__ void __launch_bounds__(32)
apply_kernel(int n, int d, bool reverse, typename Op::View tot, typename Op::View out) {
  __shared__ typename Op::Scalar sm[Op::kScratch];
  scan_apply<Op>(threadIdx.x, 32, blockIdx.x, n, d, reverse, tot, out, sm);
}

// The whole affine scan: 2 + log2(kAffineChunks) launches on `stream`.
// tot0/tot1 are kAffineChunks elements of scratch each.
template <class Op>
int run_scan(int n, int d, bool reverse, typename Op::View x, typename Op::View out,
             typename Op::View tot0, typename Op::View tot1, cudaStream_t stream) {
  if (n <= 0 || d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  chunk_kernel<Op><<<kAffineChunks, 32, 0, stream>>>(n, d, reverse, x, out, tot0);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  for (int off = 1; off < kAffineChunks; off *= 2) {
    level_kernel<Op><<<kAffineChunks, 32, 0, stream>>>(off, d, tot0, tot1);
    if (cudaError_t err = cudaGetLastError()) return (int)err;
    const typename Op::View t = tot0;
    tot0 = tot1;
    tot1 = t;
  }
  apply_kernel<Op><<<kAffineChunks, 32, 0, stream>>>(n, d, reverse, tot0, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Filter scan state: `hand` (levels + 1) x chunks x hand_words 64-bit words
// and `state` 3 int32, zeros when first given, kept from launch to launch
// (filter_scan.py holds them, one pair a device and dtype).
// Affine scratch: 2 * kAffineChunks elements, each (G, e) block contiguous.
#define AUX_DEFINE_SCANS(SUFFIX, S)                                                          \
  extern "C" int aux_filter_scan_##SUFFIX(int n, int d, S* A, S* b, S* C, S* e, S* J,        \
                                          S* oA, S* ob, S* oC, S* oe, S* oJ,                 \
                                          unsigned long long* hand, int* state,              \
                                          long long* stamps, void* stream) {                 \
    return run_filter_scan<S>(n, d, FilterView<S>{A, b, C, e, J},                            \
                              FilterView<S>{oA, ob, oC, oe, oJ}, hand, state, stamps,        \
                              (cudaStream_t)stream);                                         \
  }                                                                                          \
  extern "C" int aux_filter_combine_cycles_##SUFFIX(int d, int nt, int reps, S* A, S* b,     \
                                                    S* C, S* e, S* J, S* oA, S* ob, S* oC,   \
                                                    S* oe, S* oJ, long long* cycles,         \
                                                    void* stream) {                          \
    const FilterView<S> x{A, b, C, e, J}, o{oA, ob, oC, oe, oJ};                             \
    const cudaStream_t s = (cudaStream_t)stream;                                             \
    if (d < 1 || d > kFilterD || reps < 1) return (int)cudaErrorInvalidValue;                \
    switch (nt) {                                                                            \
      case 32: return run_combine_cycles<S, 32>(d, reps, x, o, cycles, s);                   \
      case 64: return run_combine_cycles<S, 64>(d, reps, x, o, cycles, s);                   \
      case 128: return run_combine_cycles<S, 128>(d, reps, x, o, cycles, s);                 \
      case 256: return run_combine_cycles<S, 256>(d, reps, x, o, cycles, s);                 \
      default: return (int)cudaErrorInvalidValue;                                            \
    }                                                                                        \
  }                                                                                          \
  extern "C" int aux_affine_scan_##SUFFIX(int n, int d, int reverse, S* G, S* e, S* oG,      \
                                          S* oe, S* scratch, void* stream) {                 \
    using View = AffineView<S>;                                                              \
    const long mat = (long)kAffineChunks * d * d, vec = (long)kAffineChunks * d;            \
    S* s1 = scratch + mat + vec;                                                             \
    return run_scan<AffineOp<S, kMaxD>>(n, d, reverse != 0, View{G, e}, View{oG, oe},        \
                                        View{scratch, scratch + mat}, View{s1, s1 + mat},    \
                                        (cudaStream_t)stream);                               \
  }

AUX_DEFINE_SCANS(f32, float)
AUX_DEFINE_SCANS(f64, double)
#endif  // __CUDACC__
