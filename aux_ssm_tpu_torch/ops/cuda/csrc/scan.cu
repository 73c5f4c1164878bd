// Inclusive associative scans of the auxiliary-Kalman MH step. They replace
// the Pallas scans of aux_ssm_tpu/ops/pallas/:
//
//   filter scan  <- filter_scan.fused_filter_scan (_chunked_scan_kernel, and
//                   _scan_kernel below T = 512: one kernel serves all T)
//   affine scan  <- kalman_fused.fused_affine_scan (_affine_scan_kernel),
//                   forward or reversed
//
// The TPU kernels carry a prefix from one grid step to the next in VMEM
// scratch. Blocks on Hopper run in no order, so nothing carries between
// blocks by itself. Both scans run one skeleton (scan_kernel) in one launch:
// the n elements are cut into C chunks of S = ceil(n / C) (C a power of two
// near n / 4, at most 128: 128 of 8 at n = 1024); each chunk is scanned sequentially, the chunk totals
// by Hillis-Steele, and each chunk's elements are then combined with the
// total of the chunks before it. The plain twins in ops/cuda/filter_scan.py
// run the same chunks in the same order. What bounds a scan is the dependent
// chain of combines and hand-overs (at T = 1024 the filter scan's inputs are
// ~6.5 MB, ~2 us of the card's memory rate; the affine scan's 1.1 MB), so
// the skeleton shortens the chain and keeps loads off it:
//  - A block takes its chunk from a ticket (an atomic counter), so it waits
//    only on blocks that started before it and the launch needs no
//    co-residency; a block an SM (C <= 128), since two combines on one SM
//    take twice as long (its issue rate, not latency, sets a combine's time).
//  - The chain runs on a team of the block's threads: S - 1 combines within
//    the chunk, its first kRing elements staged into shared memory by
//    cp.async at the start (each later one loaded into registers while a
//    combine runs) and its first kRing prefixes kept there for the apply;
//    log2(C) Hillis-Steele levels over the chunk totals, block c taking the
//    level's value of block c - 2^L from global memory; one hop for the
//    total of the chunks before c; then the chunk's S combines, which do
//    not depend on each other, at once on the block's teams. Every output
//    is written to global memory once, off the chain (chunk 0's prefixes
//    are its outputs), and no global store precedes a barrier of the chain:
//    a barrier waits for the team's stores to be performed.
//  - A hand-over is a padded element as 64-bit words, each a 32-bit half
//    beside the launch's epoch, written whole and read until the epoch
//    shows: one trip through L2, no fence or flag. The words and the state
//    {ticket, blocks done, epoch} are kept by the caller, one set a stream
//    (filter_scan.py): the state is zeros at first, and each launch's last
//    block leaves it so, advancing the epoch (stale words carry an older
//    one). So launches on one stream follow each other safely, and launches
//    on two streams use two states. What remains: one state must not serve
//    two launches at once, so a captured CUDA graph must not be replayed on
//    two streams at the same time.
//  - Each combine runs at a compile-time D (tile.cuh: d <= D padded exactly,
//    the thread's tile of each result in registers), in three instances
//    chosen by d: D = 16 (the flagship's d), D = 32 (the SV model's d = 30)
//    and, in float32 only, D = 48 (SV at d = 33-48). Each instance has its
//    own plan (BlockPlan: the prefixes kept, the input slots, the chain's
//    team, the apply's teams), since a D = 32 filter element is 3.5x the
//    D = 16 one, a D = 48 one 7.6x, and the block's shared memory holds
//    227 KB.
//
// The filter combine (FilterOp) is about 11 D x D products and a
// Gauss-Jordan inverse. The padding: A -> diag(A, I), C and J -> diag(., 0),
// b and eta -> 0; then I + C1 J2 = diag(I + C1 J2, I) and every product
// keeps the padding. Its chain team has 128 threads (2 entries a thread),
// which beat 32, 64 and 256 (kernel_times.py's combine cycles); the symmetric
// results are computed in both orders by the owner of each entry, so no
// barrier waits for a transpose; the inverse is by 2 x 2 pivot blocks, one
// barrier a pair, 11 a combine.
//
// The affine combine (AffineOp) is one product and a mat-vec: (G1, e1) then
// (G2, e2) is (G2 G1, G2 e1 + e2), padded by G -> diag(G, I), e -> 0, with
// no barrier inside (~390 cycles on 128 threads), so the scan's chain is
// made of its hand-overs (~1.4k cycles a level) more than of arithmetic. It
// runs on the filter scan's plan and chain team: at n = 1024 on an H100, 128
// chunks on a 128-thread team beat 32-256 chunks on 32-128 threads (0.0157
// ms of device time against 0.0189-0.0467, PERF.md). reverse = 1 scans from
// the end: logical element k is stored at n - 1 - k.
//
// Chain axis: C independent chains' scans in one launch, the elements laid
// out (n, C, ...) (element k of chain c at k C + c). Chain c runs the one-chain
// plan (scan_plan(n)) on its own hand-over rows, C x chunks blocks in all. The
// tickets go out chain-major (ticket q: chain q / chunks, chunk q % chunks),
// so every block that a block waits on (its own chain's chunk c - 2^L or c -
// 1) holds a lower ticket and has started: past the blocks the card holds at
// once (C = 32 at n = 249 is 16 waves of 128 blocks) a block never waits on
// one that cannot run. The state counts C x chunks blocks before the last
// resets it. A block's arithmetic does not depend on its chain, so chain c of
// a C-chain launch is bit-equal to a one-chain launch on its elements.
#include <type_traits>

#include "tile.cuh"

#ifndef AUX_HHD
#ifdef __CUDACC__
#define AUX_HHD __host__ __device__ inline
#else
#define AUX_HHD inline
#endif
#endif

// A device function the kernel calls rather than inlines (inline in the host
// build).
#ifdef __CUDACC__
#define AUX_CALLED __device__ __noinline__
#else
#define AUX_CALLED inline
#endif

namespace {

using namespace tiles;

constexpr int kNarrowD = 16;    // the instances' compile-time dimensions: d <= 16,
constexpr int kWideD = 32;      // 16 < d <= 32,
constexpr int kWide48D = 48;    // and 32 < d <= 48 (float32 only)
constexpr int kBlock = 256;     // threads of a block

// A block's plan for an op at one D and dtype: `ring` prefixes of the chunk
// kept in shared memory, `ins` input slots for the chain's elements past
// them (2, double-buffered, or 1: the chain's barrier after each combine
// already keeps the next store off the slot until every thread has read
// it), the chain's team of `chain` threads, the apply's teams of `narrow`
// threads (of `wide` for chunks of at most kBlock / 64 elements, where the
// op asks for it), and a working set a narrow team.
template <int ring_, int chain_, int narrow_, int wide_, int ins_ = 2>
struct BlockPlan {
  static constexpr int ring = ring_, chain = chain_, narrow = narrow_, wide = wide_, ins = ins_;
  static constexpr int teams = kBlock / narrow;  // working sets beside the slots
};

constexpr int kChunkPer = 4;     // the elements a chunk aims at
constexpr int kMaxChunks = 128;  // chunks at most: a block an SM

// C chunks of S = ceil(n / C) elements, log2(C) levels: C is the least power
// of two >= ceil(n / kChunkPer), at most kMaxChunks (filter_scan.scan_chunks,
// which the plain versions and the hand-over buffer's size take).
struct ScanPlan {
  int chunks, per, levels;
};

AUX_HHD ScanPlan scan_plan(int n) {
  const int want = (n + kChunkPer - 1) / kChunkPer;
  ScanPlan p{1, 0, 0};
  while (p.chunks < want && p.chunks < kMaxChunks) {
    p.chunks *= 2;
    ++p.levels;
  }
  p.per = (n + p.chunks - 1) / p.chunks;
  return p;
}

// Logical position k of chain `chain`'s scan -> storage index of its element
// in the (n, chains, ...) layout (reverse scans run backwards).
struct Order {
  long n;
  bool reverse;
  int chains, chain;
  AUX_HD long operator()(long k) const { return (reverse ? n - 1 - k : k) * chains + chain; }
};

// A padded element in shared memory (or a global buffer of the same layout):
// M D x D matrices at row stride kLd<D>, then V vectors of D; the slot a
// 16-byte multiple in f32 and f64.
template <int D, int M, int V>
struct ElemLay {
  static constexpr int ld = kLd<D>, mat = D * ld, vec = M * mat;
  static constexpr int slot = (M * mat + V * D + 3) / 4 * 4;
};

// An element in global memory, unpadded: M d x d matrices and V d-vectors
// (element k at k d^2 and k d).
template <typename S, int M, int V>
struct ElemView {
  S* m[M];
  S* v[V];
};

// The thread's entries of a combined element: its tile of each matrix, and
// each vector's entries of its rows where it owns column 0 (vector 0) or
// column D - 1 (the others).
template <typename S, int D, int NT, int M, int V>
struct ElemTile {
  Regs<S, D, NT> m[M];
  S v[V][Tile<D, NT>::RPT];
};

template <int D, int NT>
AUX_HD bool owns_vec(const Tile<D, NT>& tl, int v) {
  return v == 0 ? tl.first() : tl.last();
}

// The thread's entries of o into a padded slot x (shared memory, or a global
// buffer of the same layout).
template <typename S, int D, int NT, int M, int V>
AUX_HD void store_padded(int t, const ElemTile<S, D, NT, M, V>& o, S* x) {
  using L = ElemLay<D, M, V>;
  const Tile<D, NT> tl(t);
#pragma unroll
  for (int w = 0; w < M; ++w) tile_store<S, D, NT>(tl, o.m[w], x + w * L::mat);
#pragma unroll
  for (int w = 0; w < V; ++w) {
    if (!owns_vec(tl, w)) continue;
#pragma unroll
    for (int rr = 0; rr < Tile<D, NT>::RPT; ++rr) x[L::vec + w * D + tl.r0 + rr] = o.v[w][rr];
  }
}

// The thread's entries of o with i, j < d into element k of `out`.
template <typename S, int D, int NT, int M, int V>
AUX_HD void store_element(int t, const ElemTile<S, D, NT, M, V>& o, ElemView<S, M, V> out,
                          long k, int d) {
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
#pragma unroll
      for (int w = 0; w < M; ++w) out.m[w][mat + i * d + j] = o.m[w][rr][c];
    }
#pragma unroll
    for (int w = 0; w < V; ++w)
      if (owns_vec(tl, w)) out.v[w][vec + i] = o.v[w][rr];
  }
}

// Element k of x (d x d) into the padded slot's entries i, j < d by
// cp.async, thread t of nt (the padding is written once, by pad_slot).
template <typename S, int D, int M, int V>
AUX_HD void stage_element(int t, int nt, ElemView<S, M, V> x, long k, int d, S* slot) {
  using L = ElemLay<D, M, V>;
  const long mat = k * d * d, vec = k * d;
  for (int q = t; q < d * d; q += nt) {
    const int i = q / d, j = q - i * d;  // once a staged value, not a combine's
#pragma unroll
    for (int w = 0; w < M; ++w) copy_one(slot + w * L::mat + i * L::ld + j, x.m[w] + mat + q);
  }
  for (int i = t; i < d; i += nt)
#pragma unroll
    for (int w = 0; w < V; ++w) copy_one(slot + L::vec + w * D + i, x.v[w] + vec + i);
}

// The entries of a padded slot outside d x d: matrix 0's identity, zeros
// elsewhere (the filter's A and the affine G are padded with I).
template <typename S, int D, int M, int V>
AUX_HD void pad_slot(int t, int nt, int d, S* slot) {
  using L = ElemLay<D, M, V>;
  for (int q = t; q < D * D; q += nt) {
    const int i = q / D, j = q % D;
    if (i < d && j < d) continue;
    const int at = i * L::ld + j;
    slot[at] = i == j ? (S)1 : (S)0;
#pragma unroll
    for (int w = 1; w < M; ++w) slot[w * L::mat + at] = (S)0;
  }
  for (int i = d + t; i < D; i += nt)
#pragma unroll
    for (int w = 0; w < V; ++w) slot[L::vec + w * D + i] = (S)0;
}

// The entries i, j < d of a padded slot into element k of `out`.
template <typename S, int D, int M, int V>
AUX_HD void slot_to_element(int t, int nt, const S* slot, ElemView<S, M, V> out, long k, int d) {
  using L = ElemLay<D, M, V>;
  const long mat = k * d * d, vec = k * d;
  for (int q = t; q < d * d; q += nt) {
    const int at = q / d * L::ld + q % d;
#pragma unroll
    for (int w = 0; w < M; ++w) out.m[w][mat + q] = slot[w * L::mat + at];
  }
  for (int i = t; i < d; i += nt)
#pragma unroll
    for (int w = 0; w < V; ++w) out.v[w][vec + i] = slot[L::vec + w * D + i];
}

// An element of x as thread t of a team of NT holds it while it is on its
// way to shared memory: value q = t, t + NT, ... of the matrices and vectors
// laid end to end, loaded into registers (a step ahead of their use, so that
// no load sits on the chain) and stored to a padded slot. The slot positions
// are computed once.
template <typename S, int D, int NT, int M, int V>
struct Staged {
  static constexpr int kVals = (M * D * D + V * D + NT - 1) / NT;
  S v[kVals];
  int pos[kVals];
  int t, d;

  AUX_HD Staged(int t_, int d_) : t(t_), d(d_) {
    using L = ElemLay<D, M, V>;
    const int dd = d * d;
    for (int r = 0; r < kVals; ++r) {
      const int q = t + r * NT, w = q / dd, m = q - w * dd, u = q - M * dd;
      pos[r] = q < M * dd ? w * L::mat + m / d * L::ld + m % d : L::vec + u / d * D + u % d;
    }
  }
  AUX_HD void load(ElemView<S, M, V> x, long k) {
    const int dd = d * d;
    for (int r = 0; r < kVals; ++r) {
      const int q = t + r * NT, u = q - M * dd;
#pragma unroll
      for (int w = 0; w < M; ++w)
        if (q >= w * dd && q < (w + 1) * dd) v[r] = x.m[w][k * dd + q - w * dd];
#pragma unroll
      for (int w = 0; w < V; ++w)
        if (u >= w * d && u < (w + 1) * d) v[r] = x.v[w][k * d + u - w * d];
    }
  }
  AUX_HD void store(S* slot) const {
    const int tot = M * d * d + V * d;
    for (int r = 0; r < kVals; ++r)
      if (t + r * NT < tot) slot[pos[r]] = v[r];
  }
};

// ---------------------------------------------------------------------------
// The filter combine
// ---------------------------------------------------------------------------

// A filtering element (A, b, C, eta, J), SGF 2021: matrices A, C, J, vectors
// b, eta. A team's working set beside it: Z, T1 = C1 A2^T, T2 = J2 A1, A2Z,
// ZA1; v1, v2; the pivot pairs' double-buffered columns and rows of M and Z
// (2 x 2 x D each).
template <int D>
struct FilterWork {
  static constexpr int mat = D * kLd<D>;
  static constexpr int Z = 0, T1 = mat, T2 = 2 * mat, A2Z = 3 * mat, ZA1 = 4 * mat;
  static constexpr int v1 = 5 * mat, v2 = v1 + D, col = v2 + D, rowm = col + 4 * D,
                       rowz = rowm + 4 * D;
  static constexpr int size = (rowz + 4 * D + 3) / 4 * 4;
};

template <typename S, int D, int NT>
using FilterTile = ElemTile<S, D, NT, 3, 2>;

// o = l (+) r (filtering_operator) on a team of NT threads: thread t's
// entries, in registers; l, r and the working set w in shared memory, padded.
// One inverse Z = (I + C1 J2)^{-1} by Gauss-Jordan without row exchanges
// (I + C1 J2 is similar to I + SPD: eigenvalues >= 1), then
//   A = A2Z A1,  b = A2Z (b1 + C1 e2) + b2,  C = sym(A2Z (C1 A2^T) + C2),
//   e = ZA1^T (e2 - J2 b1) + e1,  J = sym(ZA1^T (J2 A1) + J1),
// each entry summed over k ascending, so the result does not depend on NT.
// 11 team barriers; the caller's after it included: w, l and r are read
// until the function returns.
template <typename S, int D, int NT>
AUX_HD void filter_combine(int t, int bar, const S* l, const S* r, S* w,
                           FilterTile<S, D, NT>& o) {
  using L = ElemLay<D, 3, 2>;
  using W = FilterWork<D>;
  using T = Tile<D, NT>;
  constexpr int R = T::RPT, Cn = T::CPT, ld = L::ld;
  const T tl(t);
  const S *A1 = l, *C1 = l + L::mat, *J1 = l + 2 * L::mat, *b1 = l + L::vec, *e1 = b1 + D;
  const S *A2 = r, *C2 = r + L::mat, *J2 = r + 2 * L::mat, *b2 = r + L::vec, *e2 = b2 + D;
  S *Z = w + W::Z, *T1 = w + W::T1, *T2 = w + W::T2, *A2Z = w + W::A2Z, *ZA1 = w + W::ZA1;
  S *v1 = w + W::v1, *v2 = w + W::v2, *col = w + W::col, *rowm = w + W::rowm,
    *rowz = w + W::rowz;

  // Stage 1: M = I + C1 J2 (registers), T1, T2, v1 = b1 + C1 e2, v2 = e2 - J2 b1.
  Regs<S, D, NT> m, z, acc;
  tile_mm<S, D, NT, false, false>(tl, C1, J2, m);
  tile_mm<S, D, NT, false, true>(tl, C1, A2, acc);
  tile_store<S, D, NT>(tl, acc, T1);
  tile_mm<S, D, NT, false, false>(tl, J2, A1, acc);
  tile_store<S, D, NT>(tl, acc, T2);
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int i = tl.r0 + rr;
    if (tl.first()) v1[i] = row_dot<S, D, false>(C1, e2, i) + b1[i];
    if (tl.last()) v2[i] = e2[i] - row_dot<S, D, false>(J2, b1, i);
#pragma unroll
    for (int c = 0; c < Cn; ++c) {
      const int j = tl.c0 + c;
      if (i == j) m[rr][c] += (S)1;
      z[rr][c] = i == j ? (S)1 : (S)0;
    }
  }
  gj_publish_first<S, D, NT>(tl, m, z, col, rowm, rowz);
  team_sync<NT>(bar);

  // Stage 2: Z = M^{-1} by Gauss-Jordan, one barrier a pivot pair; Z ends in
  // shared memory.
  gj_solve<S, D, NT>(tl, bar, m, z, col, rowm, rowz, Z);

  // Stage 3: A2Z = A2 Z, ZA1 = Z A1.
  tile_mm<S, D, NT, false, false>(tl, A2, Z, acc);
  tile_store<S, D, NT>(tl, acc, A2Z);
  tile_mm<S, D, NT, false, false>(tl, Z, A1, acc);
  tile_store<S, D, NT>(tl, acc, ZA1);
  team_sync<NT>(bar);

  // Stage 4: the combined element; C and J symmetrised by computing both
  // (i, j) and (j, i) here (the products of entry (j, i) in its own order).
  Regs<S, D, NT> acc2;
  tile_mm<S, D, NT, false, false>(tl, A2Z, A1, o.m[0]);
  tile_mm<S, D, NT, false, false>(tl, A2Z, T1, acc);
  tile_mm<S, D, NT, true, true>(tl, T1, A2Z, acc2);
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int c = 0; c < Cn; ++c) {
      const int i = tl.r0 + rr, j = tl.c0 + c;
      o.m[1][rr][c] =
          (S)0.5 * ((acc[rr][c] + C2[i * ld + j]) + (acc2[rr][c] + C2[j * ld + i]));
    }
  tile_mm<S, D, NT, true, false>(tl, ZA1, T2, acc);
  tile_mm<S, D, NT, true, false>(tl, T2, ZA1, acc2);
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int i = tl.r0 + rr;
#pragma unroll
    for (int c = 0; c < Cn; ++c) {
      const int j = tl.c0 + c;
      o.m[2][rr][c] =
          (S)0.5 * ((acc[rr][c] + J1[i * ld + j]) + (acc2[rr][c] + J1[j * ld + i]));
    }
    if (tl.first()) o.v[0][rr] = row_dot<S, D, false>(A2Z, v1, i) + b2[i];
    if (tl.last()) o.v[1][rr] = row_dot<S, D, true>(ZA1, v2, i) + e1[i];
  }
}

// The filter scan's plans. D = 16: 8 prefixes, a 128-thread chain (which beat
// 32, 64 and 256), warps for the apply (64-thread teams for chunks of <= 4).
// D = 32, where (ring + 5) slots of 3520 values and a working set of 6208 a
// team must fit 227 KB: the chain on the whole block (a combine 16.6k cycles
// on an H100 against 17.2k on 128 threads in f32, 35k against 54k in f64);
// f32 7 prefixes and two 128-thread apply teams (218,624 B), f64 1 prefix and
// one 256-thread team (218,624 B; a chunk's later prefixes are staged back
// from the output, as past 8 at D = 16). D = 48 (float32), slots of 7584
// values and a working set of 13,152: f64 D = 32's plan (1 prefix, the
// chain and the apply on the whole block, 3 x 3 tiles) would take 6 slots
// and a working set, 234,624 B, 2,176 B over; with one input slot (`ins`)
// it takes 5, 204,288 B. (The host build runs every D in f64 on these plans.)
template <typename S, int D>
using FilterPlan = std::conditional_t<
    D == kNarrowD, BlockPlan<8, 128, 32, 64>,
    std::conditional_t<D == kWide48D, BlockPlan<1, 256, 256, 256, 1>,
                       std::conditional_t<sizeof(S) == 4, BlockPlan<7, 256, 128, 128>,
                                          BlockPlan<1, 256, 256, 256>>>>;

// At D = 48 the scan kernel calls the combine where the smaller instances
// inline it: each of its call sites (the chunk's two loops, the levels, the
// apply) would carry a copy of ~11 unrolled 48 x 48 products. Inlined, this
// source took 82 s to build on the H100 machine, called 64 s; the call
// costs the combine ~15% (70k -> 84k cycles on 256 threads, PERF.md).
template <typename S, int D, int NT>
AUX_CALLED void filter_combine_called(int t, int bar, const S* l, const S* r, S* w,
                                      FilterTile<S, D, NT>& o) {
  filter_combine<S, D, NT>(t, bar, l, r, w, o);
}

template <typename S, int D_>
struct FilterOp : FilterPlan<S, D_> {
  using Scalar = S;
  static constexpr int D = D_, M = 3, V = 2;
  static constexpr int work = FilterWork<D>::size;
  using View = ElemView<S, M, V>;
  // Few elements a chunk (S <= 4): the apply on the plan's wide teams.
  static AUX_HD bool wide_apply(int per) { return per <= kBlock / 64; }
  template <int NT>
  static AUX_HD void combine(int t, int bar, const S* l, const S* r, S* w,
                             ElemTile<S, D, NT, M, V>& o) {
    if constexpr (D == kWide48D)
      filter_combine_called<S, D, NT>(t, bar, l, r, w, o);
    else
      filter_combine<S, D, NT>(t, bar, l, r, w, o);
  }
};

// ---------------------------------------------------------------------------
// The affine combine
// ---------------------------------------------------------------------------

// The affine scan's plans: 8 prefixes (13 slots of 1184 values at D = 32: 123
// KB in f64; of 2544 at D = 48: 129 KB in f32) and a 128-thread chain; the
// apply on warps at D = 16, on 64-thread teams at D = 32 and 48 (a warp's
// tile of 32 entries spilled at D = 32).
template <typename S, int D_>
struct AffineOp : BlockPlan<8, 128, D_ == kNarrowD ? 32 : 64, D_ == kNarrowD ? 32 : 64> {
  using Scalar = S;
  static constexpr int D = D_, M = 1, V = 1;
  static constexpr int work = 0;
  using View = ElemView<S, M, V>;
  static AUX_HD bool wide_apply(int) { return false; }
  // o = (G2 G1, G2 e1 + e2) for l = (G1, e1), r = (G2, e2) (sampling_operator),
  // each entry summed over k ascending. No barrier.
  template <int NT>
  static AUX_HD void combine(int t, int, const S* l, const S* r, S*,
                             ElemTile<S, D, NT, M, V>& o) {
    using L = ElemLay<D, M, V>;
    const Tile<D, NT> tl(t);
    tile_mm<S, D, NT, false, false>(tl, r, l, o.m[0]);
      if (!tl.first()) return;
#pragma unroll
    for (int rr = 0; rr < Tile<D, NT>::RPT; ++rr) {
      const int i = tl.r0 + rr;
      o.v[0][rr] = row_dot<S, D, false>(r, l + L::vec, i) + r[L::vec + i];
    }
  }
};

// ---------------------------------------------------------------------------
// The skeleton's phases, on a team (thread t of NT, barrier `bar`; one
// thread in the host build)
// ---------------------------------------------------------------------------

template <class Op>
using OpLay = ElemLay<Op::D, Op::M, Op::V>;

template <class Op, int NT>
using OpTile = ElemTile<typename Op::Scalar, Op::D, NT, Op::M, Op::V>;

// Phase 1 of chunk c: the prefixes x[k0] (+) ... (+) x[k] of the chunk's
// elements, in order. The first kRing (the plan's ring) elements are staged
// by cp.async into the padded slots pre[i] at the start, so no load waits on
// the chain, and prefix i replaces element i there (the apply's first window
// reads it, and chunk 0 writes it out after the chain, window_out); past
// kRing, element i + 1 is loaded into registers while the combine of
// element i runs, stored to in[(i + 1) % ins] after it, prefix i kept in run[i & 1] and
// written to out[k] (a later window of the apply stages it from there). No
// global store precedes a barrier of the chain for i < kRing: a barrier
// waits for the team's stores to be performed. Returns the slot of the
// chunk total (pre[0] holding the identity for an empty chunk).
template <class Op, int NT>
AUX_HD typename Op::Scalar* chunk_scan(int t, int bar, const ScanPlan& pl, int c, int n, int d,
                                       Order at, typename Op::View x, typename Op::View out,
                                       typename Op::Scalar* pre, typename Op::Scalar* in,
                                       typename Op::Scalar* run0, typename Op::Scalar* run1,
                                       typename Op::Scalar* w) {
  using S = typename Op::Scalar;
  constexpr int D = Op::D, M = Op::M, V = Op::V, slot = OpLay<Op>::slot, kRing = Op::ring;
  const long k0 = (long)c * pl.per;
  const int cnt = (int)(n - k0 < pl.per ? (n - k0 > 0 ? n - k0 : 0) : pl.per);
  if (cnt == 0) {
    pad_slot<S, D, M, V>(t, NT, 0, pre);  // the identity element
    team_sync<NT>(bar);
    return pre;
  }
  const int ring = cnt < kRing ? cnt : kRing;
  for (int i = 0; i < ring; ++i)
    stage_element<S, D, M, V>(t, NT, x, at(k0 + i), d, pre + i * slot);
  Staged<S, D, NT, M, V> sv(t, d);
  if (cnt > kRing) sv.load(x, at(k0 + kRing));
  cp_async_wait_all();
  team_sync<NT>(bar);
  for (int i = 1; i < ring; ++i) {
    S* cur = pre + i * slot;
    OpTile<Op, NT> o;
    Op::template combine<NT>(t, bar, cur - slot, cur, w, o);
    team_sync<NT>(bar);  // every thread has read element i: prefix i replaces it
    store_padded(t, o, cur);
    team_sync<NT>(bar);
  }
  S* prev = pre + (ring - 1) * slot;
  for (int i = kRing; i < cnt; ++i) {
    S* in_slot = in + i % Op::ins * slot;
    sv.store(in_slot);
    if (i + 1 < cnt) sv.load(x, at(k0 + i + 1));
    team_sync<NT>(bar);
    OpTile<Op, NT> o;
    Op::template combine<NT>(t, bar, prev, in_slot, w, o);
    prev = i & 1 ? run1 : run0;
    store_padded(t, o, prev);
    store_element(t, o, out, at(k0 + i), d);
    team_sync<NT>(bar);  // every thread is done with the input and the old prefix
  }
  return prev;
}

// Chunk 0's outputs kept in its first window (the slots pre[i], i < ring),
// thread t of nt, after the chain.
template <class Op>
AUX_HD void window_out(int t, int nt, const ScanPlan& pl, int n, int d, Order at,
                       const typename Op::Scalar* pre, typename Op::View out) {
  const int cnt = pl.per < n ? pl.per : n;
  for (int i = 0; i < cnt && i < Op::ring; ++i)
    slot_to_element<typename Op::Scalar, Op::D, Op::M, Op::V>(t, nt, pre + i * OpLay<Op>::slot,
                                                             out, at(i), d);
}

// dst = partner (+) own, on the team; ends with its barrier.
template <class Op, int NT>
AUX_HD void level_combine(int t, int bar, const typename Op::Scalar* partner,
                          const typename Op::Scalar* own, typename Op::Scalar* dst,
                          typename Op::Scalar* w) {
  OpTile<Op, NT> o;
  Op::template combine<NT>(t, bar, partner, own, w, o);
  store_padded(t, o, dst);
  team_sync<NT>(bar);
}

// The apply for element k (storage index): out[k] = pre (+) prefix (the
// chunk's prefix, staged in `slot`). No barrier after: `pre`, `slot` and w
// are read until the function returns.
template <class Op, int NT>
AUX_HD void apply_element(int t, int bar, const typename Op::Scalar* pre,
                          const typename Op::Scalar* slot, typename Op::Scalar* w,
                          typename Op::View out, long k, int d) {
  OpTile<Op, NT> o;
  Op::template combine<NT>(t, bar, pre, slot, w, o);
  store_element(t, o, out, k, d);
}

}  // namespace

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// Launch section: everything above is plain C++ on pointers and also builds
// as host code (one lane, no barriers); what follows needs nvcc.
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>

namespace {

// Shared memory of a block: ring prefix slots, `ins` input slots, two
// running slots, the partner slot, then a working set for each of the
// apply's teams (the chain's is the first).
template <class Op>
constexpr size_t scan_shmem() {
  return ((Op::ring + Op::ins + 3) * (size_t)OpLay<Op>::slot + Op::teams * (size_t)Op::work) *
         sizeof(typename Op::Scalar);
}
static_assert(scan_shmem<FilterOp<float, kWideD>>() <= 232448 &&
                  scan_shmem<FilterOp<double, kWideD>>() <= 232448 &&
                  scan_shmem<AffineOp<double, kWideD>>() <= 232448 &&
                  scan_shmem<FilterOp<float, kWide48D>>() <= 232448 &&
                  scan_shmem<AffineOp<float, kWide48D>>() <= 232448,
              "the wide plans fit the 227 KB of a block");

// A hand-over: a padded slot as 64-bit words, each one 32-bit half of the
// slot's bytes and the launch's epoch. One store writes a word whole, so a
// reader that sees the epoch has the half it carries.
template <class Op>
constexpr int kHandWords = OpLay<Op>::slot * (int)sizeof(typename Op::Scalar) / 4;

// The chain's team (NT threads) publishes a slot.
template <class Op, int NT>
__device__ void publish(const typename Op::Scalar* slot, unsigned long long* dst,
                        unsigned epoch) {
  const unsigned* src = reinterpret_cast<const unsigned*>(slot);
  for (int q = threadIdx.x; q < kHandWords<Op>; q += NT) {
    const unsigned long long w = (unsigned long long)epoch << 32 | src[q];
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(dst + q), "l"(w) : "memory");
  }
}

// The chain's team: wait for each word of `src` to carry `epoch` (every
// stale word read again in one round), put the halves into the shared slot;
// ends with the team's barrier.
template <class Op, int NT>
__device__ void take(const unsigned long long* src, typename Op::Scalar* slot, unsigned epoch) {
  constexpr int words = kHandWords<Op>, per = (words + NT - 1) / NT;
  unsigned* dst = reinterpret_cast<unsigned*>(slot);
  unsigned long long w[per];
  bool stale = true;
  for (bool first = true; stale; first = false) {
#pragma unroll
    for (int i = 0; i < per; ++i) {
      const int q = threadIdx.x + i * NT;
      if (q < words && (first || (unsigned)(w[i] >> 32) != epoch))
        asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(w[i]) : "l"(src + q) : "memory");
    }
    stale = false;
#pragma unroll
    for (int i = 0; i < per; ++i) {
      const int q = threadIdx.x + i * NT;
      stale |= q < words && (unsigned)(w[i] >> 32) != epoch;
    }
  }
#pragma unroll
  for (int i = 0; i < per; ++i) {
    const int q = threadIdx.x + i * NT;
    if (q < words) dst[q] = (unsigned)w[i];
  }
  team_sync<NT>(1);
}

// The apply of the chunk's elements [i0, i1) (prefixes in ring slots from
// i0's): element i on team (i - i0) % (kBlock / NT), a team of NT threads
// (barrier 0 for a warp, else 2 + its index).
template <class Op, int NT>
__device__ void apply_window(int i0, int i1, long k0, int d, Order at,
                             const typename Op::Scalar* pre, typename Op::Scalar* ring,
                             typename Op::Scalar* work, typename Op::View out) {
  constexpr int teams = kBlock / NT;
  const int g = threadIdx.x / NT;
  for (int i = i0 + g; i < i1; i += teams)
    apply_element<Op, NT>(threadIdx.x % NT, NT == 32 ? 0 : 2 + g, pre,
                          ring + (i - i0) * OpLay<Op>::slot, work + g * Op::work, out,
                          at(k0 + i), d);
}

// The whole scan: the block's ticket q gives its chain q / chunks and its
// chunk c = q % chunks. Threads 0 .. NT - 1 run the chain (the chunk, the
// levels, the hops); then every thread takes part in the apply. `hand` holds
// (levels + 1) x chunks hand-over slots a chain (row L: the values at the
// start of level L; row levels: the inclusive totals); `state` = {ticket
// counter, blocks done, last epoch}, zeros at first, left so by each launch's
// last block, which also advances the epoch. One state serves one launch at a
// time (filter_scan.py keeps one a stream). `stamps`, if not null, takes each
// block's clock64 at its phases (diagnostics, kernel_times.py; a row a
// ticket): start, after its chunk, after each level, after the hop for the
// chunks before it, at the end.
template <class Op>
__global__ void __launch_bounds__(kBlock, 1)
scan_kernel(int n, int chains, int d, int reverse, ScanPlan pl, typename Op::View x,
            typename Op::View out, unsigned long long* hand, int* state, long long* stamps) {
  using S = typename Op::Scalar;
  constexpr int NT = Op::chain, kRing = Op::ring;
  constexpr int D = Op::D, M = Op::M, V = Op::V, slot = OpLay<Op>::slot, hw = kHandWords<Op>;
  extern __shared__ __align__(16) unsigned char smem[];
  S* ring = reinterpret_cast<S*>(smem);  // the prefixes: the apply's window
  S* in = ring + kRing * slot;           // the input slots
  S* run0 = in + Op::ins * slot;
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
  for (int g = 0; g < kRing + Op::ins; ++g) pad_slot<S, D, M, V>(t, kBlock, d, ring + g * slot);
  __syncthreads();
  const int chain = ticket / pl.chunks, c = ticket - chain * pl.chunks;
  const unsigned epoch = epoch_sh;
  const Order at{n, reverse != 0, chains, chain};
  hand += (long)chain * (pl.levels + 1) * pl.chunks * hw;  // the chain's rows
  long long* st = stamps ? stamps + (long)ticket * (pl.levels + 4) : nullptr;
  if (st && t == 0) st[0] = t0;
  const long k0 = (long)c * pl.per;
  const int cnt = (int)(n - k0 < pl.per ? (n - k0 > 0 ? n - k0 : 0) : pl.per);

  if (t < NT) {
    S* cur = chunk_scan<Op, NT>(t, 1, pl, c, n, d, at, x, out, ring, in, run0, run1, work);
    if (st && t == 0) st[1] = clock64();
    for (int L = 0; L < pl.levels; ++L) {
      const int off = 1 << L;
      unsigned long long* row = hand + (long)L * pl.chunks * hw;
      if (c + off < pl.chunks) publish<Op, NT>(cur, row + (long)c * hw, epoch);
      if (c >= off) {
        take<Op, NT>(row + (long)(c - off) * hw, partner, epoch);
        S* dst = cur == run0 ? run1 : run0;
        level_combine<Op, NT>(t, 1, partner, cur, dst, work);
        cur = dst;
      }
      if (st && t == 0) st[2 + L] = clock64();
    }
    unsigned long long* fin = hand + (long)pl.levels * pl.chunks * hw;
    if (c + 1 < pl.chunks) publish<Op, NT>(cur, fin + (long)c * hw, epoch);
    if (c > 0) take<Op, NT>(fin + (long)(c - 1) * hw, partner, epoch);
    if (st && t == 0) st[2 + pl.levels] = clock64();
  }
  __syncthreads();  // the total of the chunks before this one, to every thread
  if (c == 0) window_out<Op>(t, kBlock, pl, n, d, at, ring, out);
  if (c > 0)
    for (int i0 = 0; i0 < cnt; i0 += kRing) {
      const int i1 = i0 + kRing < cnt ? i0 + kRing : cnt;
      if (i0 > 0) {  // a later window (S > kRing): stage it now
        __syncthreads();
        for (int i = i0; i < i1; ++i)
          stage_element<S, D, M, V>(t, kBlock, out, at(k0 + i), d, ring + (i - i0) * slot);
        cp_async_wait_all();
        __syncthreads();
      }
      if (Op::wide_apply(pl.per))
        apply_window<Op, Op::wide>(i0, i1, k0, d, at, partner, ring, work, out);
      else
        apply_window<Op, Op::narrow>(i0, i1, k0, d, at, partner, ring, work, out);
    }
  if (st && t == 0) st[3 + pl.levels] = clock64();
  __syncthreads();
  if (t == 0) {
    __threadfence();
    if (atomicAdd(state + 1, 1) == chains * pl.chunks - 1) {  // the last block: reset
      state[0] = 0;
      state[1] = 0;
      state[2] = (int)epoch;
      __threadfence();
    }
  }
}

// clock64 cycles of a chain of `reps` combines l <- l (+) x[1] from l = x[0]
// on one team of NT threads (diagnostics: the candidates for the scans'
// teams; each result is the next combine's input, as on a scan's chain);
// the last result into element 0 of `out`.
template <class Op, int NT>
__global__ void __launch_bounds__(NT)
combine_cycles_kernel(int d, int reps, typename Op::View x, typename Op::View out,
                      long long* cycles) {
  using S = typename Op::Scalar;
  constexpr int D = Op::D, M = Op::M, V = Op::V, slot = OpLay<Op>::slot;
  extern __shared__ __align__(16) unsigned char smem[];
  S* l = reinterpret_cast<S*>(smem);
  S* l2 = l + slot;
  S* r = l2 + slot;
  S* w = r + slot;
  const int t = threadIdx.x;
  pad_slot<S, D, M, V>(t, NT, d, l);
  pad_slot<S, D, M, V>(t, NT, d, r);
  stage_element<S, D, M, V>(t, NT, x, 0, d, l);
  stage_element<S, D, M, V>(t, NT, x, 1, d, r);
  cp_async_wait_all();
  __syncthreads();
  OpTile<Op, NT> o;
  const long long c0 = clock64();
  for (int i = 0; i < reps; ++i) {
    Op::template combine<NT>(t, 1, l, r, w, o);
    store_padded(t, o, l2);
    team_sync<NT>(1);
    S* tmp = l;
    l = l2;
    l2 = tmp;
  }
  const long long c1 = clock64();
  store_element(t, o, out, 0, d);
  if (t == 0) cycles[0] = c1 - c0;
}

int set_shmem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <class Op>
int run_scan(int n, int chains, int d, int reverse, typename Op::View x, typename Op::View out,
             unsigned long long* hand, int* state, long long* stamps, cudaStream_t stream) {
  if (n <= 0 || chains <= 0) return (int)cudaErrorInvalidValue;
  const size_t shmem = scan_shmem<Op>();
  if (int err = set_shmem((const void*)scan_kernel<Op>, shmem)) return err;
  const ScanPlan pl = scan_plan(n);
  if ((long)chains * pl.chunks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  scan_kernel<Op><<<chains * pl.chunks, kBlock, shmem, stream>>>(n, chains, d, reverse, pl, x,
                                                                 out, hand, state, stamps);
  return (int)cudaGetLastError();
}

template <class Op, int NT>
int run_combine_cycles(int d, int reps, typename Op::View x, typename Op::View out,
                       long long* cycles, cudaStream_t stream) {
  if (reps < 1) return (int)cudaErrorInvalidValue;
  const size_t shmem = (3 * (size_t)OpLay<Op>::slot + Op::work) * sizeof(typename Op::Scalar);
  if (int err = set_shmem((const void*)combine_cycles_kernel<Op, NT>, shmem)) return err;
  combine_cycles_kernel<Op, NT><<<1, NT, shmem, stream>>>(d, reps, x, out, cycles);
  return (int)cudaGetLastError();
}

// Teams of 32-256 threads at D = 16, of 128 and 256 at D = 32 and 48 (a
// narrower team's tile of 16-36 entries a matrix would not fit its
// registers), but the filter combine at D = 48 on its chain's 256 threads
// alone (on 128 it took ~1.4x the cycles, PERF.md, and its instance was the
// longest compile of this source).
template <class Op>
int combine_cycles_on(int nt, int d, int reps, typename Op::View x, typename Op::View out,
                      long long* cycles, cudaStream_t stream) {
  if constexpr (Op::D == kNarrowD) {
    if (nt == 32) return run_combine_cycles<Op, 32>(d, reps, x, out, cycles, stream);
    if (nt == 64) return run_combine_cycles<Op, 64>(d, reps, x, out, cycles, stream);
  }
  if constexpr (!(Op::D == kWide48D && Op::M == 3))
    if (nt == 128) return run_combine_cycles<Op, 128>(d, reps, x, out, cycles, stream);
  if (nt == 256) return run_combine_cycles<Op, 256>(d, reps, x, out, cycles, stream);
  return (int)cudaErrorInvalidValue;
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(D) for the instance that takes d in S: kNarrowD up to 16, kWideD up to
// 32, in float kWide48D up to 48; cudaErrorInvalidValue for anything else
// (float64 stops at 32).
template <typename S, class F>
int on_dim(int d, F f) {
  constexpr bool f32 = std::is_same_v<S, float>;
  if (d < 1 || d > (f32 ? kWide48D : kWideD)) return (int)cudaErrorInvalidValue;
  if (d <= kNarrowD) return f(Int<kNarrowD>());
  if constexpr (f32)
    if (d > kWideD) return f(Int<kWide48D>());
  return f(Int<kWideD>());
}

}  // namespace

// The scans of `chains` chains, elements (n, chains, ...); their hand-over
// words, chains x (levels + 1) x chunks x hand words 64-bit (scan_plan), and
// state, 3 int32, zeros when first given and kept from launch to launch (one
// pair a stream, filter_scan.py).
#define AUX_DEFINE_SCANS(SUFFIX, S)                                                           \
  extern "C" int aux_filter_scan_##SUFFIX(int n, int chains, int d, S* A, S* b, S* C, S* e,   \
                                          S* J, S* oA, S* ob, S* oC, S* oe, S* oJ,            \
                                          unsigned long long* hand, int* state,               \
                                          long long* stamps, void* stream) {                  \
    return on_dim<S>(d, [&](auto D) {                                                         \
      using Op = FilterOp<S, decltype(D)::value>;                                             \
      using V = typename Op::View;                                                            \
      return run_scan<Op>(n, chains, d, 0, V{{A, C, J}, {b, e}}, V{{oA, oC, oJ}, {ob, oe}},   \
                          hand, state, stamps, (cudaStream_t)stream);                         \
    });                                                                                       \
  }                                                                                           \
  extern "C" int aux_filter_combine_cycles_##SUFFIX(int d, int nt, int reps, S* A, S* b,      \
                                                    S* C, S* e, S* J, S* oA, S* ob, S* oC,    \
                                                    S* oe, S* oJ, long long* cycles,          \
                                                    void* stream) {                           \
    return on_dim<S>(d, [&](auto D) {                                                         \
      using Op = FilterOp<S, decltype(D)::value>;                                             \
      using V = typename Op::View;                                                            \
      return combine_cycles_on<Op>(nt, d, reps, V{{A, C, J}, {b, e}},                         \
                                   V{{oA, oC, oJ}, {ob, oe}}, cycles, (cudaStream_t)stream);  \
    });                                                                                       \
  }                                                                                           \
  extern "C" int aux_affine_combine_cycles_##SUFFIX(int d, int nt, int reps, S* G, S* e,      \
                                                    S* oG, S* oe, long long* cycles,          \
                                                    void* stream) {                           \
    return on_dim<S>(d, [&](auto D) {                                                         \
      using Op = AffineOp<S, decltype(D)::value>;                                             \
      using V = typename Op::View;                                                            \
      return combine_cycles_on<Op>(nt, d, reps, V{{G}, {e}}, V{{oG}, {oe}}, cycles,           \
                                   (cudaStream_t)stream);                                     \
    });                                                                                       \
  }                                                                                           \
  extern "C" int aux_affine_scan_##SUFFIX(int n, int chains, int d, int reverse, S* G, S* e,  \
                                          S* oG, S* oe, unsigned long long* hand, int* state, \
                                          long long* stamps, void* stream) {                  \
    return on_dim<S>(d, [&](auto D) {                                                         \
      using Op = AffineOp<S, decltype(D)::value>;                                             \
      using V = typename Op::View;                                                            \
      return run_scan<Op>(n, chains, d, reverse, V{{G}, {e}}, V{{oG}, {oe}}, hand, state,     \
                          stamps, (cudaStream_t)stream);                                      \
    });                                                                                       \
  }

AUX_DEFINE_SCANS(f32, float)
AUX_DEFINE_SCANS(f64, double)
#endif  // __CUDACC__
