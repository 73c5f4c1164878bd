// Inclusive associative scans over time of B independent scalar filters: the
// batched (T, B, 1, 1) layout of the spatial model family, whose filtering
// elements and backward maps are plain scalars per (t, b). They replace the
// Pallas scans of aux_ssm_tpu/ops/pallas/scalar_scan.py:
//
//   ScalarFilterOp scan <- fused_scalar_filter_scan (_chunked_scan_kernel at
//                          T >= 512 and _scan_kernel below: one kernel serves
//                          all T)
//   ScalarAffineOp scan <- fused_scalar_affine_scan, with reverse=True by
//                          reversed indexing instead of flipped copies
//
// Arrays are (n, B) row-major, so consecutive b are consecutive addresses.
// What bounds it: at the published size (n = 1023, B = 64, float32) the
// filter scan moves 2.6 MB, under a microsecond of the card's memory rate;
// the time is the launch, the loads' round trips and the dependent chain of
// combines (each ~20 operations and a reciprocal). An SM's time goes with
// the sectors it moves: a block that owns whole columns moves every row's
// sector (5115 in and as many out at n = 1023 for the filter), so at T >=
// 512 on a narrow field the time axis is also cut across blocks (the split
// path); below T = 512, or where whole columns already give every SM a
// block, a block owns whole columns (the whole-column path, further down:
// no hand-over, the fixed cost of the split path's ticket, hand-over and
// per-warp scans would exceed what it saves). Every column's time axis is
// cut into kChunks contiguous chunks of S = ceil(n / kChunks) steps, one
// thread a chunk. On the split path a block serves kCols consecutive
// columns (each row's kCols values one sector in float32, two in float64)
// and one of G segments of kChunks / G chunks (scalar_segments: G doubled
// from 4 while the grid leaves SMs idle, up to 16: 128 blocks at B = 64). A
// block
//   1. loads its chunks' steps into registers, all at once (lane: column
//      fastest, 4 chunks a warp: each load one sector), and scans each chunk
//      on its thread, the prefixes kept in registers;
//   2. hands its chunk totals on: to its own warps through shared memory,
//      to the later segments of its columns through global memory (64-bit
//      words, each a 32-bit half beside the launch's epoch, as scan.cu's
//      hand-overs; a reader issues all its loads at once: one trip through
//      L2 once they are written, no fence or flag). Warp w then scans
//      column w's totals up to the block's last chunk itself (warp_pre: 4
//      a lane, shifts 1-16 by shuffles, 32 and 64 within the lane), so one
//      hand-over serves every level;
//   3. combines the total of the chunks before each chunk into its
//      prefixes, in registers, and writes each output once, coalesced.
// A block takes its segment from a ticket (an atomic counter), so it waits
// only on blocks that started before it: no co-residency is assumed. The
// buffer and the state {ticket, blocks done, epoch} are kept by the caller
// one set a stream (scalar_scan.py), and each launch's last block leaves the
// state ready for the next launch. A chunk longer than kWin (n > 1024) is
// loaded and scanned a window of kWin steps at a time; pass 3 then loads
// each window again and recomputes its prefixes. The association is the
// plain twin's (ops/cuda/scalar_scan.py, filter_scan.chunked_scan_plain with
// CHUNKS = kChunks): each chunk sequentially, the chunk totals by
// Hillis-Steele (shifts 1, 2, 4, ...), then each prefix after the total of
// the chunks before it. The TPU kernel's lane padding to 128, its
// chunk-major relayout, the sublane rolls and the carry scratch between grid
// steps are not carried over.
#ifndef AUX_HD
#define AUX_HD __device__ __forceinline__
#endif

#include <stdint.h>
#include <string.h>

#include "lanes.cuh"

namespace {

using lanes::kWarp;
using lanes::Lanes;

constexpr int kChunks = 128;         // time chunks of a column, one thread each
constexpr int kWin = 8;              // steps of a chunk a thread holds at once
constexpr int kCols = 8;             // columns of a block, one warp each in warp_pre
constexpr int kThreads = kCols * kWarp;
constexpr int kQ = kChunks / kWarp;  // chunk totals a lane holds in warp_pre
constexpr int kMinSeg = kChunks * kCols / kThreads;  // 4: a chunk thread for each (chunk, column)
constexpr int kMaxSeg = 16;          // segments of a column at most (8 chunks a block)

// Filtering element (A, b, C, eta, J) of a scalar filter (SGF 2021, Lemma 8):
// the inverse of I + C1 J2 is a reciprocal.
template <typename S>
struct ScalarFilterOp {
  using Scalar = S;
  static constexpr int kN = 5;

  static AUX_HD void identity(S* o) {
    o[0] = (S)1;
    o[1] = o[2] = o[3] = o[4] = (S)0;
  }

  // o = l (+) r; o may alias l or r.
  static AUX_HD void combine(const S* l, const S* r, S* o) {
    const S A1 = l[0], b1 = l[1], C1 = l[2], e1 = l[3], J1 = l[4];
    const S A2 = r[0], b2 = r[1], C2 = r[2], e2 = r[3], J2 = r[4];
    const S Z = (S)1 / ((S)1 + C1 * J2);
    const S A2Z = A2 * Z;
    const S ZA1 = Z * A1;
    o[0] = A2Z * A1;
    o[1] = A2Z * (b1 + C1 * e2) + b2;
    o[2] = A2Z * C1 * A2 + C2;
    o[3] = ZA1 * (e2 - J2 * b1) + e1;
    o[4] = ZA1 * J2 * A1 + J1;
  }
};

// Affine map x -> g x + e; (g1, e1) then (g2, e2) is (g2 g1, g2 e1 + e2).
template <typename S>
struct ScalarAffineOp {
  using Scalar = S;
  static constexpr int kN = 2;

  static AUX_HD void identity(S* o) {
    o[0] = (S)1;
    o[1] = (S)0;
  }

  static AUX_HD void combine(const S* l, const S* r, S* o) {
    const S g1 = l[0], e1 = l[1];
    const S g2 = r[0], e2 = r[1];
    o[0] = g2 * g1;
    o[1] = g2 * e1 + e2;
  }
};

// The kN arrays of a scan, each (n, B) row-major.
template <class Op>
struct Arrays {
  typename Op::Scalar* p[Op::kN];
};

AUX_HD int chunk_len(int n) { return (n + kChunks - 1) / kChunks; }

// Logical position k of column b -> offset in an (n, B) array (reverse scans
// run backwards in time).
AUX_HD long at(long k, int b, int n, int B, bool reverse) {
  return (reverse ? n - 1 - k : k) * B + b;
}

// The launch plan: 0 for the whole-column path (T < 512, the TPU's block
// Hillis-Steele range, or a field whose whole columns already give every SM
// a block), else the segments of a column: 4 (256 chunk threads a block),
// doubled while the grid leaves SMs idle, up to kMaxSeg.
constexpr int kSplitMinN = 512;
inline int scalar_segments(int n, int B, int sms) {
  const long groups = (B + kCols - 1) / kCols;
  if (n < kSplitMinN || groups >= sms) return 0;
  int G = kMinSeg;
  while (G < kMaxSeg && groups * G < sms) G *= 2;
  return G;
}

// The hand-over buffer of a launch: every (column, chunk)'s total as 64-bit
// words, each a 32-bit half of a value beside the launch's epoch, laid out
// [group][column in the group][chunk][value][half]; one store writes a word
// whole, so a reader that sees the epoch has the half it carries (and a
// buffer kept from an earlier launch, at any B, holds only older epochs).
template <class Op>
constexpr int kHalves = (int)sizeof(typename Op::Scalar) / 4;

template <class Op>
struct HandOver {
  unsigned long long* w;
  AUX_HD long at(int group, int bl, int c) const {
    return (((long)group * kCols + bl) * kChunks + c) * Op::kN * kHalves<Op>;
  }
};

template <class Op>
inline long scalar_hand_words(int B) {
  return (long)(B + kCols - 1) / kCols * kCols * kChunks * Op::kN * kHalves<Op>;
}

// One block's place: column group, segment g of G (chunks g CPS .. + CPS -
// 1), the launch's epoch.
struct Seg {
  int group, g, G, CPS;
  unsigned epoch;
  AUX_HD Seg(int ticket, int G_, unsigned epoch_)
      : group(ticket / G_), g(ticket % G_), G(G_), CPS(kChunks / G_), epoch(epoch_) {}
};

// The block's shared memory: its chunk totals and the totals before each
// of its chunks, [value][column][local chunk].
template <class Op>
struct ScanShared {
  typename Op::Scalar tot[Op::kN][kCols][kChunks / kMinSeg];
  typename Op::Scalar pre[Op::kN][kCols][kChunks / kMinSeg];
};

// A chunk thread: column b, chunk c, its steps k0 .. k0 + len - 1.
struct ChunkAt {
  int bl, cl, b, c, len;
  long k0;
  AUX_HD ChunkAt(int t, const Seg& sg, int n, int B) {
    bl = t % kCols;
    cl = t / kCols;
    b = sg.group * kCols + bl;
    c = sg.g * sg.CPS + cl;
    const int S = chunk_len(n);
    k0 = (long)c * S;
    const long rem = b < B ? n - k0 : 0;
    len = rem <= 0 ? 0 : rem < S ? (int)rem : S;
  }
};

// Steps [w kWin, w kWin + cnt) of the chunk into v (all loads first), then
// the running prefix through them: v[s] the prefix after step s, `run` the
// last; the chunk's first step starts the prefix.
template <class Op>
AUX_HD void window_scan(const ChunkAt& ch, int w, int cnt, int n, int B, bool reverse,
                        const Arrays<Op>& x, typename Op::Scalar (&v)[kWin][Op::kN],
                        typename Op::Scalar* run) {
#pragma unroll
  for (int s = 0; s < kWin; ++s)
    if (s < cnt) {
      const long i = at(ch.k0 + w * kWin + s, ch.b, n, B, reverse);
#pragma unroll
      for (int a = 0; a < Op::kN; ++a) v[s][a] = x.p[a][i];
    }
#pragma unroll
  for (int s = 0; s < kWin; ++s) {
    if (s < cnt) {
      if (w == 0 && s == 0) {
#pragma unroll
        for (int a = 0; a < Op::kN; ++a) run[a] = v[0][a];
      } else {
        Op::combine(run, v[s], run);
#pragma unroll
        for (int a = 0; a < Op::kN; ++a) v[s][a] = run[a];
      }
    }
  }
}

AUX_HD int window_count(const ChunkAt& ch, int w) {
  const int rem = ch.len - w * kWin;
  return rem <= 0 ? 0 : rem < kWin ? rem : kWin;
}

// Pass 1 of a chunk thread: its chunk's prefixes (v: those of its last
// window) and total (`run`, the identity for an empty chunk).
template <class Op>
AUX_HD void chunk_scan(const ChunkAt& ch, int n, int B, bool reverse, const Arrays<Op>& x,
                       typename Op::Scalar (&v)[kWin][Op::kN], typename Op::Scalar* run) {
  Op::identity(run);
  for (int w = 0; w * kWin < ch.len; ++w)
    window_scan<Op>(ch, w, window_count(ch, w), n, B, reverse, x, v, run);
}

// A hand-over word's store and load: relaxed at the card's scope, one
// trip through L2, no fence.
AUX_HD void store_word(unsigned long long* p, unsigned long long w) {
#ifdef __CUDA_ARCH__
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
#else
  *p = w;
#endif
}
AUX_HD unsigned long long load_word(const unsigned long long* p) {
#ifdef __CUDA_ARCH__
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
  return w;
#else
  return *p;
#endif
}

// A chunk thread's total: into shared memory for its own block, and, unless
// its segment is the column's last, into the hand-over words.
template <class Op>
AUX_HD void publish_total(const ChunkAt& ch, const Seg& sg, const typename Op::Scalar* run,
                          ScanShared<Op>& sh, const HandOver<Op>& ho) {
  using S = typename Op::Scalar;
  constexpr int H = kHalves<Op>;
#pragma unroll
  for (int a = 0; a < Op::kN; ++a) sh.tot[a][ch.bl][ch.cl] = run[a];
  if (sg.g + 1 < sg.G) {
    unsigned long long* dst = ho.w + ho.at(sg.group, ch.bl, ch.c);
#pragma unroll
    for (int a = 0; a < Op::kN; ++a) {
      uint32_t h[H];
      memcpy(h, &run[a], sizeof(S));
#pragma unroll
      for (int i = 0; i < H; ++i)
        store_word(dst + a * H + i, (unsigned long long)sg.epoch << 32 | h[i]);
    }
  }
}

// x[q] <- l (+) x[q] on lane `lane`, the operands (Lanes) given by array.
template <class Op>
AUX_HD void lane_combine(int lane, const Lanes<typename Op::Scalar>* l,
                         Lanes<typename Op::Scalar>* r) {
  typename Op::Scalar a[Op::kN], b[Op::kN];
#pragma unroll
  for (int i = 0; i < Op::kN; ++i) a[i] = l[i][lane], b[i] = r[i][lane];
  Op::combine(a, b, b);
#pragma unroll
  for (int i = 0; i < Op::kN; ++i) r[i][lane] = b[i];
}

// Warp bl of the block: column bl's chunk totals up to the block's last
// chunk, lane l holding positions l + 32 q (q <= Q): the earlier segments'
// from the hand-over words (all read at once, then the stale ones again
// until each carries the launch's epoch), the block's own from shared
// memory; then Hillis-Steele over them in the plain twin's association
// (shifts 1-16 cross lanes, one shuffle a position: lane l < o takes
// position q - 1 of lane l - o + 32; shifts 32 and 64 stay inside the lane;
// a position needs only those below it; every lane combines and a select
// keeps position l < o of q = 0 as it was, so the warp does not diverge).
// sh.pre[.][bl][cl] <- the inclusive total of the chunks before the block's
// chunk cl (position g CPS + cl - 1; unset for chunk 0).
template <class Op>
AUX_HD void warp_pre(int bl, const Seg& sg, ScanShared<Op>& sh, const HandOver<Op>& ho) {
  using S = typename Op::Scalar;
  constexpr int N = Op::kN, H = kHalves<Op>;
  const int p0 = sg.g * sg.CPS, p_hi = p0 + sg.CPS - 2, Q = p_hi / kWarp;
  Lanes<S> x[kQ][N];
  FOR_LANES(l) {
    unsigned long long w[kQ][N * H];
    unsigned hand = 0;  // bit q: position l + 32 q comes from the hand-over
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      if (q <= Q && q * kWarp + l < p0) hand |= 1u << q;
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      if (hand >> q & 1) {
        const unsigned long long* src = ho.w + ho.at(sg.group, bl, q * kWarp + l);
#pragma unroll
        for (int i = 0; i < N * H; ++i) w[q][i] = load_word(src + i);
      }
    for (bool stale = true; stale;) {
      stale = false;
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (hand >> q & 1) {
          const unsigned long long* src = ho.w + ho.at(sg.group, bl, q * kWarp + l);
#pragma unroll
          for (int i = 0; i < N * H; ++i)
            if ((unsigned)(w[q][i] >> 32) != sg.epoch) {
              w[q][i] = load_word(src + i);
              stale = true;
            }
        }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int p = q * kWarp + l;
      if (q > Q) continue;
      S v[N];
      if (hand >> q & 1) {
#pragma unroll
        for (int a = 0; a < N; ++a) {
          uint32_t h[H];
#pragma unroll
          for (int i = 0; i < H; ++i) h[i] = (uint32_t)w[q][a * H + i];
          memcpy(&v[a], h, sizeof(S));
        }
      } else if (p < p0 + sg.CPS) {
#pragma unroll
        for (int a = 0; a < N; ++a) v[a] = sh.tot[a][bl][p - p0];
      } else {
        Op::identity(v);  // past the block's chunks: no position it needs reads it
      }
#pragma unroll
      for (int a = 0; a < N; ++a) x[q][a][l] = v[a];
    }
  }
#pragma unroll
  for (int o = 1; o < kWarp; o *= 2) {
    Lanes<S> y[kQ][N];
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      if (q <= Q)
#pragma unroll
        for (int a = 0; a < N; ++a)
          y[q][a] = lanes::shfl(x[q][a], [o](int l) { return (l - o) & (kWarp - 1); });
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      if (q <= Q)
        FOR_LANES(l) {
          S left[N], right[N], c[N];
#pragma unroll
          for (int a = 0; a < N; ++a) {
            left[a] = l >= o ? y[q][a][l] : y[q > 0 ? q - 1 : 0][a][l];
            right[a] = x[q][a][l];
          }
          Op::combine(left, right, c);
          const bool take = q > 0 || l >= o;
#pragma unroll
          for (int a = 0; a < N; ++a) x[q][a][l] = take ? c[a] : right[a];
        }
  }
#pragma unroll
  for (int d = 1; d < kQ; d *= 2)
#pragma unroll
    for (int q = kQ - 1; q >= d; --q)
      if (q <= Q) FOR_LANES(l) lane_combine<Op>(l, x[q - d], x[q]);
  FOR_LANES(l) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int p = q * kWarp + l;
      if (q <= Q && p >= p0 - 1 && p <= p_hi)
#pragma unroll
        for (int a = 0; a < N; ++a) sh.pre[a][bl][p + 1 - p0] = x[q][a][l];
    }
  }
}

// Pass 3 of a chunk thread: each prefix after the total of the chunks before
// its chunk (chunk 0 keeps its own), written once. One window: the
// prefixes in v; else each window loaded and scanned again.
template <class Op>
AUX_HD void chunk_apply(const ChunkAt& ch, int n, int B, bool reverse, const Arrays<Op>& x,
                        const ScanShared<Op>& sh, typename Op::Scalar (&v)[kWin][Op::kN],
                        const Arrays<Op>& out) {
  using S = typename Op::Scalar;
  S pre[Op::kN], run[Op::kN];
#pragma unroll
  for (int a = 0; a < Op::kN; ++a) pre[a] = sh.pre[a][ch.bl][ch.cl];
  const bool one = ch.len <= kWin;
  for (int w = 0; w * kWin < ch.len; ++w) {
    const int cnt = window_count(ch, w);
    if (!one) window_scan<Op>(ch, w, cnt, n, B, reverse, x, v, run);
#pragma unroll
    for (int s = 0; s < kWin; ++s) {
      if (s < cnt) {
        if (ch.c > 0) Op::combine(pre, v[s], v[s]);
        const long i = at(ch.k0 + w * kWin + s, ch.b, n, B, reverse);
#pragma unroll
        for (int a = 0; a < Op::kN; ++a) out.p[a][i] = v[s][a];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The whole-column path (scalar_segments = 0): a block owns kColLanes
// consecutive columns whole (threadIdx.x, a row's kColLanes values one
// sector in float32) and their kChunks chunks (threadIdx.y): no hand-over
// between blocks. A thread loads its chunk's steps at once and scans them,
// the prefixes kept in registers where the chunk fits one window of
// kColWin steps (T <= 128 kColWin: every T below 512 but the float64
// filter's); a longer chunk is
// scanned a window at a time, its prefixes parked in `out` (the thread's
// own stores, read back by it in pass 3). The chunk totals by Hillis-Steele
// in shared memory, each level reading one buffer and writing the other
// (one barrier a level); then each prefix after the total of the chunks
// before the chunk, written once.
// ---------------------------------------------------------------------------

constexpr int kColLanes = 8;  // consecutive columns of a whole-column block

// Steps of a window, as many as 64 registers a thread (1024 threads a
// block) hold without spilling: 4 in float32; in float64 2 of the filter's
// five values, 3 of the affine map's two (8 of those spilled 184 bytes).
template <class Op>
constexpr int kColWin = sizeof(typename Op::Scalar) == 4 ? 4 : Op::kN > 2 ? 2 : 3;

// The steps [w0, w0 + cnt) of column b into v, all loads at once.
template <class Op>
AUX_HD void cols_load(long w0, int cnt, int b, int n, int B, bool reverse, const Arrays<Op>& src,
                      typename Op::Scalar (&v)[kColWin<Op>][Op::kN]) {
#pragma unroll
  for (int s = 0; s < kColWin<Op>; ++s)
    if (s < cnt)
#pragma unroll
      for (int a = 0; a < Op::kN; ++a) v[s][a] = src.p[a][at(w0 + s, b, n, B, reverse)];
}

template <class Op>
AUX_HD void cols_store(long w0, int cnt, int b, int n, int B, bool reverse,
                       const typename Op::Scalar (&v)[kColWin<Op>][Op::kN], const Arrays<Op>& dst) {
#pragma unroll
  for (int s = 0; s < kColWin<Op>; ++s)
    if (s < cnt) {
      const long i = at(w0 + s, b, n, B, reverse);
#pragma unroll
      for (int a = 0; a < Op::kN; ++a) dst.p[a][i] = v[s][a];
    }
}

// Pass 1 of chunk c of column b: tot its total (the identity for an empty
// chunk); the prefixes in v (one window) or parked in out (several).
template <class Op>
AUX_HD void cols_scan(int c, int b, int n, int B, bool reverse, const Arrays<Op>& x,
                      const Arrays<Op>& out, typename Op::Scalar (&v)[kColWin<Op>][Op::kN],
                      typename Op::Scalar* tot) {
  constexpr int W = kColWin<Op>;
  const int len = chunk_len(n);
  const long k0 = (long)c * len, k1 = k0 + len < n ? k0 + len : n;
  Op::identity(tot);
  for (long w0 = k0; w0 < k1; w0 += W) {
    const int cnt = k1 - w0 < W ? (int)(k1 - w0) : W;
    cols_load<Op>(w0, cnt, b, n, B, reverse, x, v);
#pragma unroll
    for (int s = 0; s < W; ++s) {
      if (s < cnt) {
        if (w0 == k0 && s == 0) {
#pragma unroll
          for (int a = 0; a < Op::kN; ++a) tot[a] = v[0][a];
        } else {
          Op::combine(tot, v[s], tot);
#pragma unroll
          for (int a = 0; a < Op::kN; ++a) v[s][a] = tot[a];
        }
      }
    }
    if (len > W) cols_store<Op>(w0, cnt, b, n, B, reverse, v, out);
  }
}

// Pass 3 of chunk c of column b: out[k] = pre (+) prefix[k] (chunk 0: the
// prefix), from v (one window) or from the parked prefixes.
template <class Op>
AUX_HD void cols_apply(int c, int b, int n, int B, bool reverse, const typename Op::Scalar* pre,
                       typename Op::Scalar (&v)[kColWin<Op>][Op::kN], const Arrays<Op>& out) {
  constexpr int W = kColWin<Op>;
  const int len = chunk_len(n);
  const long k0 = (long)c * len, k1 = k0 + len < n ? k0 + len : n;
  for (long w0 = k0; w0 < k1; w0 += W) {
    const int cnt = k1 - w0 < W ? (int)(k1 - w0) : W;
    if (len > W) cols_load<Op>(w0, cnt, b, n, B, reverse, out, v);
    if (c > 0)
#pragma unroll
      for (int s = 0; s < W; ++s)
        if (s < cnt) Op::combine(pre, v[s], v[s]);
    if (c > 0 || len <= W) cols_store<Op>(w0, cnt, b, n, B, reverse, v, out);
  }
}

// The totals of a whole-column block in shared memory, two buffers of
// [value][chunk][lane].
template <class Op>
struct ColsTot {
  typename Op::Scalar t[2][Op::kN][kChunks][kColLanes];
};

// Level L (shift 2^L) of the totals' Hillis-Steele for chunk c of lane l:
// acc <- buffer L % 2 at c - 2^L (+) acc where c >= 2^L, written to buffer
// (L + 1) % 2. The block's threads call it between two barriers.
template <class Op>
AUX_HD void cols_level(int L, int c, int l, ColsTot<Op>& sh, typename Op::Scalar* acc) {
  const int off = 1 << L;
  if (c >= off) {
    typename Op::Scalar left[Op::kN];
#pragma unroll
    for (int a = 0; a < Op::kN; ++a) left[a] = sh.t[L % 2][a][c - off][l];
    Op::combine(left, acc, acc);
  }
#pragma unroll
  for (int a = 0; a < Op::kN; ++a) sh.t[(L + 1) % 2][a][c][l] = acc[a];
}

constexpr int kColLevels = 7;  // log2(kChunks): the last level writes buffer 1

}  // namespace

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// Launch section: everything above is plain C++ on pointers and also builds
// as host code (one thread at a time, a warp's lanes in turn); what follows
// needs nvcc.
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>

namespace {

// One block a (column group, segment), taken by ticket: threads t < kCols
// CPS one chunk each (column t % kCols); warp w the totals' scan of column
// w. `hand`: scalar_hand_words words (HandOver); `state` = {ticket counter,
// blocks done, last epoch}, zeros at first, left so by each launch's last
// block, which also advances the epoch.
template <class Op>
__global__ void __launch_bounds__(kThreads)
scalar_scan_kernel(int n, int B, bool reverse, int G, Arrays<Op> x, Arrays<Op> out,
                   unsigned long long* hand, int* state) {
  using S = typename Op::Scalar;
  __shared__ ScanShared<Op> sh;
  __shared__ int ticket;
  __shared__ unsigned epoch_sh;
  const int t = threadIdx.x;
  if (t == 0) {
    ticket = atomicAdd(state, 1);
    epoch_sh = *reinterpret_cast<volatile unsigned*>(state + 2) + 1;
  }
  __syncthreads();
  const Seg sg(ticket, G, epoch_sh);
  const HandOver<Op> ho{hand};
  const bool chunk = t < kCols * sg.CPS;
  const ChunkAt ch(t, sg, n, B);
  S v[kWin][Op::kN], run[Op::kN];
  if (chunk) {
    chunk_scan<Op>(ch, n, B, reverse, x, v, run);
    publish_total<Op>(ch, sg, run, sh, ho);
  }
  __syncthreads();
  warp_pre<Op>(t / kWarp, sg, sh, ho);
  __syncthreads();
  if (chunk) chunk_apply<Op>(ch, n, B, reverse, x, sh, v, out);
  if (t == 0) {
    __threadfence();
    if (atomicAdd(state + 1, 1) == (int)gridDim.x - 1) {  // the last block: ready the next launch
      state[0] = 0;
      state[1] = 0;
      state[2] = (int)sg.epoch;
      __threadfence();
    }
  }
}

// The whole-column path: columns blockIdx.x kColLanes + threadIdx.x, chunk
// threadIdx.y. Dynamic shared memory: ColsTot<Op>.
template <class Op>
__global__ void __launch_bounds__(kChunks * kColLanes)
scalar_cols_kernel(int n, int B, bool reverse, Arrays<Op> x, Arrays<Op> out) {
  using S = typename Op::Scalar;
  static_assert(1 << kColLevels == kChunks && kColLevels % 2 == 1, "the last level writes t[1]");
  extern __shared__ __align__(16) unsigned char smem[];
  ColsTot<Op>& sh = *reinterpret_cast<ColsTot<Op>*>(smem);
  const int l = threadIdx.x, c = threadIdx.y;
  const int b = blockIdx.x * kColLanes + l;
  const bool live = b < B;
  S v[kColWin<Op>][Op::kN], acc[Op::kN];
  if (live)
    cols_scan<Op>(c, b, n, B, reverse, x, out, v, acc);
  else
    Op::identity(acc);
  for (int a = 0; a < Op::kN; ++a) sh.t[0][a][c][l] = acc[a];
  __syncthreads();
  for (int L = 0; L < kColLevels; ++L) {
    cols_level<Op>(L, c, l, sh, acc);
    __syncthreads();
  }
  if (live) {
    S pre[Op::kN];
    for (int a = 0; a < Op::kN; ++a) pre[a] = sh.t[1][a][c > 0 ? c - 1 : 0][l];
    cols_apply<Op>(c, b, n, B, reverse, pre, v, out);
  }
}

template <class Op>
int run_scalar_scan(int n, int B, bool reverse, const Arrays<Op>& x, const Arrays<Op>& out,
                    unsigned long long* hand, int* state, cudaStream_t stream) {
  if (n <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int G = scalar_segments(n, B, sms);
  if (G == 0) {
    auto kernel = scalar_cols_kernel<Op>;
    const size_t smem = sizeof(ColsTot<Op>);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<(B + kColLanes - 1) / kColLanes, dim3(kColLanes, kChunks), smem, stream>>>(
        n, B, reverse, x, out);
  } else {
    if (!hand || !state) return (int)cudaErrorInvalidValue;  // the caller sized no hand-over
    const int blocks = (B + kCols - 1) / kCols * G;
    scalar_scan_kernel<Op><<<blocks, kThreads, 0, stream>>>(n, B, reverse, G, x, out, hand,
                                                            state);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define AUX_DEFINE_SCALAR_SCANS(SUFFIX, S)                                                   \
  extern "C" int aux_scalar_filter_scan_##SUFFIX(int n, int B, S* A, S* b, S* C, S* e, S* J, \
                                                 S* oA, S* ob, S* oC, S* oe, S* oJ,          \
                                                 unsigned long long* hand, int* state,       \
                                                 void* stream) {                             \
    using Op = ScalarFilterOp<S>;                                                            \
    return run_scalar_scan<Op>(n, B, false, Arrays<Op>{{A, b, C, e, J}},                     \
                               Arrays<Op>{{oA, ob, oC, oe, oJ}}, hand, state,                \
                               (cudaStream_t)stream);                                        \
  }                                                                                          \
  extern "C" int aux_scalar_affine_scan_##SUFFIX(int n, int B, int reverse, S* g, S* e,      \
                                                 S* og, S* oe, unsigned long long* hand,     \
                                                 int* state, void* stream) {                 \
    using Op = ScalarAffineOp<S>;                                                            \
    return run_scalar_scan<Op>(n, B, reverse != 0, Arrays<Op>{{g, e}}, Arrays<Op>{{og, oe}}, \
                               hand, state, (cudaStream_t)stream);                           \
  }

AUX_DEFINE_SCALAR_SCANS(f32, float)
AUX_DEFINE_SCALAR_SCANS(f64, double)
#endif  // __CUDACC__
