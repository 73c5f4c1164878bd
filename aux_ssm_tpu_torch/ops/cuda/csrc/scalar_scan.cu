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
// the time is the dependent chain of combines (each ~20 operations and a
// reciprocal) and the launch. So the whole scan is ONE launch with no global
// scratch: a block owns kLanes consecutive b (threadIdx.x, coalesced) and
// cuts time into kChunks contiguous chunks of S = ceil(n / kChunks) steps
// (threadIdx.y); each thread
//   1. scans its chunk sequentially, the running prefix in registers and the
//      prefixes parked in the output;
//   2. joins a Hillis-Steele scan of the chunk totals in shared memory
//      (log2(kChunks) levels);
//   3. combines the inclusive total of the chunks before its own into each of
//      its outputs.
// The chain is 2 S + log2(kChunks) combines (23 at n = 1023), and a grid over
// b-tiles spreads larger fields over the card. The TPU kernel's lane padding
// to 128, its chunk-major relayout, the sublane rolls and the carry scratch
// between grid steps are not carried over. The plain twin in
// ops/cuda/scalar_scan.py runs the same chunks in the same order.
#ifndef AUX_HD
#define AUX_HD __device__ __forceinline__
#endif

namespace {

constexpr int kChunks = 128;  // time chunks of a block (threadIdx.y)
constexpr int kLanes = 8;     // consecutive b of a block (threadIdx.x)

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

// Logical position k of lane b -> offset in an (n, B) array (reverse scans run
// backwards in time).
AUX_HD long at(long k, int b, int n, int B, bool reverse) {
  return (reverse ? n - 1 - k : k) * B + b;
}

// Pass 1 for chunk c of lane b: out[k] = x[k0] (+) ... (+) x[k] within the
// chunk; tot = the chunk's total (the identity for an empty chunk).
template <class Op>
AUX_HD void scan_chunk(int c, int b, int n, int B, bool reverse, const Arrays<Op>& x,
                       const Arrays<Op>& out, typename Op::Scalar* tot) {
  using S = typename Op::Scalar;
  const int len = chunk_len(n);
  const long k0 = (long)c * len;
  const long k1 = k0 + len < n ? k0 + len : n;
  Op::identity(tot);
  for (long k = k0; k < k1; ++k) {
    const long i = at(k, b, n, B, reverse);
    S v[Op::kN];
    for (int a = 0; a < Op::kN; ++a) v[a] = x.p[a][i];
    if (k == k0)
      for (int a = 0; a < Op::kN; ++a) tot[a] = v[a];
    else
      Op::combine(tot, v, tot);
    for (int a = 0; a < Op::kN; ++a) out.p[a][i] = tot[a];
  }
}

// Pass 3 for chunk c > 0 of lane b: out[k] = pre (+) out[k], pre the inclusive
// total of the chunks before c.
template <class Op>
AUX_HD void scan_apply(int c, int b, int n, int B, bool reverse,
                       const typename Op::Scalar* pre, const Arrays<Op>& out) {
  using S = typename Op::Scalar;
  const int len = chunk_len(n);
  const long k0 = (long)c * len;
  const long k1 = k0 + len < n ? k0 + len : n;
  for (long k = k0; k < k1; ++k) {
    const long i = at(k, b, n, B, reverse);
    S v[Op::kN];
    for (int a = 0; a < Op::kN; ++a) v[a] = out.p[a][i];
    Op::combine(pre, v, v);
    for (int a = 0; a < Op::kN; ++a) out.p[a][i] = v[a];
  }
}

}  // namespace

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// Launch section: everything above is plain C++ on pointers and also builds
// as host code (one thread at a time); what follows needs nvcc.
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>

namespace {

template <class Op>
__global__ void __launch_bounds__(kChunks * kLanes)
scalar_scan_kernel(int n, int B, bool reverse, Arrays<Op> x, Arrays<Op> out) {
  using S = typename Op::Scalar;
  // The running inclusive totals of the chunks, one row a chunk.
  __shared__ S tot[Op::kN][kChunks][kLanes];
  const int l = threadIdx.x, c = threadIdx.y;
  const int b = blockIdx.x * kLanes + l;
  const bool live = b < B;

  S acc[Op::kN];
  if (live)
    scan_chunk<Op>(c, b, n, B, reverse, x, out, acc);
  else
    Op::identity(acc);
  for (int a = 0; a < Op::kN; ++a) tot[a][c][l] = acc[a];
  __syncthreads();

  for (int off = 1; off < kChunks; off *= 2) {
    if (c >= off) {
      S left[Op::kN];
      for (int a = 0; a < Op::kN; ++a) left[a] = tot[a][c - off][l];
      Op::combine(left, acc, acc);
    }
    __syncthreads();  // every read of this level is done
    for (int a = 0; a < Op::kN; ++a) tot[a][c][l] = acc[a];
    __syncthreads();
  }

  if (live && c > 0) {
    S pre[Op::kN];
    for (int a = 0; a < Op::kN; ++a) pre[a] = tot[a][c - 1][l];
    scan_apply<Op>(c, b, n, B, reverse, pre, out);
  }
}

template <class Op>
int run_scalar_scan(int n, int B, bool reverse, const Arrays<Op>& x, const Arrays<Op>& out,
                    cudaStream_t stream) {
  if (n <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kLanes, kChunks);
  const dim3 grid((B + kLanes - 1) / kLanes);
  scalar_scan_kernel<Op><<<grid, block, 0, stream>>>(n, B, reverse, x, out);
  return (int)cudaGetLastError();
}

}  // namespace

#define AUX_DEFINE_SCALAR_SCANS(SUFFIX, S)                                                   \
  extern "C" int aux_scalar_filter_scan_##SUFFIX(int n, int B, S* A, S* b, S* C, S* e, S* J, \
                                                 S* oA, S* ob, S* oC, S* oe, S* oJ,          \
                                                 void* stream) {                             \
    using Op = ScalarFilterOp<S>;                                                            \
    return run_scalar_scan<Op>(n, B, false, Arrays<Op>{{A, b, C, e, J}},                     \
                               Arrays<Op>{{oA, ob, oC, oe, oJ}}, (cudaStream_t)stream);      \
  }                                                                                          \
  extern "C" int aux_scalar_affine_scan_##SUFFIX(int n, int B, int reverse, S* g, S* e,      \
                                                 S* og, S* oe, void* stream) {               \
    using Op = ScalarAffineOp<S>;                                                            \
    return run_scalar_scan<Op>(n, B, reverse != 0, Arrays<Op>{{g, e}}, Arrays<Op>{{og, oe}}, \
                               (cudaStream_t)stream);                                        \
  }

AUX_DEFINE_SCALAR_SCANS(f32, float)
AUX_DEFINE_SCALAR_SCANS(f64, double)
#endif  // __CUDACC__
