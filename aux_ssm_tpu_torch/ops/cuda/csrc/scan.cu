// Chunked inclusive associative scans of the auxiliary-Kalman MH step. They
// replace the Pallas scans of aux_ssm_tpu/ops/pallas/:
//
//   FilterOp scan <- filter_scan.fused_filter_scan (_chunked_scan_kernel, and
//                    _scan_kernel below T = 512: one kernel serves all T)
//   AffineOp scan <- kalman_fused.fused_affine_scan (_affine_scan_kernel), with
//                    an index-reversed variant for reverse=True
//
// The TPU kernels carry a prefix from one grid step to the next in VMEM
// scratch. Blocks on Hopper run in no order, so nothing carries between
// blocks; the scan is cut into kChunks contiguous chunks of
// S = ceil(n / kChunks) elements and runs as a sequence of launches on one
// stream, one warp (one block) per chunk:
//   1. chunk_kernel: warp c scans its chunk sequentially into the output and
//      writes the chunk total to scratch;
//   2. level_kernel, log2(kChunks) times: one Hillis-Steele level over the
//      chunk totals, double-buffered in global scratch;
//   3. apply_kernel: warp c > 0 combines the inclusive total of the chunks
//      before it into each of its elements.
// The dependent chain is 2 S + log2(kChunks) combines (23 at T = 1024), each
// a handful of d x d products shared by the 32 lanes of a warp
// (smallmat.cuh), spread over kChunks SMs. The plain twin in
// ops/cuda/filter_scan.py runs the same chunks in the same order.
#include "smallmat.cuh"

namespace {

using namespace smallmat;

constexpr int kChunks = 128;

// Filtering element (A, b, C, eta, J), SGF 2021. A view points at one element.
template <typename S>
struct FilterView {
  S *A, *b, *C, *e, *J;
};

template <typename S, int MD>
struct FilterOp {
  using Scalar = S;
  using View = FilterView<S>;
  static constexpr int kScratch = 6 * MD * MD + 4 * MD;  // shared, per warp

  static AUX_HD View at(const View& base, long k, int d) {
    return View{base.A + k * d * d, base.b + k * d, base.C + k * d * d, base.e + k * d,
                base.J + k * d * d};
  }

  static AUX_HD void set_identity(int lane, int nl, int d, View o) {
    eye(lane, nl, d, o.A);
    for (int i = lane; i < d; i += nl) o.b[i] = o.e[i] = (S)0;
    for (int i = lane; i < d * d; i += nl) o.C[i] = o.J[i] = (S)0;
    AUX_SYNC();
  }

  static AUX_HD void assign(int lane, int nl, int d, View src, View o) {
    copy(lane, nl, d * d, src.A, o.A);
    copy(lane, nl, d, src.b, o.b);
    copy(lane, nl, d * d, src.C, o.C);
    copy(lane, nl, d, src.e, o.e);
    copy(lane, nl, d * d, src.J, o.J);
  }

  // o = l (+) r (filtering_operator: one Gauss-Jordan inverse of I + C1 J2).
  // o may alias l or r: the result is built in scratch and stored last.
  static AUX_HD void combine(int lane, int nl, int d, View l, View r, View o, S* sm) {
    S *M = sm, *Z = M + MD * MD, *A2Z = Z + MD * MD, *ZA1 = A2Z + MD * MD;
    S *C = ZA1 + MD * MD, *J = C + MD * MD;
    S *b = J + MD * MD, *e = b + MD, *v = e + MD, *col = v + MD;

    mm(lane, nl, d, d, d, l.C, r.J, M);
    for (int i = lane; i < d; i += nl) M[i * d + i] += (S)1;
    AUX_SYNC();
    gj_inv(lane, nl, d, M, Z, col);
    mm(lane, nl, d, d, d, r.A, Z, A2Z);
    mm(lane, nl, d, d, d, Z, l.A, ZA1);

    S* A = M;  // M is free after the inverse
    mm(lane, nl, d, d, d, A2Z, l.A, A);

    mv(lane, nl, d, d, l.C, r.e, v);  // b = A2Z (b1 + C1 e2) + b2
    for (int i = lane; i < d; i += nl) v[i] += l.b[i];
    AUX_SYNC();
    mv(lane, nl, d, d, A2Z, v, b);
    for (int i = lane; i < d; i += nl) b[i] += r.b[i];
    AUX_SYNC();

    S* T1 = Z;  // Z is free after A2Z, ZA1
    mm_nt(lane, nl, d, d, d, l.C, r.A, T1);  // C = sym(A2Z (C1 A2^T) + C2)
    mm(lane, nl, d, d, d, A2Z, T1, C);
    for (int i = lane; i < d * d; i += nl) C[i] += r.C[i];
    AUX_SYNC();
    sym(lane, nl, d, C);

    mv(lane, nl, d, d, r.J, l.b, v);  // e = ZA1^T (e2 - J2 b1) + e1
    for (int i = lane; i < d; i += nl) v[i] = r.e[i] - v[i];
    AUX_SYNC();
    mtv(lane, nl, d, d, ZA1, v, e);
    for (int i = lane; i < d; i += nl) e[i] += l.e[i];
    AUX_SYNC();

    mm(lane, nl, d, d, d, r.J, l.A, T1);  // J = sym(ZA1^T (J2 A1) + J1)
    mm_tn(lane, nl, d, d, d, ZA1, T1, J);
    for (int i = lane; i < d * d; i += nl) J[i] += l.J[i];
    AUX_SYNC();
    sym(lane, nl, d, J);

    assign(lane, nl, d, View{A, b, C, e, J}, o);
  }
};

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

AUX_HD int chunk_len(int n) { return (n + kChunks - 1) / kChunks; }

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

// The whole scan: 2 + log2(kChunks) launches on `stream`. tot0/tot1 are
// kChunks elements of scratch each.
template <class Op>
int run_scan(int n, int d, bool reverse, typename Op::View x, typename Op::View out,
             typename Op::View tot0, typename Op::View tot1, cudaStream_t stream) {
  if (n <= 0 || d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  chunk_kernel<Op><<<kChunks, 32, 0, stream>>>(n, d, reverse, x, out, tot0);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  for (int off = 1; off < kChunks; off *= 2) {
    level_kernel<Op><<<kChunks, 32, 0, stream>>>(off, d, tot0, tot1);
    if (cudaError_t err = cudaGetLastError()) return (int)err;
    const typename Op::View t = tot0;
    tot0 = tot1;
    tot1 = t;
  }
  apply_kernel<Op><<<kChunks, 32, 0, stream>>>(n, d, reverse, tot0, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch layout: 2 * kChunks elements, each (A, b, C, e, J) block contiguous.
#define AUX_DEFINE_SCANS(SUFFIX, S)                                                          \
  extern "C" int aux_filter_scan_##SUFFIX(int n, int d, S* A, S* b, S* C, S* e, S* J,        \
                                          S* oA, S* ob, S* oC, S* oe, S* oJ, S* scratch,     \
                                          void* stream) {                                    \
    using View = FilterView<S>;                                                              \
    const long mat = (long)kChunks * d * d, vec = (long)kChunks * d;                        \
    S* s0 = scratch;                                                                         \
    S* s1 = scratch + 3 * mat + 2 * vec;                                                     \
    View t0{s0, s0 + mat, s0 + mat + vec, s0 + 2 * mat + vec, s0 + 2 * mat + 2 * vec};       \
    View t1{s1, s1 + mat, s1 + mat + vec, s1 + 2 * mat + vec, s1 + 2 * mat + 2 * vec};       \
    return run_scan<FilterOp<S, kMaxD>>(n, d, false, View{A, b, C, e, J},                    \
                                        View{oA, ob, oC, oe, oJ}, t0, t1,                    \
                                        (cudaStream_t)stream);                               \
  }                                                                                          \
  extern "C" int aux_affine_scan_##SUFFIX(int n, int d, int reverse, S* G, S* e, S* oG,      \
                                          S* oe, S* scratch, void* stream) {                 \
    using View = AffineView<S>;                                                              \
    const long mat = (long)kChunks * d * d, vec = (long)kChunks * d;                        \
    S* s1 = scratch + mat + vec;                                                             \
    return run_scan<AffineOp<S, kMaxD>>(n, d, reverse != 0, View{G, e}, View{oG, oe},        \
                                        View{scratch, scratch + mat}, View{s1, s1 + mat},    \
                                        (cudaStream_t)stream);                               \
  }

AUX_DEFINE_SCANS(f32, float)
AUX_DEFINE_SCANS(f64, double)
#endif  // __CUDACC__
