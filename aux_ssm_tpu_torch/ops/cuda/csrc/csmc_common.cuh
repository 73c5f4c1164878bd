// Block-wide collectives of the cSMC sweeps (csmc_fwd.cu, csmc_lane.cu,
// csmc_block_lane.cu):
// prefix sums, max and sum over the particles, and the inverse-CDF count.
//
// One thread block runs a whole sweep. Thread tid of nt owns particles
// tid, tid + nt, ... for per-particle work and the contiguous chunk
// [tid * ceil(N / nt), ...) for the prefix sum. On the card nt is a multiple
// of 32 (at most 1024) and the collectives combine warps with shuffles and
// one shared array of 33 partials; built as host C++ (nt = 1, AUX_BSYNC()
// empty) they reduce to the sequential loops, which is how the CPU tests run
// the sweeps' arithmetic. Work shared by the AUX_LANES lanes of one warp
// (lane l owns components l, l + AUX_LANES, ...) is fenced by AUX_WSYNC();
// the host build has one lane and no fence.
#pragma once

#ifndef AUX_HD
#define AUX_HD __device__ __forceinline__
#endif
// Sizing helpers that the launchers call on the host as well.
#ifndef AUX_HHD
#ifdef __CUDACC__
#define AUX_HHD __host__ __device__ inline
#else
#define AUX_HHD inline
#endif
#endif
#ifndef AUX_BSYNC
#define AUX_BSYNC() __syncthreads()
#endif
#ifndef AUX_LANES
#define AUX_LANES 32
#endif
#ifndef AUX_WSYNC
#define AUX_WSYNC() __syncwarp()
#endif

#ifdef __CUDACC__
#include <math.h>
#else
#include <cmath>
using std::exp;
using std::fmax;
using std::isinf;
using std::isnan;
using std::log;
using std::log1p;
using std::sqrt;
#endif

namespace csmc {

template <typename S>
struct Block {
  int tid, nt;
  S* red;  // shared scratch of at least 33 entries
};

template <typename T>
AUX_HD T imin(T a, T b) { return a < b ? a : b; }

template <typename S>
AUX_HD S neg_inf() { return -(S)INFINITY; }

template <typename S>
AUX_HD S nan_to_num(S x) {
  // jnp.nan_to_num: NaN -> 0, +-inf -> +-max of the type.
  const S big = sizeof(S) == 4 ? (S)3.4028234663852886e38 : (S)1.7976931348623157e308;
  if (isnan(x)) return (S)0;
  if (isinf(x)) return x > 0 ? big : -big;
  return x;
}

// #{i : a[i] < v} for a nondecreasing a[0..N): a lower-bound binary search,
// the count jnp.searchsorted(a, v) (side='left') and the Pallas rank count give.
template <typename S>
AUX_HD int count_less(const S* a, int N, S v) {
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <typename S>
AUX_HD S dot(const S* a, const S* b, int k) {
  S s = 0;
  for (int i = 0; i < k; ++i) s += a[i] * b[i];
  return s;
}

#ifdef __CUDACC__
constexpr unsigned kFull = 0xffffffffu;

// max (kMax) or sum of v over the block; every thread gets the result.
template <bool kMax, typename S>
__device__ S block_all(const Block<S>& b, S v) {
  const int lane = b.tid & 31, warp = b.tid >> 5, nw = b.nt >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const S y = __shfl_xor_sync(kFull, v, o);
    v = kMax ? fmax(v, y) : v + y;
  }
  if (lane == 0) b.red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    S x = lane < nw ? b.red[lane] : (kMax ? neg_inf<S>() : (S)0);
    for (int o = 16; o > 0; o >>= 1) {
      const S y = __shfl_xor_sync(kFull, x, o);
      x = kMax ? fmax(x, y) : x + y;
    }
    if (lane == 0) b.red[32] = x;
  }
  __syncthreads();
  const S r = b.red[32];
  __syncthreads();  // b.red is free again for the next collective
  return r;
}

// Sum of v over the lanes of a warp; every lane gets the result.
template <typename S>
__device__ S warp_sum(S v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Max of v over the lanes of a warp; every lane gets the result.
template <typename S>
__device__ S warp_max(S v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Inclusive prefix sum of v over the lanes of a warp (lane `lane`).
template <typename S>
__device__ S warp_scan(S v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const S y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// v of the warp's last lane, on every lane.
template <typename S>
__device__ S warp_last(S v) { return __shfl_sync(kFull, v, 31); }
#else
template <bool kMax, typename S>
AUX_HD S block_all(const Block<S>&, S v) { return v; }  // nt == 1
template <typename S>
AUX_HD S warp_sum(S v) { return v; }  // one lane
template <typename S>
AUX_HD S warp_max(S v) { return v; }
template <typename S>
AUX_HD S warp_scan(S v, int) { return v; }
template <typename S>
AUX_HD S warp_last(S v) { return v; }
#endif

// count_less for N <= 32 by the lanes of one warp together: one ballot on
// the card (all 32 lanes call it), the binary search in the host build.
template <typename S>
AUX_HD int warp_count_less(const S* a, int N, S v, int lane) {
#ifdef __CUDA_ARCH__
  return __popc(__ballot_sync(kFull, lane < N && a[lane] < v));
#else
  (void)lane;
  return count_less(a, N, v);
#endif
}

// One-warp sweeps (N <= kWarpN): lane l holds particles l kPer ...; on the
// card one each, in the host build's one lane all of them.
constexpr int kWarpN = 32;
constexpr int kPer = kWarpN / AUX_LANES;

// Entry idx of the values the lanes hold (lane l the entries l kPer ...), on
// every lane.
template <typename S>
AUX_HD S lane_value(const S (&v)[kPer], int idx) {
#ifdef __CUDA_ARCH__
  static_assert(kPer == 1, "one particle a lane on the card");
  return __shfl_sync(kFull, v[0], idx);
#else
  return v[idx];
#endif
}

// min(#{i : cw[i] < v}, kWarpN - 1) for the nondecreasing cw the lanes hold
// (+inf past N): on the card five shuffles that halve the range (a count
// over all 32 lanes costs 32 shuffles, and one warp issues them one at a
// time), the binary search in the host build.
template <typename S>
AUX_HD int lanes_below(const S (&cw)[kPer], S v) {
#ifdef __CUDA_ARCH__
  int pos = 0;
#pragma unroll
  for (int step = kWarpN / 2; step > 0; step >>= 1)
    if (__shfl_sync(kFull, cw[0], pos + step - 1) < v) pos += step;
  return pos;
#else
  return imin(count_less(cw, kWarpN, v), kWarpN - 1);
#endif
}

// The sum over the lanes of c, which is 0 or 1 on the card (one ballot).
AUX_HD int lanes_count(int c) {
#ifdef __CUDA_ARCH__
  return __popc(__ballot_sync(kFull, c != 0));
#else
  return c;
#endif
}

// Inclusive prefix sums of v over the particles, in place; returns the
// lane's inclusive total (its last entry before the offset is added).
template <typename S>
AUX_HD S lane_cumsum(S (&v)[kPer], int lane) {
  S run = 0;
  for (int q = 0; q < kPer; ++q) {
    run += v[q];
    v[q] = run;
  }
  const S inc = warp_scan(run, lane), off = inc - run;
  for (int q = 0; q < kPer; ++q) v[q] += off;
  return inc;
}

// The max over the lanes: for float one redux.sync on the integer image
// that orders floats as their values (NaNs aside), shuffles for double.
AUX_HD float lanes_max(float v) {
#ifdef __CUDA_ARCH__
  int k = __float_as_int(v);
  k = __reduce_max_sync(kFull, k < 0 ? k ^ 0x7fffffff : k);
  return __int_as_float(k < 0 ? k ^ 0x7fffffff : k);
#else
  return v;
#endif
}
AUX_HD double lanes_max(double v) { return warp_max(v); }

// Copy n values from global `src` to shared `dst` without waiting (cp.async,
// a value an instruction), thread t of nt; async_wait() waits for all of this
// thread's copies, and a barrier after it publishes them. The host build
// copies at once.
template <typename S>
AUX_HD void copy_async(S* dst, const S* src, int n, int t, int nt) {
#ifdef __CUDA_ARCH__
  for (int e = t; e < n; e += nt) {
    const unsigned to = (unsigned)__cvta_generic_to_shared(dst + e);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(to), "l"(src + e),
                 "n"(sizeof(S))
                 : "memory");
  }
#else
  for (int e = t; e < n; e += nt) dst[e] = src[e];
#endif
}

AUX_HD void async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Bulk copies from global to shared memory by the copy engine
// (cp.async.bulk, one instruction for a whole contiguous block), each
// completing on a barrier in shared memory (mbarrier) that counts one
// arrival and the copy's bytes. The host build copies at once and never
// waits.
#ifdef __CUDA_ARCH__
AUX_HD unsigned shared_address(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
#endif

// Initialise `count` barriers, each expecting one arrival; then make them
// visible to the copy engine. Call from one thread, and fence the others.
AUX_HD void bars_init(unsigned long long* bars, int count) {
#ifdef __CUDA_ARCH__
  for (int i = 0; i < count; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_address(bars + i))
                 : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#else
  (void)bars;
  (void)count;
#endif
}

// Copy `words` values (their bytes a multiple of 16; dst and src 16-byte
// aligned) from global src to shared dst; the copy completes the current
// phase of `bar` (one thread arrives and announces the bytes).
template <typename S>
AUX_HD void copy_bulk(S* dst, const S* src, int words, unsigned long long* bar) {
#ifdef __CUDA_ARCH__
  const unsigned bytes = (unsigned)(words * sizeof(S)), at = shared_address(bar);
  asm volatile("{\n .reg .b64 state;\n"
               " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(at),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(shared_address(dst)), "l"(src), "r"(bytes), "r"(at)
      : "memory");
#else
  (void)bar;
  for (int e = 0; e < words; ++e) dst[e] = src[e];
#endif
}

// Wait until the phase of `bar` with this parity (0 for its first, 1 for its
// second, ...) has completed.
AUX_HD void bar_wait(unsigned long long* bar, int parity) {
#ifdef __CUDA_ARCH__
  asm volatile("{\n .reg .pred done;\n"
               "WAIT:\n"
               " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               " @!done bra WAIT;\n}\n" ::"r"(shared_address(bar)),
               "r"(parity)
               : "memory");
#else
  (void)bar;
  (void)parity;
#endif
}

template <typename S>
AUX_HD S block_max(const Block<S>& b, S v) { return block_all<true>(b, v); }
template <typename S>
AUX_HD S block_sum(const Block<S>& b, S v) { return block_all<false>(b, v); }

// dst[0..N) = inclusive prefix sums of src (dst may alias src). Ends with a
// barrier: dst is complete for every thread on return.
template <typename S>
AUX_HD void block_cumsum(const Block<S>& b, const S* src, S* dst, int N) {
  const int per = (N + b.nt - 1) / b.nt;
  const int lo = imin(b.tid * per, N), hi = imin(lo + per, N);
  S run = 0;
  for (int i = lo; i < hi; ++i) {
    run += src[i];
    dst[i] = run;
  }
#ifdef __CUDACC__
  const int lane = b.tid & 31, warp = b.tid >> 5, nw = b.nt >> 5;
  S inc = run;  // inclusive scan of the chunk totals within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const S y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) b.red[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    S x = lane < nw ? b.red[lane] : (S)0;
    for (int o = 1; o < 32; o <<= 1) {
      const S y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane < nw) b.red[lane] = x;
  }
  __syncthreads();
  const S off = (inc - run) + (warp > 0 ? b.red[warp - 1] : (S)0);
  if (off != (S)0)
    for (int i = lo; i < hi; ++i) dst[i] += off;
  __syncthreads();
#endif
}

// The carry on one warp (lane `lane` of `lanes`): w = exp(lw - max lw) / sum
// and cw its inclusive prefix sums, both from one scan of the exponentials
// e (cw = cumsum(e) / sum, the sum the scan's last entry); or, without
// softmax, w = lw and cw = cumsum(lw). A lane owns a contiguous chunk of
// ceil(N / lanes) entries: one entry for N <= 32 on the card, the sequential
// loops in the host build (one lane).
template <typename S>
AUX_HD void warp_weights(int lane, int lanes, bool softmax, const S* lw, S* w, S* cw, int N) {
  const int per = (N + lanes - 1) / lanes;
  const int lo = imin(lane * per, N), hi = imin(lo + per, N);
  S m = 0;
  if (softmax) {
    m = neg_inf<S>();
    for (int i = lo; i < hi; ++i) m = fmax(m, lw[i]);
    m = warp_max(m);
  }
  S run = 0;
  for (int i = lo; i < hi; ++i) {
    const S e = softmax ? exp(lw[i] - m) : lw[i];
    w[i] = e;
    run += e;
    cw[i] = run;
  }
  const S inc = warp_scan(run, lane);
  const S off = inc - run;
  if (softmax) {
    const S tot = warp_last(inc);
    for (int i = lo; i < hi; ++i) {
      w[i] = w[i] / tot;
      cw[i] = (cw[i] + off) / tot;
    }
  } else if (off != (S)0) {
    for (int i = lo; i < hi; ++i) cw[i] += off;
  }
}

// w[0..N) = exp(lw - max lw) / sum, in place (lw given in w, per-particle
// ownership). Ends with a barrier.
template <typename S>
AUX_HD void block_softmax(const Block<S>& b, S* w, int N, S m_local) {
  const S m = block_max(b, m_local);
  S part = 0;
  for (int j = b.tid; j < N; j += b.nt) {
    const S e = exp(w[j] - m);
    w[j] = e;
    part += e;
  }
  const S tot = block_sum(b, part);
  for (int j = b.tid; j < N; j += b.nt) w[j] = w[j] / tot;
  AUX_BSYNC();
}

}  // namespace csmc

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace csmc {

// Launch `kernel` as `blocks` blocks (one a chain of a chain-batched call)
// of `threads` with `shmem` bytes of dynamic shared memory (above the 48 KB
// default after the kernel's opt-in).
template <typename K>
int launch_blocks(K kernel, size_t shmem, int blocks, int threads, cudaStream_t stream,
                  void** args) {
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaLaunchKernel((const void*)kernel, dim3(blocks), dim3(threads), args,
                                     shmem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace csmc
#endif  // __CUDACC__
