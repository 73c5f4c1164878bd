// Warp code written once for both builds. On the card a thread is one lane
// and Lanes<T> holds its own value; the host build runs the 32 lanes of one
// warp in turn, Lanes<T> holds all of them, and a shuffle reads that array,
// so the host tests check a warp layout's index arithmetic. Used by the
// draws of stitching.cu and the chunk-total scan of scalar_scan.cu.
#pragma once

#ifndef AUX_HD
#define AUX_HD __device__ __forceinline__
#endif

namespace lanes {

constexpr int kWarp = 32;

#ifdef __CUDA_ARCH__
template <typename T>
struct Lanes {
  T v;
  AUX_HD T& operator[](int) { return v; }
  AUX_HD const T& operator[](int) const { return v; }
};
#define FOR_LANES(l) \
  for (int l = (int)(threadIdx.x % lanes::kWarp), l##_once = 1; l##_once; l##_once = 0)
#else
template <typename T>
struct Lanes {
  T v[kWarp];
  AUX_HD T& operator[](int l) { return v[l]; }
  AUX_HD const T& operator[](int l) const { return v[l]; }
};
#define FOR_LANES(l) for (int l = 0; l < lanes::kWarp; ++l)
#endif

// y[l] = x[src(l) % 32] for every lane l.
template <typename T, class Src>
AUX_HD Lanes<T> shfl(const Lanes<T>& x, Src src) {
  Lanes<T> y;
  FOR_LANES(l) {
#ifdef __CUDA_ARCH__
    y[l] = __shfl_sync(0xffffffffu, x[l], src(l));
#else
    y[l] = x[src(l) % kWarp];
#endif
  }
  return y;
}

}  // namespace lanes
