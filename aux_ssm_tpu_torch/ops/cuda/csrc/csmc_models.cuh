// Model functors of the block-lane cSMC sweep (csmc_block_lane.cu): the
// per-particle step that aux_ssm_tpu traces into its Pallas kernel as the
// model's `block_propagate` / `block_logw` callables.
//
// A functor gives
//   S step(int t, int j, int a, int lane, int lanes, const S* x_prev, const S* eps,
//          const S* x_star, S* x_out, S* buf)
// run by the `lanes` lanes of one warp together: it propagates particle j of
// step t from column a of x_prev (d, N) with column j of eps (d, N), pins
// particle 0 to x_star (d,), stores the particle in column j of x_out (d, N)
// and returns its log weight on every lane. Lane l owns the state components
// l, l + lanes, ...; buf is the warp's shared scratch of kScratch * d
// entries. The lanes must not diverge around a call.
#pragma once

#include "csmc_common.cuh"

namespace csmc {

// log N(x; loc, scale^2) as jax.scipy.stats.norm.logpdf computes it.
template <typename S>
AUX_HD S norm_logpdf(S x, S loc, S scale) {
  const S s2 = scale * scale;
  const S z = x - loc;
  return (log((S)6.283185307179586 * s2) + z * z / s2) / (S)-2;
}

// The guided SV proposal of aux_ssm_tpu/models/stochastic_volatility.py
// (make_guided_factory, GuidedMt.block_propagate and GuidedGt.block_logw),
// carried in Q's eigenbasis z = VQ^T x:
//   propagate  zp = FR^T x_prev + bR,  zn = zp + g (rotS - zp) + sqrtL eps,  x = VQ zn
//   logw       sum_i nan_to_num(log N(y_i; 0, exp(x_i)))
//              - |(VQ^T x - zp) isl|^2 / 2 - half_logdet_Q - d log(2 pi) / 2
//              + sum_i log N(x_i; u_i, scale)
//              + |(VQ^T x - zmu) inv_sqrtL|^2 / 2 + hld + d log(2 pi) / 2
// with zmu = zp + g (rotS - zp). Constants (row-major d x d FRT = FR^T, VQ,
// VQT, and the d-vectors bR, isl = lamQ^{-1/2}) are read from shared memory;
// per-step parameters from a compact (n, 6 d + 2) array, row t =
// [u, y, rotS, g, sqrtL, inv_sqrtL (d each), scale, hld]. Each lane computes
// the rows of the three d x d mat-vecs for the components it owns, from the
// warp's vectors in `buf`: 3 d dependent FMAs a lane instead of 3 d^2.
template <typename S>
struct SvGuided {
  int d, N;
  const S *FRT, *VQ, *VQT, *bR, *isl;
  S half_logdet_Q;
  const S* params;

  static constexpr int kScratch = 3;  // d-vectors of a warp's scratch

  AUX_HD S step(int t, int j, int a, int lane, int lanes, const S* x_prev, const S* eps,
                const S* x_star, S* x_out, S* buf) const {
    const S* p = params + (long)t * (6 * d + 2);
    const S *u = p, *y = p + d, *rotS = p + 2 * d, *g = p + 3 * d, *sqrtL = p + 4 * d,
            *inv_sqrtL = p + 5 * d;
    const S scale = p[6 * d], hld = p[6 * d + 1];
    S* v = buf;           // the ancestor x_prev[:, a], then the new particle x
    S* zp = buf + d;      // its prediction in the eigenbasis
    S* zn = buf + 2 * d;  // the proposal in the eigenbasis

    for (int i = lane; i < d; i += lanes) v[i] = x_prev[(long)i * N + a];
    AUX_WSYNC();
    for (int i = lane; i < d; i += lanes) {
      const S zp_i = dot(FRT + i * d, v, d) + bR[i];
      zp[i] = zp_i;
      zn[i] = zp_i + g[i] * (rotS[i] - zp_i) + sqrtL[i] * eps[(long)i * N + j];
    }
    AUX_WSYNC();  // every lane is done with the ancestor in v
    for (int i = lane; i < d; i += lanes) {
      const S x_i = j == 0 ? x_star[i] : dot(VQ + i * d, zn, d);
      v[i] = x_i;
      x_out[(long)i * N + j] = x_i;
    }
    AUX_WSYNC();

    S obs = 0, qq = 0, prop = 0, ll = 0;
    for (int i = lane; i < d; i += lanes) {
      const S x_i = v[i];
      obs += nan_to_num(norm_logpdf(y[i], (S)0, exp((S)0.5 * x_i)));
      const S zn_i = dot(VQT + i * d, v, d);
      const S wq = (zn_i - zp[i]) * isl[i];
      qq += wq * wq;
      prop += norm_logpdf(x_i, u[i], scale);
      const S zmu = zp[i] + g[i] * (rotS[i] - zp[i]);
      const S wl = (zn_i - zmu) * inv_sqrtL[i];
      ll += wl * wl;
    }
    obs = warp_sum(obs);
    qq = warp_sum(qq);
    prop = warp_sum(prop);
    ll = warp_sum(ll);
    AUX_WSYNC();  // buf is free for the warp's next particle

    const S half_d_log2pi = (S)(0.5 * d * 1.8378770664093453);
    S out = obs - (S)0.5 * qq - half_logdet_Q - half_d_log2pi;
    out += prop;
    out -= -(S)0.5 * ll - hld - half_d_log2pi;
    return out;
  }
};

}  // namespace csmc
