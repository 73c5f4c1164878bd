// Model functors of the cSMC sweeps with the model's step compiled in: what
// aux_ssm_tpu traces into its Pallas kernels as the model's Python callables
// (`block_propagate` / `block_logw` of the block-lane sweep,
// csmc_block_lane.cu; `lane_propagate` / `lane_logw` / `lane_logpdf` of the
// scalar-state lane sweep, csmc_lane.cu).
//
// A block-lane functor gives
//   Step at(const S* row) const      the step's constants, from its row of the
//                                    compact per-step parameters (row_width(d)
//                                    values, each functor names its row)
//   S step(const Step& st, int j, int a, int lane, int lanes, const S* x_prev,
//          const S* eps, const S* x_star, S* x_out, S* buf) const
// run by the `lanes` lanes of one warp together: it propagates particle j
// from column a of x_prev (d, N) with column j of eps (d, N), pins particle 0
// to x_star (d,), stores the particle in column j of x_out (d, N) and returns
// its log weight on every lane. Lane l owns the state components l, l +
// lanes, ...; buf is the warp's shared scratch of scratch(d) entries. The
// lanes must not diverge around a call. The pointers may be to shared or to
// global memory. It is built as Model(d, N, consts) from its packed
// constants, which the sweep keeps in shared memory.
//
// A lane functor is built from (consts, params): its kConsts constants and
// the compact (n, kParams) per-step rows, and gives, on scalars, for step t
//   S propagate(int t, S eps, S x_prev)         the proposal draw
//   S logw(int t, S x_next, S x_prev)           the log weight
//   S pgas_logpdf(int t, S x_star, S x_prev)    log density of x*_t given an
//                                               ancestor (its own transition)
// written in the operation order of the Python callables, so that float64
// agrees with them to rounding. No fast math: exp and log are IEEE.
#pragma once

#include "csmc_common.cuh"

namespace csmc {

// The widest state whose components a lane of the block-lane functors keeps
// in registers; a wider state keeps them in the warp's shared scratch.
constexpr int kRegBlockD = 64;

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

  AUX_HHD static int scratch(int d) { return 3 * d; }  // three d-vectors a warp
  AUX_HHD static int row_width(int d) { return 6 * d + 2; }

  // consts = [FRT, VQ, VQT (d*d each), bR, isl (d each), half_logdet_Q]
  AUX_HD SvGuided(int d_, int N_, const S* c)
      : d(d_), N(N_), FRT(c), VQ(c + d_ * d_), VQT(c + 2 * d_ * d_), bR(c + 3 * d_ * d_),
        isl(c + 3 * d_ * d_ + d_), half_logdet_Q(c[3 * d_ * d_ + 2 * d_]) {}

  // The row, and log(2 pi scale^2) and 1 / scale^2 of its scale.
  struct Step {
    const S* p;
    S log_c, inv_s2;
  };
  AUX_HD Step at(const S* row) const {
    const S scale = row[6 * d];
    const S s2 = scale * scale;
    return {row, log((S)6.283185307179586 * s2), (S)1 / s2};
  }

  AUX_HD S step(const Step& st, int j, int a, int lane, int lanes, const S* x_prev,
                const S* eps, const S* x_star, S* x_out, S* buf) const {
    const S* p = st.p;
    const S *u = p, *y = p + d, *rotS = p + 2 * d, *g = p + 3 * d, *sqrtL = p + 4 * d,
            *inv_sqrtL = p + 5 * d;
    const S hld = p[6 * d + 1];
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
      const S z = x_i - u[i];
      prop += (st.log_c + z * z * st.inv_s2) / (S)-2;
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

// The guided proposal of the spatio-temporal Student-t model,
// aux_ssm_tpu/models/spatial.py get_guided_csmc_kernel (_block_moments,
// _block_tpot, GuidedMt.block_propagate and GuidedGt.block_logw): d = B
// independent random walks of scale sig_x recentred on the auxiliary
// observation u with the scalar gain K = sig_x^2 / (sig_x^2 + scale^2),
//   moments    mu = x_prev + K (u' - x_prev),  lam = sqrt(sig_x^2 (1 - K)),
//              u' = u + scale^2 (nu + d) P (y - x_prev) / (nu + q(x_prev))
//              with the gradient shift, else u' = u;  q(x) = (y-x)^T P (y-x)
//   propagate  x = mu + lam eps
//   logw       nan_to_num(-(nu + d) / 2 log1p(q(x) / nu))
//              + sum_i log N(x_i; x_prev_i, sig_x) + sum_i log N(x_i; u_i, scale)
//              - sum_i log N(x_i; mu_i, lam)
// consts = [sig_x, nu, gradient (0 or 1), W, then the precision P as row
// lists: values (d, W), then column indices (d, W), each row's nonzeros in
// ascending column order, padded with zeros to the widest row W
// (native/precision.py precision_rows)]; row t = [u (d), y (d), scale, then
// the step's constants K, lam, scale^2 (nu + d) (the gradient shift's
// factor), d (log 2 pi sig_x^2 + log 2 pi scale^2 - log 2 pi lam^2) (the
// three densities' log-normalisers), 1 / scale^2, 1 / lam^2], taken once a
// step by the model (spatial.py GuidedGt.cuda_operands) rather than by
// every thread at every step.
// A row of P v is its W products summed in column order, which for finite v
// is bit for bit the dense row (a zero product adds nothing): 5 products at
// the published r_y = 1 instead of d = 64. Up to kRegD = kRegBlockD a lane
// keeps its components of x_prev and of P (y - x_prev) in registers (kPer
// of them) and only the vectors P is applied to go through the warp's
// scratch; a wider state (the 9 x 9 grid's d = 81 and up) keeps those two
// in the scratch too, [y - x | x_prev | P (y - x_prev)], each entry read
// only by the lane that owns it. Both run the same arithmetic in the same
// order (`step_in`), so any d whose buffers fit in shared memory runs.
template <typename S>
struct SpatialGuided {
  static constexpr int kPer = (kRegBlockD + AUX_LANES - 1) / AUX_LANES;  // components a lane owns
  static constexpr int kRegD = kPer * AUX_LANES;
  AUX_HHD static int scratch(int d) { return d <= kRegD ? d : 3 * d; }
  AUX_HHD static int row_width(int d) { return 2 * d + 7; }

  int d, N, W;
  S nu, inv_trans;  // 1 / sig_x^2
  bool gradient;
  const S *vals, *cols;

  AUX_HD SpatialGuided(int d_, int N_, const S* c)
      : d(d_), N(N_), W((int)c[3]), nu(c[1]), inv_trans((S)1 / (c[0] * c[0])),
        gradient(c[2] != (S)0), vals(c + 4), cols(c + 4 + d_ * (int)c[3]) {}

  // (P v)_i from row i's list.
  AUX_HD S apply_row(int i, const S* v) const {
    const S* pv = vals + i * W;
    const S* pc = cols + i * W;
    S s = 0;
    for (int w = 0; w < W; ++w) s += pv[w] * v[(int)pc[w]];
    return s;
  }

  struct Step {
    const S *u, *y;
    S K, lam, g_scale, log_c, inv_prop, inv_ll;
  };
  AUX_HD Step at(const S* row) const {
    const S* c = row + 2 * d + 1;
    return {row, row + d, c[0], c[1], c[2], c[3], c[4], c[5]};
  }

  AUX_HD S step(const Step& st, int j, int a, int lane, int lanes, const S* x_prev,
                const S* eps, const S* x_star, S* x_out, S* buf) const {
    return d <= kRegD ? step_in<false>(st, j, a, lane, lanes, x_prev, eps, x_star, x_out, buf)
                      : step_in<true>(st, j, a, lane, lanes, x_prev, eps, x_star, x_out, buf);
  }

  // A lane's values of its components: register r, or (kWide) entry i of a
  // d-vector in the warp's scratch.
  template <bool kWide>
  struct Own {
    S reg[kWide ? 1 : kPer];
    S* at;
    AUX_HD S& operator()(int r, int i) {
      if constexpr (kWide) return at[i];
      else return reg[r];
    }
  };

  template <bool kWide>
  AUX_HD S step_in(const Step& st, int j, int a, int lane, int lanes, const S* x_prev,
                   const S* eps, const S* x_star, S* x_out, S* buf) const {
    S* df = buf;  // y - x_prev, then y - x: the vectors P is applied to
    Own<kWide> xa{{}, buf + d}, pv{{}, buf + 2 * d};
    const int R = kWide ? (d + lanes - 1) / lanes : kPer;  // components a lane owns
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + r * lanes;
      if (i < d) {
        pv(r, i) = 0;
        xa(r, i) = x_prev[(long)i * N + a];
        df[i] = st.y[i] - xa(r, i);
      }
    }
    AUX_WSYNC();
    S g = 0;
    if (gradient) {
      S q = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + r * lanes;
        if (i < d) {
          pv(r, i) = apply_row(i, df);
          q += df[i] * pv(r, i);
        }
      }
      g = st.g_scale / (nu + warp_sum(q));
      AUX_WSYNC();  // every lane is done with y - x_prev in df
    }
    S quad = 0;  // sum_i of the three densities' squared standardised residuals
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + r * lanes;
      if (i < d) {
        const S u_i = st.u[i], x_a = xa(r, i);
        const S mu_i = x_a + st.K * ((gradient ? u_i + g * pv(r, i) : u_i) - x_a);
        const S x_i = j == 0 ? x_star[i] : mu_i + st.lam * eps[(long)i * N + j];
        x_out[(long)i * N + j] = x_i;
        df[i] = st.y[i] - x_i;
        const S z1 = x_i - x_a, z2 = x_i - u_i, z3 = x_i - mu_i;
        quad += z1 * z1 * inv_trans + z2 * z2 * st.inv_prop - z3 * z3 * st.inv_ll;
      }
    }
    AUX_WSYNC();
    S qq = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + r * lanes;
      if (i < d) qq += df[i] * apply_row(i, df);
    }
    qq = warp_sum(qq);
    quad = warp_sum(quad);
    AUX_WSYNC();  // buf is free for the warp's next particle

    return nan_to_num(-(S)0.5 * (nu + (S)d) * log1p(qq / nu)) - (S)0.5 * (st.log_c + quad);
  }
};

// ---------------------------------------------------------------------------
// Lane functors (scalar state)
// ---------------------------------------------------------------------------

// aux_ssm_tpu/models/theta_logistic.py: x' = x + tau0 - tau1 exp(tau2 x) +
// sig_x eps, y ~ N(x, sig_y^2). consts [tau0, tau1, tau2, sig_x, sig_y];
// row t = [y_t].
template <typename S>
struct ThetaLogistic {
  static constexpr int kConsts = 5, kParams = 1;
  S tau0, tau1, tau2, sig_x, sig_y;
  const S* y;

  AUX_HD ThetaLogistic(const S* c, const S* p)
      : tau0(c[0]), tau1(c[1]), tau2(c[2]), sig_x(c[3]), sig_y(c[4]), y(p) {}
  AUX_HD S drift(S x) const { return x + tau0 - tau1 * exp(tau2 * x); }
  AUX_HD S propagate(int, S eps, S x_prev) const { return drift(x_prev) + sig_x * eps; }
  AUX_HD S logw(int t, S x_next, S) const { return norm_logpdf(y[t], x_next, sig_y); }
  AUX_HD S pgas_logpdf(int, S x_star, S x_prev) const {
    return norm_logpdf(x_star, drift(x_prev), sig_x);
  }
};

// The benchmark toy 0.9 x + 0.5 eps, y ~ N(x, 0.5^2), with its three numbers
// as constants: consts [a, sig_x, sig_y]; row t = [y_t].
template <typename S>
struct Ar1Gauss {
  static constexpr int kConsts = 3, kParams = 1;
  S a, sig_x, sig_y;
  const S* y;

  AUX_HD Ar1Gauss(const S* c, const S* p) : a(c[0]), sig_x(c[1]), sig_y(c[2]), y(p) {}
  AUX_HD S propagate(int, S eps, S x_prev) const { return a * x_prev + sig_x * eps; }
  AUX_HD S logw(int t, S x_next, S) const { return norm_logpdf(y[t], x_next, sig_y); }
  AUX_HD S pgas_logpdf(int, S x_star, S x_prev) const {
    return norm_logpdf(x_star, a * x_prev, sig_x);
  }
};

// aux_ssm_tpu/models/rare_event.py get_feynman_kac (bootstrap): x' = rho x +
// sig eps, and the single observation y ~ N(x_{T-1}, r^2) as an indicator
// times a density (a product, not a select). consts [T]; row t =
// [rho, sig, t, y, r], t the step's time index 1..T-1 as a float.
template <typename S>
struct RareEventBootstrap {
  static constexpr int kConsts = 1, kParams = 5;
  S last;  // T - 1
  const S* params;

  AUX_HD RareEventBootstrap(const S* c, const S* p) : last(c[0] - (S)1), params(p) {}
  AUX_HD S propagate(int t, S eps, S x_prev) const {
    const S* p = params + (long)t * kParams;
    return p[0] * x_prev + p[1] * eps;
  }
  AUX_HD S logw(int t, S x_next, S) const {
    const S* p = params + (long)t * kParams;
    return (p[2] == last ? (S)1 : (S)0) * norm_logpdf(p[3], x_next, p[4]);
  }
  AUX_HD S pgas_logpdf(int t, S x_star, S x_prev) const {
    const S* p = params + (long)t * kParams;
    return norm_logpdf(x_star, p[0] * x_prev, p[1]);
  }
};

// aux_ssm_tpu/models/rare_event.py get_guided_csmc_kernel: the proposal
// recentred on the auxiliary observation u with the scalar Kalman gain K,
//   mu(x_pred) = x_pred + K (u + grad scale^2 [t = T-1] (y - x_pred) / r2 - x_pred)
//   propagate    mu(rho x_prev) + sig_p eps
//   logw         log N(x'; rho x_prev, sig) + log N(x'; u, scale)
//                - log N(x'; mu, sig_p) + [t = T-1] log N(y; x', r)
// consts [T, gradient (0 or 1)]; row t = [K, sig_p, u, scale, t, rho, sig, y,
// r, r2].
template <typename S>
struct RareEventGuided {
  static constexpr int kConsts = 2, kParams = 10;
  S last, grad;
  const S* params;

  AUX_HD RareEventGuided(const S* c, const S* p) : last(c[0] - (S)1), grad(c[1]), params(p) {}
  AUX_HD S mu(const S* p, S x_pred) const {
    const S g = (p[4] == last ? (S)1 : (S)0) * (p[7] - x_pred) / p[9];
    const S su = p[2] + grad * (p[3] * p[3]) * g;
    return x_pred + p[0] * (su - x_pred);
  }
  AUX_HD S propagate(int t, S eps, S x_prev) const {
    const S* p = params + (long)t * kParams;
    return mu(p, p[5] * x_prev) + p[1] * eps;
  }
  AUX_HD S logw(int t, S x_next, S x_prev) const {
    const S* p = params + (long)t * kParams;
    const S x_pred = p[5] * x_prev;
    S out = norm_logpdf(x_next, x_pred, p[6]);
    out += norm_logpdf(x_next, p[2], p[3]);
    out -= norm_logpdf(x_next, mu(p, x_pred), p[1]);
    out += (p[4] == last ? (S)1 : (S)0) * norm_logpdf(p[7], x_next, p[8]);
    return out;
  }
  AUX_HD S pgas_logpdf(int t, S x_star, S x_prev) const {
    const S* p = params + (long)t * kParams;
    return norm_logpdf(x_star, mu(p, p[5] * x_prev), p[1]);
  }
};

}  // namespace csmc
