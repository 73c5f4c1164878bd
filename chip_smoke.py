#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`aux_ssm_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  0. setup: require a CUDA card, print its name and power limit, build the
     kernels from `aux_ssm_tpu_torch/ops/cuda/csrc/` and print the build time;
  1. each of the six kernels at the main path's shapes (T=1024, dx=16 flagship
     LGSSM, f32, inputs from a real filter pass) against its plain PyTorch
     version on the same inputs in f32 and in f64, plus the scan at T=300 and
     the f64 kernels against the f64 plain versions; then the whole MH step in
     f64 on the card against the CPU at T=64, dx=8, given the same noise;
  2. 50 second-order MH steps at T=1024, dx=16, f32: acceptance >= 0.99 (the
     proposal is exact for this Gaussian target) and exactly 10 kernel
     launches per step;
  3. 200 first-order MH steps at delta=0.05: finite states, acceptance in
     (0, 1], samples/s.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

T, DX = 1024, 16
DELTA = 0.05
NREL_F32 = 1e-4   # norm-relative bound, f32 kernel vs f32 plain and vs f64 plain
NREL_F64 = 1e-8   # norm-relative bound, f64 kernel vs f64 plain (logic check)
STEP_RTOL = 1e-9  # f64 step on the card vs the CPU

KERNELS = {  # wrapper name -> (source, the TPU kernel it replaces, launches per MH step)
    "make_elements": ("aux_ssm_tpu_torch/ops/cuda/csrc/kalman_fused.cu",
                      "aux_ssm_tpu/ops/pallas/kalman_fused.py:233", 2),
    "filter_scan": ("aux_ssm_tpu_torch/ops/cuda/csrc/scan.cu",
                    "aux_ssm_tpu/ops/pallas/filter_scan.py:368", 2),
    "ell": ("aux_ssm_tpu_torch/ops/cuda/csrc/kalman_fused.cu",
            "aux_ssm_tpu/ops/pallas/kalman_fused.py:276", 2),
    "backward_maps": ("aux_ssm_tpu_torch/ops/cuda/csrc/kalman_fused.cu",
                      "aux_ssm_tpu/ops/pallas/kalman_fused.py:483", 1),
    "affine_scan": ("aux_ssm_tpu_torch/ops/cuda/csrc/scan.cu",
                    "aux_ssm_tpu/ops/pallas/kalman_fused.py:317", 1),
    "logdensity_steps": ("aux_ssm_tpu_torch/ops/cuda/csrc/kalman_fused.cu",
                         "aux_ssm_tpu/ops/pallas/kalman_fused.py:402", 2),
}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card: CUDA events around `reps` calls
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def as_tuple(z):
    return z if isinstance(z, tuple) else (z,)


def nrel(got, want):
    """Frobenius norm-relative error, computed in f64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def compare(name, wrapper, plain, args, reps=20):
    """Kernel vs plain on the same f32 inputs and vs plain on their f64 cast;
    the f64 kernel vs the f64 plain version; times of kernel and plain (f32)."""
    import torch
    args64 = tuple(tuple(z.double() for z in a) if isinstance(a, tuple)
                   else a.double() if isinstance(a, torch.Tensor) else a for a in args)
    got = as_tuple(wrapper(*args))
    want32 = as_tuple(plain(*args))
    want64 = as_tuple(plain(*args64))
    got64 = as_tuple(wrapper(*args64))
    torch.cuda.synchronize()
    result = {"max_abs_err": 0.0, "nrel_f32": 0.0, "nrel_f64": 0.0, "nrel_f64_kernel": 0.0}
    for i, (g, w32, w64, g64) in enumerate(zip(got, want32, want64, got64)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: output {i} of the kernel is not finite")
        errs = {"max_abs_err": float((g.double() - w32.double()).abs().max()),
                "nrel_f32": nrel(g, w32), "nrel_f64": nrel(g, w64),
                "nrel_f64_kernel": nrel(g64, w64)}
        log(f"  {name}[{i}] shape={tuple(g.shape)} " + " ".join(
            f"{k}={v:.3e}" for k, v in errs.items()))
        for k, v in errs.items():
            result[k] = max(result[k], v)
    bad = {k: result[k] for k, bound in (("nrel_f32", NREL_F32), ("nrel_f64", NREL_F32),
                                         ("nrel_f64_kernel", NREL_F64))
           if not result[k] <= bound}
    if bad:
        raise AssertionError(f"{name}: error above bound: {bad}")
    result["ms"] = cuda_ms(lambda: wrapper(*args), reps)
    result["plain_ms"] = cuda_ms(lambda: plain(*args), max(1, reps // 4))
    log(f"  {name}: kernel {result['ms']:.4f} ms, plain {result['plain_ms']:.4f} ms")
    return result


def phase_kernels(dev):
    import torch
    from aux_ssm_tpu_torch.models import lgssm_flagship
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS
    from aux_ssm_tpu_torch.ops.cuda import kalman_fused as KF
    from aux_ssm_tpu_torch.ops.filtering import _make_associative_elements, kalman_update
    from aux_ssm_tpu_torch.ops.sampling import _backward_maps

    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(1)
    dyn, obs1, _ = lgssm_flagship.build_model(T, DX, device=dev, dtype=f32)
    x = torch.zeros(T, DX, dtype=f32, device=dev)
    u = x + (0.5 * DELTA) ** 0.5 * torch.randn(T, DX, generator=gen, device=dev)
    m0, P0, Fs, Qs, bs = dyn(x)
    ys, Hs, Rs, cs = (z.contiguous() for z in obs1(x, u, DELTA))
    steps = (Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:])
    n = T - 1

    results = {}
    log(f"phase 1: kernels at T={T}, dx={DX}, dy={ys.shape[-1]} (f32; bounds: nrel "
        f"{NREL_F32:g} vs plain f32 and f64, {NREL_F64:g} f64 kernel vs f64 plain)")
    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    m_el = torch.cat([m0u[None], m0u.new_zeros(n - 1, DX)])
    P_el = torch.cat([P0u[None], P0u.new_zeros(n - 1, DX, DX)])
    results["make_elements"] = compare("make_elements", KF.make_elements,
                                       KF.make_elements_plain, steps + (m_el, P_el))

    elems = _make_associative_elements(*steps, m0u, P0u)
    results["filter_scan"] = compare("filter_scan", FS.filter_scan, FS.filter_scan_plain,
                                     (elems,))
    log("  scan at T=300 (the TPU's Hillis-Steele range):")
    compare("filter_scan_T300", FS.filter_scan, FS.filter_scan_plain,
            (tuple(z[:299].contiguous() for z in elems),))

    _, ms, Ps, _, _ = FS.filter_scan(elems)
    ms, Ps = torch.cat([m0u[None], ms]), torch.cat([P0u[None], Ps])
    results["ell"] = compare("ell", KF.ell, KF.ell_plain, steps + (ms[:-1], Ps[:-1]))

    eps = torch.randn(T, DX, generator=gen, device=dev)
    results["backward_maps"] = compare(
        "backward_maps", KF.backward_maps, KF.backward_maps_plain,
        (Fs, Qs, bs, ms[:-1].contiguous(), Ps[:-1].contiguous(), eps[:-1].contiguous()))

    gains, incs = _backward_maps(eps, ms, Ps, Fs, Qs, bs)
    results["affine_scan"] = compare("affine_scan", FS.affine_scan, FS.affine_scan_plain,
                                     (gains, incs, True))

    xs = FS.affine_scan(gains, incs, reverse=True)[1]
    results["logdensity_steps"] = compare(
        "logdensity_steps", KF.logdensity_steps, KF.logdensity_steps_plain,
        steps + (xs[:-1].contiguous(), xs[1:].contiguous()))
    return results


def phase_step_reference(dev):
    """Three f64 MH steps (T=64, dx=8, both orders) on the card against the
    CPU, given the same noise."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch import get_kernel
    from aux_ssm_tpu_torch.models import lgssm_flagship

    T_, dx_ = 64, 8
    for order in (1, 2):
        runs = {}
        for where in ("cpu", dev):
            dyn, obs1, obs2, tf = lgssm_flagship.build_order2_factory(
                T_, dx_, device=where, dtype=torch.float64)
            init, kernel = get_kernel(dyn, obs1 if order == 1 else obs2, tf, parallel=True)
            rng = np.random.default_rng(order)
            state = init(torch.zeros(T_, dx_, dtype=torch.float64, device=where))
            out = []
            for _ in range(3):
                noise = (torch.as_tensor(rng.standard_normal((T_, dx_)), device=where),
                         torch.as_tensor(rng.standard_normal((T_, dx_)), device=where),
                         torch.as_tensor(rng.uniform(), dtype=torch.float64, device=where))
                state = kernel(state, 0.1, noise=noise)
                out.append((state.x.cpu(), bool(state.updated), state.log_target.cpu()))
            runs[str(where)] = out
        worst = 0.0
        for (xc, uc, lc), (xg, ug, lg) in zip(runs["cpu"], runs[str(dev)]):
            if uc != ug:
                raise AssertionError(f"order {order}: accept differs between card and CPU")
            worst = max(worst, nrel(xg, xc), float(abs(lg - lc) / abs(lc)))
        log(f"  step order {order}, T={T_}, dx={dx_}, f64: card vs CPU rel err {worst:.3e} "
            f"(bound {STEP_RTOL:g})")
        if not worst <= STEP_RTOL:
            raise AssertionError(f"order {order}: card and CPU steps differ by {worst:.3e}")


def run_chain(dev, order, n_steps, seed):
    """n_steps MH steps of the flagship at T=1024, dx=16, f32, from x = 0, after
    3 warm-up steps; returns (state, acceptance, seconds, launches)."""
    import torch
    from aux_ssm_tpu_torch import get_kernel
    from aux_ssm_tpu_torch.models import lgssm_flagship
    from aux_ssm_tpu_torch.ops import cuda as K

    dyn, obs1, obs2, tf = lgssm_flagship.build_order2_factory(T, DX, device=dev,
                                                              dtype=torch.float32)
    init, kernel = get_kernel(dyn, obs1 if order == 1 else obs2, tf, parallel=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init(torch.zeros(T, DX, dtype=torch.float32, device=dev))
    for _ in range(3):
        state = kernel(state, DELTA, generator=gen)
    torch.cuda.synchronize()
    K.reset_launches()
    accepted = torch.zeros((), device=dev)
    tic = time.perf_counter()
    for _ in range(n_steps):
        state = kernel(state, DELTA, generator=gen)
        accepted += state.updated
    torch.cuda.synchronize()
    seconds = time.perf_counter() - tic
    launches = K.launches()
    acc = float(accepted) / n_steps
    if tuple(state.x.shape) != (T, DX) or not bool(torch.isfinite(state.x).all()) \
            or not bool(torch.isfinite(state.log_target)):
        raise AssertionError(f"order {order}: the chain's state is not finite")
    for name, (_, _, per_step) in KERNELS.items():
        if launches[name] != per_step * n_steps:
            raise AssertionError(f"order {order}: {name} launched {launches[name]} times, "
                                 f"expected {per_step * n_steps}")
    log(f"  order {order}: {n_steps} steps, acceptance {acc:.4f}, "
        f"{n_steps / seconds:.2f} samples/s, launches {launches}")
    return state, acc, seconds, launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    from aux_ssm_tpu_torch.ops.cuda._build import LIBRARY

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    LIBRARY.get()
    log(f"phase 0: kernels built in {LIBRARY.build_seconds:.1f} s into {LIBRARY.build_dir}")

    results = phase_kernels(dev)
    phase_step_reference(dev)

    log(f"phase 2: second-order chain, T={T}, dx={DX}, f32, delta={DELTA}")
    _, acc2, _, launches = run_chain(dev, order=2, n_steps=50, seed=2)
    if not acc2 >= 0.99:
        raise AssertionError(f"order 2: acceptance {acc2} below 0.99")

    log(f"phase 3: first-order chain, T={T}, dx={DX}, f32, delta={DELTA}")
    _, acc1, _, _ = run_chain(dev, order=1, n_steps=200, seed=3)
    if not 0.0 < acc1 <= 1.0:
        raise AssertionError(f"order 1: acceptance {acc1} outside (0, 1]")

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
               for name, (src, rep, _) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
