#!/usr/bin/env python3
"""Times the block_masses, block-lane sweep, factor sweep, draw, filter-scan,
lane-sweep, MH-step, row_lse, col_sample and scalar-scan kernels of one
checkout of the port on a CUDA card, at the main paths' shapes, and profiles
the steps that run them.

    python3 kernel_times.py                 # the checkout this file is in
    python3 kernel_times.py --root DIR      # the checkout unpacked at DIR
    python3 kernel_times.py --parts draws   # some of: masses, lane, steps, factor, draws,
                                            #   scan, pgas, maps, rows, scalar, sv32, lorenz,
                                            #   chains, onechain

To compare two checkouts, unpack the other into a directory that .gitignore
lists and run both in one machine in turns (A, B, B, A): times on one card
only compare within one call. The inputs are those `chip_smoke.py` of the
timed checkout hands the kernels (its helpers are imported from DIR), from
the same seeds:
  - block_masses at the level 0 of an N=4096 PIT step (SV D=1, T=1024, P=512,
    k=1, f32), both stabilisers, and the sum over the step's 9 levels;
  - block_lane_scan on a real step's inputs: SV csmc-guided at T=250, D=30,
    N=25 and N=1024, spatial csmc-guided at T=1024, d=64, N=25 with the
    gradient shift off and on;
  - torch.profiler over steps of the N=4096 PIT sampler (joint and fused
    draws) and of spatial csmc-guided (gradient off and on): ms a step, the
    device's busy ms and the named kernel's device ms a step;
  - factor: the forward and backward factor sweeps on a real step's inputs
    (SV csmc at T=250, D=30, N=25, k=30, the backward sweep of csmc-guided;
    spatial csmc at T=1024, N=25, k=64, the backward sweep of
    csmc-guided), on random inputs at N=300, k=30 (T=250) and N=4096, k=1
    (T=1024) (the block path), and at N=1, k=64 (T=1024: the one-warp
    chain's floor); the pair-score pass alone where the checkout has one;
    torch.profiler over steps of spatial csmc (backward sampling) and
    csmc-guided, with the device ms of each factor kernel;
  - draws: stitch_draws (fused draws) and within_block_cols (joint draws)
    at level 0 and over the 9 levels of an N=4096 step, at level 0 of an
    N=128 step (nb=1), and on random inputs at N=8192 (nb=64, P=2, k=1) and
    N=2048, k=30 (chip_smoke.DRAW_CASES, made by this file's chip_smoke);
    with --sass DIR the SASS of the draw kernels goes to
    DIR/sass_draws_<build>.txt (where DRAW_SCORE_INSTRUCTIONS is counted),
    and with --parts rows that of col_sample to DIR/sass_rows_<build>.txt
    (where COL_GUMBEL_INSTRUCTIONS is counted);
  - scan: the filter scan on the flagship's elements (T=1024, dx=dy=16, f32,
    chip_smoke phase 1's inputs) at n=1023, at n=299 (T=300) and at n=2
    (one combine: the chain's floor), the affine scan (n=1024, reversed) as
    a guard; where the checkout has them, the clock64 cycles of one combine
    on teams of 32, 64, 128 and 256 threads (f32 and f64) and the scan's
    per-block timeline at n=1023 (cycles from a block's start to the end of
    its chunk, each level, the hop for the chunks before it, its end: the
    median over blocks and the last block's); torch.profiler over
    first-order MH steps (T=1024, dx=16) with the scans' device ms;
  - pgas: the lane sweep on a real theta-logistic PGAS step's inputs (T=256,
    N=256, PGAS on and off), on random inputs at N=1 (the one-warp chain's
    floor), N=33 and N=1024 (PGAS), on a real
    rare-event csmc-guided step's inputs (T=2, N=25, PGAS), on random
    rare-event bootstrap inputs (T=9, N=25) and at the AR(1) toy's T=1024,
    N=4096 (the wide path), PGAS on and off; torch.profiler over
    theta-logistic PGAS steps with the sweep's device ms;
  - maps: the six kernels of the auxiliary-Kalman MH step (make_elements,
    filter_scan, ell, backward_maps, affine_scan, logdensity_steps) on
    chip_smoke phase 1's inputs (T=1024, dx=dy=16, f32), the filter scan
    also at n=299 (T=300) and in f64 at both n, ell and logdensity_steps
    also in f64 (as chip_smoke phase 1 runs them), backward_maps also in
    f64, the affine scan also at n=300 and n=2; where the checkout has them,
    make_elements' clock64 phases (the median step's cycles from its start
    to the end of the staging, S, the solve, K and its end), backward_maps'
    (the staging, S, the solve, cov, the factor and its end), the affine
    combine's cycles on teams of 32, 64 and 128 threads and the affine
    scan's per-block timeline; torch.profiler over first-order MH steps with
    each of the six kernels' device ms a step (the old and the new kernels'
    names);
  - rows: row_lse and col_sample (also in f64), device ms by
    torch.profiler and CUDA events, at every level of a real SV (T=250,
    D=30, N=25, k=30) and a real spatial (T=1024, N=25, k=64) PIT step
    (chip_smoke phase 16's seed), summed over the step's launches (SV 7
    col_sample, spatial 9), row_lse at the N=4096 root (k=1) and on random
    inputs at a two-pass level of mid-size N (P=512, N=1000, k=30), f32 and
    f64; torch.profiler over the SV and spatial PIT steps with both
    kernels' device ms a step;
  - scalar: the scalar filter scan and the affine scan (reversed and
    forward) on a real spatial kalman-1 step's inputs (chip_smoke phase 12:
    n=1023 and 1024, B=64), cut to n=299 and repeated to a 64 x 64 field
    (B=4096), f32 and f64: device ms a launch by torch.profiler (the mean,
    and min / median / max over 30 launches) and by CUDA events;
    torch.profiler over kalman-1 steps with the scans' device ms a step;
  - sv32: the six MH kernels' D = 32 instance on a real SV kalman-1 step's
    inputs (T=250, D=30: chip_smoke phase 20's), f32 and f64, by CUDA events
    and by the profiler's device time; make_elements' and backward_maps'
    clock64 phases there; the filter and affine combines' cycles at D = 32
    on 128 and 256 threads (f32 and f64); both scans' per-block timelines;
    torch.profiler over SV kalman-1 and kalman-2 steps (the committed runs'
    data, xs_true and delta) with each of the six kernels' device ms a step.
    A checkout whose kernels take d <= 16 only cannot run it.
  - lorenz: the six MH kernels' D = 16 instance on a real Lorenz step's
    inputs (chip_smoke phase 23's: the Mider data at freq 4, T=5001, dx=3,
    dy=5, the committed run's mean_x and theta, delta 1e20), the two scans
    also at freq 2 (T=10001), f32 and f64, by CUDA events and the profiler's
    device time; make_elements' and backward_maps' clock64 phases there;
    torch.profiler over Lorenz Gibbs steps (freq 4) with each of the six
    kernels' device ms a step. A checkout without the Lorenz model skips it.
  - chains: the six MH kernels' chain instances (the dense batched layout)
    on real batched steps' inputs (chip_smoke phase 30's: SV kalman-1 at
    T=250, D=30, the D = 32 instance; the Lorenz step at Mider freq 4,
    T=5001, the D = 16 instance) at C = 1, 8 and 32 chains, each call's
    device ms by the profiler against that of C one-chain launches on the
    same inputs (chain after chain, as `chains.chain_loop` runs them), with
    the bound of the chain launch (`chip_smoke.bound`: the bytes it moves,
    each input read once, an operand every chain shares (F, Q, b) once for
    all chains, each output written once, against C chains' operations);
    torch.profiler over the batched SV kalman-1 step at C = 32 and the
    batched Lorenz Gibbs step at C = 8 (from the committed runs' states)
    with each kernel's device ms a step; and the samples/s of all chains of
    those two steps, batched against the same chains through
    `chains.chain_loop` (one-chain steps chain after chain), from one
    state, in turns. A checkout without the chain instances skips it. Then
    the block-lane sweep's chain instance (row 11) on real batched
    csmc-guided steps' inputs (`chip_smoke.block_lane_chain_inputs`: SV
    T=250, D=30, N=25; spatial T=1024, 8x8, N=25) at C = 1, 8 and 32 against
    C one-chain launches, with its bound; torch.profiler over the batched SV
    (C = 32) and spatial (C = 8) csmc-guided steps; and their samples/s of
    all chains against the chain loop, in turns.
  - onechain: samples/s of one chain's MH steps, f32, parallel, 20 steps
    after 3, in two turns: the flagship (T=1024, dx=16, order 1 and 2, from
    x = 0), SV kalman-1 (T=250, D=30, from the committed run's xs_true at
    its delta) and the Lorenz Gibbs sampler (Mider freq 4, from the
    committed mean_x and theta at delta 1e20): the host cost of one chain's
    step, to compare two checkouts' one-chain paths.
Kernel times are CUDA events around the wrapper's call. The build log's
registers and spills of the timed kernels' template instances are printed.
The last line is one JSON object of every number.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def profile(step, n, names):
    """(wall ms, busy ms, ms of the kernels whose name holds each of `names`)
    a call of step(), over n calls after one. `names` may also map a label
    to the names it sums."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    step()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - tic) / n
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    out = {"step_ms": wall, "busy_ms": busy}
    if not isinstance(names, dict):
        names = {name: (name,) for name in ((names,) if isinstance(names, str) else names)}
    for label, subs in names.items():
        out[f"{label}_ms"] = sum(e.self_device_time_total for e in kernels
                                 if any(sub in e.key for sub in subs)) / 1e3 / n
    return out


def device_ms(fn, reps):
    """Milliseconds of the card's kernels a call of fn(), by torch.profiler
    over `reps` calls after one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def device_launches_ms(fn, reps):
    """Milliseconds of each kernel the card ran over `reps` calls of fn()
    (after one), by torch.profiler, in launch order; where the profiler
    lists no kernel event, the mean by `device_ms` alone (printed)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        print("  (no kernel events listed: the mean alone)", flush=True)
        return [device_ms(fn, reps)]
    return [e.time_range.elapsed_us() / 1e3 for e in events]


def ptxas_lines(build_dir, names):
    """Registers and spills of each kernel entry whose name holds one of
    `names`, from the build's ptxas log."""
    out, entry = [], None
    for line in (Path(build_dir) / "ptxas.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and any(n in entry for n in names) and ("Used" in line or "spill" in line):
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent))
    parser.add_argument("--parts",
                        default="masses,lane,steps,factor,draws,scan,pgas,maps,rows,scalar,sv32,"
                                "lorenz,chains,onechain")
    parser.add_argument("--sass", default=None,
                        help="directory for the SASS of the draw kernels and col_sample")
    opts = parser.parse_args()
    root, parts = str(Path(opts.root).resolve()), opts.parts.split(",")
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF
    from aux_ssm_tpu_torch.ops.cuda import stitching as KS
    from aux_ssm_tpu_torch.ops.cuda._build import LIBRARY

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    LIBRARY.get()
    print(f"root {root}: built in {LIBRARY.build_seconds:.1f} s", flush=True)
    for line in ptxas_lines(LIBRARY.build_dir, ("block_masses_kernel", "block_lane_kernel",
                                                "factor_kernel", "factor_warp_kernel",
                                                "pair_scores_kernel", "stitch_draws_kernel",
                                                "within_block_cols_kernel", "FilterOp",
                                                "filter_scan_kernel", "combine_cycles",
                                                "lane_kernel", "lane_warp_kernel",
                                                "lane_block_kernel", "elements_kernel",
                                                "scan_kernel", "ell_kernel",
                                                "backward_maps_kernel", "logdensity_kernel",
                                                "AffineOp", "row_lse_kernel",
                                                "col_sample_kernel", "scalar_scan_kernel",
                                                "scalar_cols_kernel")):
        print("  ptxas", line)
    dev, f32 = torch.device("cuda"), torch.float32
    res = {"root": root, "card": card}

    if "masses" in parts or "steps" in parts or "draws" in parts:
        bxs, bys = cs.pit_big_data(dev, f32)
        delta = torch.full((cs.PIT_T,), cs.PIT_DELTA, dtype=f32, device=dev)
    if "masses" in parts:
        masses(cs, KS, res, bxs, bys, delta)
    if {"lane", "steps", "factor"} & set(parts):
        xs, ys = cs.spatial_data(dev, f32)
        sp_delta = torch.full((cs.SP_T,), cs.SP_DELTA0, dtype=f32, device=dev)
    if "lane" in parts:
        lanes(cs, CF, res, dev, xs, ys, sp_delta)
    if "steps" in parts:
        steps(cs, res, dev, bxs, bys, delta, xs, ys, sp_delta)
    if "factor" in parts:
        factors(cs, CF, res, dev, xs, ys, sp_delta)
    if "draws" in parts:
        draws(cs, KS, res, dev, bxs, bys, delta, LIBRARY.build_dir, opts.sass)
    if "scan" in parts:
        scans(cs, res, dev)
    if "pgas" in parts:
        pgas(cs, CF, res, dev)
    if "maps" in parts:
        maps(cs, res, dev)
    if "rows" in parts:
        rows(cs, KS, res, dev)
        write_sass(LIBRARY.build_dir, opts.sass, ("col_sample_kernel",), "rows")
    if "scalar" in parts:
        scalar(cs, res, dev)
    if "sv32" in parts:
        sv32(cs, res, dev)
    if "lorenz" in parts:
        lorenz(cs, res, dev)
    if "chains" in parts:
        chains(cs, res, dev)
        csmc_chains(cs, CF, res, dev)
    if "onechain" in parts:
        onechain(cs, res, dev)
    print(json.dumps(res), flush=True)
    return 0


def masses(cs, KS, res, bxs, bys, delta):
    """block_masses on an N=4096 step's levels."""
    seen = cs.pit_step_inputs(*cs.sv_pit_kernel(bys, cs.PIT_N, stitch="blocked"), bxs, delta,
                              seed=16)["block_masses"]
    level0 = seen[0]
    res["block_masses_level0_ms"] = cs.cuda_ms(lambda: KS.block_masses(*level0), 10)
    res["block_masses_level0_per_block_ms"] = cs.cuda_ms(
        lambda: KS.block_masses(*level0, True), 10)
    res["block_masses_levels_ms"] = [cs.cuda_ms(lambda a=a: KS.block_masses(*a), 5) for a in seen]
    res["block_masses_step_ms"] = sum(res["block_masses_levels_ms"])
    res["block_masses_shapes"] = [list(a[0].shape) for a in seen]
    print(f"  block_masses level 0 {res['block_masses_level0_ms']:.4f} ms (per-block max "
          f"{res['block_masses_level0_per_block_ms']:.4f}), the step's {len(seen)} levels "
          f"{res['block_masses_step_ms']:.4f} ms", flush=True)


def lanes(cs, CF, res, dev, xs, ys, sp_delta):
    """The block-lane sweep on real steps' inputs."""
    import torch
    f32 = torch.float32
    for label, N_, reps in (("sv_N25", cs.SV_N, 20), ("sv_N1024", 1024, 3)):
        args = cs.sv_sweep_inputs(dev, f32, "csmc-guided", N_, seed=4)["block_lane_scan"]
        res[f"block_lane_{label}_ms"] = cs.cuda_ms(lambda: CF.block_lane_scan(*args), reps)
    for style in ("csmc-guided", "csmc-guided-grad"):
        init, kernel = cs.spatial_kernel(style, ys, cs.SP_D, cs.SP_N)
        with cs.recording_sweeps() as rec:
            kernel(init(xs), sp_delta, generator=torch.Generator(device=dev).manual_seed(13))
        args = rec["block_lane_scan"]
        res[f"block_lane_spatial_{style}_ms"] = cs.cuda_ms(lambda: CF.block_lane_scan(*args), 10)
    print("  block_lane " + ", ".join(f"{k[11:-3]} {v:.4f} ms" for k, v in res.items()
                                      if k.startswith("block_lane_")), flush=True)


def steps(cs, res, dev, bxs, bys, delta, xs, ys, sp_delta):
    """Steps of the N=4096 PIT sampler and of spatial csmc-guided under the
    profiler."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(21)
    for draws in ("joint", "fused"):
        init, kernel = cs.sv_pit_kernel(bys, cs.PIT_N, draws=draws)
        box = [init(bxs)]
        res[f"pit_N4096_{draws}"] = profile(
            lambda: box.__setitem__(0, kernel(box[0], delta, generator=gen)), 5,
            ("block_masses", "stitch_draws", "within_block_cols"))
    for style in ("csmc-guided", "csmc-guided-grad"):
        init, kernel = cs.spatial_kernel(style, ys, cs.SP_D, cs.SP_N)
        box = [init(xs)]
        res[f"spatial_{style}"] = profile(
            lambda: box.__setitem__(0, kernel(box[0], sp_delta, generator=gen)), 10,
            "block_lane")
    for key in ("pit_N4096_joint", "pit_N4096_fused", "spatial_csmc-guided",
                "spatial_csmc-guided-grad"):
        print(f"  profile {key}: " + ", ".join(f"{k} {v:.3f}" for k, v in res[key].items()),
              flush=True)


def factors(cs, CF, res, dev, xs, ys, sp_delta):
    """The factor sweeps on real steps' inputs and at the block path's N,
    the pair-score pass alone, the chain's floor at N=1, and the spatial
    csmc and csmc-guided steps under the profiler."""
    import torch
    f32 = torch.float32
    csmc = cs.sv_sweep_inputs(dev, f32, "csmc", cs.SV_N, seed=4)
    guided = cs.sv_sweep_inputs(dev, f32, "csmc-guided", cs.SV_N, seed=4)
    cases = {"sv_N25": (csmc["forward_factor_scan"], guided["backward_factor_scan"], 20)}
    spatial = {}
    for style in ("csmc", "csmc-guided"):
        init, kernel = cs.spatial_kernel(style, ys, cs.SP_D, cs.SP_N)
        with cs.recording_sweeps() as rec:
            kernel(init(xs), sp_delta, generator=torch.Generator(device=dev).manual_seed(13))
        spatial[style] = (init, kernel, rec)
    cases["spatial_N25"] = (spatial["csmc"][2]["forward_factor_scan"],
                            spatial["csmc-guided"][2]["backward_factor_scan"], 10)
    for n, N, k, reps in ((249, 300, 30, 10), (1023, 4096, 1, 3), (1023, 1, 64, 10)):
        rf, cf, rb, cb, res_u, anc_u, w0 = (z.float() for z in cs.random_factor_inputs(
            dev, n, N, k, seed=5))
        cases[f"N{N}_k{k}"] = ((rf, cf, rb, cb, res_u, anc_u, w0),
                               (rf, cf, rb, cb, anc_u, torch.tensor(0, device=dev)), reps)
    for label, (fwd, bwd, reps) in cases.items():
        res[f"forward_factor_{label}_ms"] = cs.cuda_ms(lambda: CF.forward_factor_scan(*fwd), reps)
        res[f"backward_factor_{label}_ms"] = cs.cuda_ms(lambda: CF.backward_factor_scan(*bwd),
                                                        reps)
        if hasattr(CF, "pair_scores") and fwd[0].shape[1] <= CF.WARP_N:
            res[f"pair_scores_{label}_ms"] = cs.cuda_ms(
                lambda: CF.pair_scores(fwd[0], fwd[1], fwd[2:5], fwd[5]), reps)
        print(f"  factor {label} (n, N, k = {tuple(fwd[0].shape)}): " + ", ".join(
            f"{key.removesuffix(f'_{label}_ms')} {res[key]:.4f} ms" for key in res
            if key.endswith(f"_{label}_ms")), flush=True)
    gen = torch.Generator(device=dev).manual_seed(22)
    for style, (init, kernel, _) in spatial.items():
        box = [init(xs)]
        res[f"spatial_{style}"] = profile(
            lambda: box.__setitem__(0, kernel(box[0], sp_delta, generator=gen)), 10,
            ("forward_factor", "backward_factor", "pair_scores", "block_lane"))
        print(f"  profile spatial_{style}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in res[f"spatial_{style}"].items()), flush=True)


def draws(cs, KS, res, dev, bxs, bys, delta, build_dir, sass_dir):
    """The draw kernels on an N=4096 step's levels, at N=128 and on random
    inputs; their SASS into sass_dir, if given."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", Path(__file__).resolve().parent / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    for mode, name in (("fused", "stitch_draws"), ("joint", "within_block_cols")):
        fn = getattr(KS, name)
        seen = cs.pit_step_inputs(*cs.sv_pit_kernel(bys, cs.PIT_N, stitch="blocked", draws=mode),
                                  bxs, delta, seed=16)[name]
        small = cs.pit_step_inputs(*cs.sv_pit_kernel(bys, 128, stitch="blocked", draws=mode),
                                   bxs, delta, seed=16)[name][0]
        res[f"{name}_level0_ms"] = cs.cuda_ms(lambda: fn(*seen[0]), 10)
        res[f"{name}_levels_ms"] = [cs.cuda_ms(lambda a=a: fn(*a), 5) for a in seen]
        res[f"{name}_step_ms"] = sum(res[f"{name}_levels_ms"])
        res[f"{name}_N128_ms"] = cs.cuda_ms(lambda: fn(*small), 20)
        for label, P, N, k in here.DRAW_CASES:
            args = here.random_draw_inputs(dev, P, N, k, seed=17)[mode == "joint"]
            res[f"{name}_N{N}_k{k}_ms"] = cs.cuda_ms(lambda: fn(*args), 10)
        print(f"  {name} level 0 {res[f'{name}_level0_ms']:.4f} ms, the step's {len(seen)} "
              f"levels {res[f'{name}_step_ms']:.4f} ms (" + ", ".join(
                  f"{v:.4f}" for v in res[f"{name}_levels_ms"]) + "), " + ", ".join(
                  f"{key[len(name) + 1:-3]} {res[key]:.4f} ms" for key in res
                  if key.startswith(f"{name}_N")), flush=True)
    write_sass(build_dir, sass_dir, ("stitch_draws_kernel", "within_block_cols_kernel"), "draws")


def write_sass(build_dir, sass_dir, names, tag):
    """The SASS of the kernels whose name holds one of `names` into
    sass_dir/sass_<tag>_<build>.txt, if sass_dir is given."""
    import shutil
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    lib = Path(build_dir) / "libaux_ssm_kernels.so"
    if sass_dir and Path(cuobjdump).exists() and lib.exists():
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True)
        keep = [part for part in sass.stdout.split("Function : ")[1:]
                if any(name in part.splitlines()[0] for name in names)]
        out = Path(sass_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"sass_{tag}_{Path(build_dir).name}.txt"
        path.write_text("".join("Function : " + part for part in keep))
        print(f"  SASS of {len(keep)} {tag} kernels in {path}", flush=True)


def scans(cs, res, dev):
    """The filter and affine scans at the MH step's shapes, the filter
    scan's floor, combine cycles and timeline, and MH order-1 steps under
    the profiler."""
    import statistics
    import torch
    from aux_ssm_tpu_torch import get_kernel
    from aux_ssm_tpu_torch.models import lgssm_flagship
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS
    from aux_ssm_tpu_torch.ops.filtering import _make_associative_elements, kalman_update
    from aux_ssm_tpu_torch.ops.sampling import _backward_maps
    f32, T, DX = torch.float32, cs.T, cs.DX
    gen = torch.Generator(device=dev).manual_seed(1)
    dyn, obs1, _ = lgssm_flagship.build_model(T, DX, device=dev, dtype=f32)
    x = torch.zeros(T, DX, dtype=f32, device=dev)
    u = x + (0.5 * cs.DELTA) ** 0.5 * torch.randn(T, DX, generator=gen, device=dev)
    m0, P0, Fs, Qs, bs = dyn(x)
    ys, Hs, Rs, cs_ = (z.contiguous() for z in obs1(x, u, cs.DELTA))
    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs_[0], Rs[0])
    elems = _make_associative_elements(Fs, Qs, bs, Hs[1:], Rs[1:], cs_[1:], ys[1:], m0u, P0u)
    for label, k in (("n1023", T - 1), ("n299", 299), ("n2", 2)):
        sub = tuple(z[:k].contiguous() for z in elems)
        res[f"filter_scan_{label}_ms"] = cs.cuda_ms(lambda: FS.filter_scan(sub), 20)
    _, ms, Ps, _, _ = FS.filter_scan(elems)
    ms, Ps = torch.cat([m0u[None], ms]), torch.cat([P0u[None], Ps])
    gains, incs = _backward_maps(torch.randn(T, DX, generator=gen, device=dev), ms, Ps, Fs, Qs, bs)
    res["affine_scan_n1024_ms"] = cs.cuda_ms(lambda: FS.affine_scan(gains, incs, True), 20)
    print("  scans " + ", ".join(f"{k[:-3]} {v:.4f} ms" for k, v in res.items()
                                 if k.endswith("_ms") and "scan_n" in k), flush=True)
    if hasattr(FS, "combine_cycles"):
        for dt in (torch.float32, torch.float64):
            e2 = tuple(z[:2].to(dt) for z in elems)
            for nt in (32, 64, 128, 256):
                key = f"combine_cycles_{str(dt)[6:]}_nt{nt}"
                res[key] = FS.combine_cycles(e2, nt, 50)[0]
        print("  combine cycles " + ", ".join(f"{k[15:]} {v:.0f}" for k, v in res.items()
                                              if k.startswith("combine_cycles")), flush=True)
    if hasattr(FS, "filter_scan_timeline"):
        FS.filter_scan_timeline(elems)
        st = FS.filter_scan_timeline(elems)[1].cpu().double()
        rel = st - st[:, :1]
        res["timeline_median_cycles"] = [statistics.median(rel[:, i].tolist())
                                         for i in range(rel.shape[1])]
        res["timeline_last_block_cycles"] = rel[-1].tolist()
        res["timeline_spread_start_cycles"] = float(st[:, 0].max() - st[:, 0].min())
        print("  timeline (cycles from a block's start: chunk, levels, hop, end): median "
              + " ".join(f"{v:.0f}" for v in res["timeline_median_cycles"][1:]) + "; last block "
              + " ".join(f"{v:.0f}" for v in res["timeline_last_block_cycles"][1:]), flush=True)
    dyn2, o1, _, tf = lgssm_flagship.build_order2_factory(T, DX, device=dev, dtype=f32)
    init, kernel = get_kernel(dyn2, o1, tf, parallel=True)
    box, g = [init(torch.zeros(T, DX, dtype=f32, device=dev))], torch.Generator(device=dev)
    g.manual_seed(3)
    res["mh_order1"] = profile(lambda: box.__setitem__(0, kernel(box[0], cs.DELTA, generator=g)),
                               20, ("FilterOp", "filter_scan_kernel", "AffineOp"))
    print("  profile mh_order1: " + ", ".join(f"{k} {v:.3f}" for k, v in res["mh_order1"].items()),
          flush=True)


def pgas(cs, CF, res, dev):
    """The lane sweep at the scalar-state models' shapes and its floor, and
    theta-logistic PGAS steps under the profiler."""
    import torch
    from aux_ssm_tpu_torch.models import ar1_gauss, rare_event as rev, theta_logistic as tl
    f32 = torch.float32
    xs, ys = cs.theta_data(dev, f32)
    init, kernel = tl.get_pgas_kernel(ys, cs.TL_N)
    with cs.recording_sweeps() as rec:
        kernel(init(xs), generator=torch.Generator(device=dev).manual_seed(8))
    theta = rec["lane_scan"]
    Mt, Gt = theta[0], theta[1]
    cases = {"theta_N256_pgas": theta, "theta_N256": theta[:2] + (None,) + theta[3:]}
    for N in (1, 33, 1024):  # the one-warp chain's floor; the block path's edges
        cases[f"theta_N{N}_pgas"] = (Mt, Gt, Mt) + cs.random_lane_inputs(dev, f32, cs.TL_T - 1,
                                                                         N, 9)
    y, rho, r2, T_ = cs.RE_CELL
    init, kernel = rev.get_guided_csmc_kernel(y, rho, r2, T_, cs.RE_N, backward=True, dtype=f32,
                                              device=dev)
    with cs.recording_sweeps() as rec:
        kernel(init(torch.tensor([[3.0], [3.4]], dtype=f32, device=dev)), 1.0,
               generator=torch.Generator(device=dev).manual_seed(10))
    guided = rec["lane_scan"]
    cases["rare_guided_N25_pgas"] = guided[:2] + (guided[0],) + guided[3:]
    _, _, Mb, Gb = rev.get_feynman_kac(y, rho, r2, 9, dtype=f32, device=dev)
    cases["rare_bootstrap_T9_N25"] = (Mb, Gb, None) + cs.random_lane_inputs(dev, f32, 8,
                                                                            cs.RE_N, 11)
    _, _, Ma, Ga = ar1_gauss.get_feynman_kac(torch.zeros(1023, 1, dtype=f32, device=dev))
    ar = cs.random_lane_inputs(dev, f32, 1023, 4096, 9)
    cases["ar1_N4096"] = (Ma, Ga, None) + ar
    cases["ar1_N4096_pgas"] = (Ma, Ga, Ma) + ar
    for label, args in cases.items():
        reps = 3 if "N4096" in label else 20
        res[f"lane_{label}_ms"] = cs.cuda_ms(lambda: CF.lane_scan(*args), reps)
    print("  lane " + ", ".join(f"{k[5:-3]} {v:.4f} ms" for k, v in res.items()
                                if k.startswith("lane_")), flush=True)
    init, kern = tl.get_pgas_kernel(ys, cs.TL_N, ancestor_sampling=True)
    box, g = [init(xs)], torch.Generator(device=dev).manual_seed(14)
    res["theta_pgas_step"] = profile(lambda: box.__setitem__(0, kern(box[0], generator=g)), 50,
                                     "lane_")
    print("  profile theta_pgas_step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["theta_pgas_step"].items()), flush=True)


# The MH step's kernels by the names of their entries, old and new.
MH_KERNELS = {"make_elements": ("elements_kernel",), "ell": ("ell_kernel",),
              "filter_scan": ("filter_scan_kernel", "FilterOp"),
              "backward_maps": ("backward_maps_kernel",), "affine_scan": ("AffineOp",),
              "logdensity_steps": ("logdensity_kernel",)}


def phases(stamps):
    """The median over rows of each column of clock64 `stamps` less the
    row's first."""
    import statistics
    rel = (stamps - stamps[:, :1]).cpu().double()
    return [statistics.median(rel[:, i].tolist()) for i in range(1, rel.shape[1])]


def maps(cs, res, dev):
    """The six MH kernels on chip_smoke phase 1's inputs, their variants and
    clock64 phases where the checkout has them, and MH order-1 steps under
    the profiler."""
    import torch
    from aux_ssm_tpu_torch import get_kernel
    from aux_ssm_tpu_torch.models import lgssm_flagship
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS
    from aux_ssm_tpu_torch.ops.cuda import kalman_fused as KF
    from aux_ssm_tpu_torch.ops.filtering import _make_associative_elements, kalman_update
    from aux_ssm_tpu_torch.ops.sampling import _backward_maps
    f32, T, DX = torch.float32, cs.T, cs.DX
    gen = torch.Generator(device=dev).manual_seed(1)
    dyn, obs1, _ = lgssm_flagship.build_model(T, DX, device=dev, dtype=f32)
    x = torch.zeros(T, DX, dtype=f32, device=dev)
    u = x + (0.5 * cs.DELTA) ** 0.5 * torch.randn(T, DX, generator=gen, device=dev)
    m0, P0, Fs, Qs, bs = dyn(x)
    ys, Hs, Rs, cs_ = (z.contiguous() for z in obs1(x, u, cs.DELTA))
    steps = (Fs, Qs, bs, Hs[1:], Rs[1:], cs_[1:], ys[1:])
    n = T - 1
    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs_[0], Rs[0])
    el = steps + (torch.cat([m0u[None], m0u.new_zeros(n - 1, DX)]),
                  torch.cat([P0u[None], P0u.new_zeros(n - 1, DX, DX)]))
    elems = _make_associative_elements(*steps, m0u, P0u)
    _, ms, Ps, _, _ = FS.filter_scan(elems)
    ms, Ps = torch.cat([m0u[None], ms]), torch.cat([P0u[None], Ps])
    eps = torch.randn(T, DX, generator=gen, device=dev)
    gains, incs = _backward_maps(eps, ms, Ps, Fs, Qs, bs)
    xs = FS.affine_scan(gains, incs, reverse=True)[1]
    filt = (ms[:-1].contiguous(), Ps[:-1].contiguous())
    traj = (xs[:-1].contiguous(), xs[1:].contiguous())
    steps64, filt64, traj64, elems64 = (tuple(z.double() for z in zs)
                                        for zs in (steps, filt, traj, elems))
    elems299, elems64_299 = (tuple(z[:299] for z in e) for e in (elems, elems64))
    calls = {
        "make_elements": lambda: KF.make_elements(*el),
        "filter_scan": lambda: FS.filter_scan(elems),
        "filter_scan_n299": lambda: FS.filter_scan(elems299),
        "filter_scan_f64": lambda: FS.filter_scan(elems64),
        "filter_scan_f64_n299": lambda: FS.filter_scan(elems64_299),
        "ell": lambda: KF.ell(*steps, *filt),
        "ell_f64": lambda: KF.ell(*steps64, *filt64),
        "backward_maps": lambda: KF.backward_maps(Fs, Qs, bs, *filt, eps[:-1].contiguous()),
        "backward_maps_f64": lambda: KF.backward_maps(*steps64[:3], *filt64,
                                                      eps[:-1].double().contiguous()),
        "affine_scan": lambda: FS.affine_scan(gains, incs, True),
        "affine_scan_n300": lambda: FS.affine_scan(gains[:300], incs[:300], True),
        "affine_scan_n2": lambda: FS.affine_scan(gains[:2], incs[:2], True),
        "logdensity_steps": lambda: KF.logdensity_steps(*steps, *traj),
        "logdensity_steps_f64": lambda: KF.logdensity_steps(*steps64, *traj64)}
    for name, fn in calls.items():
        res[f"mh_{name}_ms"] = cs.cuda_ms(fn, 50)
        res[f"mh_{name}_device_ms"] = device_ms(fn, 20)
    print("  mh kernels (events / device ms) " + ", ".join(
        f"{name} {res[f'mh_{name}_ms']:.4f} / {res[f'mh_{name}_device_ms']:.4f}"
        for name in calls), flush=True)
    if hasattr(KF, "elements_cycles"):
        KF.elements_cycles(el)
        res["elements_phases"] = phases(KF.elements_cycles(el))
        print("  make_elements median step cycles (staged, S, solve, K, end) "
              + " ".join(f"{v:.0f}" for v in res["elements_phases"]), flush=True)
    if hasattr(KF, "maps_cycles"):
        margs = (Fs, Qs, bs, *filt, eps[:-1].contiguous())
        KF.maps_cycles(margs)
        res["maps_phases"] = phases(KF.maps_cycles(margs))
        print("  backward_maps median step cycles (staged, S, solve, cov, factor, end) "
              + " ".join(f"{v:.0f}" for v in res["maps_phases"]), flush=True)
    if hasattr(FS, "affine_scan_timeline"):
        for team in (32, 64, 128):
            res[f"affine_combine_cycles_t{team}"] = FS.combine_cycles(
                (gains, incs), team, 50, scan="affine")[0]
        print("  affine combine cycles (team): " + ", ".join(
            f"{k[22:]} {v:.0f}" for k, v in res.items() if k.startswith("affine_combine")),
            flush=True)
        FS.affine_scan_timeline(gains, incs, True)
        st = FS.affine_scan_timeline(gains, incs, True)[1]
        res["affine_timeline_median_cycles"] = phases(st)
        res["affine_timeline_last_block_cycles"] = (st[-1] - st[-1, 0]).tolist()[1:]
        print("  affine timeline (cycles from a block's start: chunk, levels, hop, end): median "
              + " ".join(f"{v:.0f}" for v in res["affine_timeline_median_cycles"]) + "; last block "
              + " ".join(f"{v:.0f}" for v in res["affine_timeline_last_block_cycles"]), flush=True)
    dyn2, o1, _, tf = lgssm_flagship.build_order2_factory(T, DX, device=dev, dtype=f32)
    init, kernel = get_kernel(dyn2, o1, tf, parallel=True)
    box, g = [init(torch.zeros(T, DX, dtype=f32, device=dev))], torch.Generator(device=dev)
    g.manual_seed(3)
    res["mh_order1_maps"] = profile(
        lambda: box.__setitem__(0, kernel(box[0], cs.DELTA, generator=g)), 20, MH_KERNELS)
    print("  profile mh_order1: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                              res["mh_order1_maps"].items()), flush=True)


def rows(cs, KS, res, dev):
    """row_lse and col_sample at each level of real SV and spatial PIT steps,
    row_lse at the N=4096 root and at a mid-size level; the two PIT steps
    under the profiler."""
    import torch
    f32 = torch.float32
    ys, xs, delta = cs.load_sv("csmc_no-gradient", dev, f32)
    sv = cs.sv_pit_kernel(ys, cs.SV_N)
    sxs, sys_ = cs.spatial_data(dev, f32)
    sp_delta = torch.full((cs.SP_T,), cs.SP_DELTA0, dtype=f32, device=dev)
    sp = cs.spatial_kernel("csmc-pit", sys_, cs.SP_D, cs.SP_N)
    bxs, bys = cs.pit_big_data(dev, f32)
    big_delta = torch.full((cs.PIT_T,), cs.PIT_DELTA, dtype=f32, device=dev)
    cases = {"sv": cs.pit_step_inputs(*sv, xs, delta, seed=16),
             "spatial": cs.pit_step_inputs(*sp, sxs, sp_delta, seed=16)}
    for label, seen in cases.items():
        for name, at, f64 in (("row_lse", 0, False), ("col_sample", 1, False),
                              ("col_sample", 1, True)):
            fn = getattr(KS, name)
            levels = [tuple(z.double() if f64 and torch.is_tensor(z) and z.is_floating_point()
                            else z for z in a) for a in seen[name]]
            dev_ms = [device_ms(lambda a=a: fn(*a), 20) for a in levels]
            ev_ms = [cs.cuda_ms(lambda a=a: fn(*a), 20) for a in levels]
            key = f"rows_{label}_{name}" + ("_f64" if f64 else "")
            res[f"{key}_P"] = [int(a[at].shape[0]) for a in levels]
            res[f"{key}_level_device_ms"], res[f"{key}_level_ms"] = dev_ms, ev_ms
            res[f"{key}_step_device_ms"] = sum(dev_ms)
            print(f"  {label} {name}{' f64' if f64 else ''} by level (P {res[f'{key}_P']}): "
                  "device ms " + " ".join(f"{v:.4f}" for v in dev_ms)
                  + f" (the step's {len(dev_ms)} launches {sum(dev_ms):.4f}); events "
                  + " ".join(f"{v:.4f}" for v in ev_ms), flush=True)
    root = cs.pit_step_inputs(*cs.sv_pit_kernel(bys, cs.PIT_N, stitch="blocked"), bxs,
                              big_delta, seed=16)["row_lse"][-1]
    root64 = tuple(z.double() for z in root)
    g = torch.Generator(device=dev).manual_seed(13)
    mid = tuple(scale * torch.randn(shape, generator=g, device=dev, dtype=f32)
                for scale, shape in ((0.4, (512, 1000, 30)), (0.4, (512, 1000, 30)),
                                     (1.0, (512, 1000))))
    mid64 = tuple(z.double() for z in mid)
    for key, args in (("rows_n4096_root", root), ("rows_n4096_root_f64", root64),
                      ("rows_mid", mid), ("rows_mid_f64", mid64)):
        res[f"{key}_device_ms"] = device_ms(lambda: KS.row_lse(*args), 20)
        res[f"{key}_ms"] = cs.cuda_ms(lambda: KS.row_lse(*args), 20)
        print(f"  {key} row_lse: device {res[f'{key}_device_ms']:.4f} ms, events "
              f"{res[f'{key}_ms']:.4f}", flush=True)
    names = {"row_lse": ("row_lse_kernel",), "col_sample": ("col_sample_kernel",)}
    for label, (init, kernel), x0, dl in (("sv", sv, xs, delta), ("spatial", sp, sxs, sp_delta)):
        box, g = [init(x0)], torch.Generator(device=dev).manual_seed(16)
        res[f"rows_{label}_pit_step"] = profile(
            lambda: box.__setitem__(0, kernel(box[0], dl, generator=g)), 20, names)
        print(f"  profile {label} PIT step: " + ", ".join(
            f"{k} {v:.4f}" for k, v in res[f"rows_{label}_pit_step"].items()), flush=True)


def scalar(cs, res, dev):
    """The scalar scans on a real spatial kalman-1 step's inputs (T=1024,
    B=64), cut to n=299 and repeated to a 64 x 64 field (B=4096), f32 and
    f64, the affine scan reversed and forward: device ms a launch by
    torch.profiler (the mean and the spread of 30 launches) and CUDA events;
    kalman-1 steps under the profiler."""
    import statistics
    import torch
    from aux_ssm_tpu_torch.ops.cuda import scalar_scan as SS
    f32 = torch.float32
    xs, ys = cs.spatial_data(dev, f32)
    init, kernel = cs.spatial_kernel("kalman-1", ys, cs.SP_D, cs.SP_N)
    with cs.recording_scalar_scans() as seen:
        kernel(init(xs), cs.SP_DELTA0, generator=torch.Generator(device=dev).manual_seed(12))
    (elems,), _ = seen["scalar_filter_scan"]
    (gains, incs), _ = seen["scalar_affine_scan"]
    elems = tuple(z.contiguous() for z in elems)
    for label, cut in (("T1024", lambda z: z), ("T300", lambda z: z[:299].contiguous()),
                       ("T1024_B4096", lambda z: z.repeat(1, 64)),
                       ("T300_B4096", lambda z: z[:299].repeat(1, 64))):
        for dtype in (torch.float32, torch.float64):
            e = tuple(cut(z).to(dtype) for z in elems)
            g, i = ((cut(gains), cut(incs)) if label.startswith("T1024")
                    else (cut(gains[1:]), cut(incs[1:])))
            g, i = g.to(dtype), i.to(dtype)
            tag = label + ("_f64" if dtype == torch.float64 else "")
            line = []
            for name, fn in (("filter", lambda: SS.scalar_filter_scan(e)),
                             ("affine", lambda: SS.scalar_affine_scan(g, i, True)),
                             ("affine_forward", lambda: SS.scalar_affine_scan(g, i, False))):
                each = device_launches_ms(fn, 30)
                key = f"scalar_{name}_{tag}"
                res[f"{key}_device_ms"] = statistics.fmean(each)
                res[f"{key}_device_spread_ms"] = [min(each), statistics.median(each), max(each)]
                res[f"{key}_ms"] = cs.cuda_ms(fn, 20)
                line.append(f"{name} device {res[f'{key}_device_ms']:.4f} ms (min / median / max "
                            + " / ".join(f"{v:.4f}" for v in res[f"{key}_device_spread_ms"])
                            + f"; events {res[f'{key}_ms']:.4f})")
            print(f"  scalar scans {tag} (n={e[0].shape[0]}, B={e[0].shape[1]}): "
                  + ", ".join(line), flush=True)
    box, gen = [init(xs)], torch.Generator(device=dev).manual_seed(12)
    res["scalar_kalman1_step"] = profile(
        lambda: box.__setitem__(0, kernel(box[0], cs.SP_DELTA0, generator=gen)), 20,
        {"scalar_scans": ("scalar_scan_kernel", "scalar_cols_kernel")})
    print("  profile spatial kalman-1 step: " + ", ".join(
        f"{k} {v:.4f}" for k, v in res["scalar_kalman1_step"].items()), flush=True)



def mh_calls(steps, m0u, P0u, eps):
    """The six MH kernels' calls on one step's inputs (as chip_smoke's
    `mh_inputs` gives them): (calls by name, make_elements' arguments,
    backward_maps', the elements, the gains and increments)."""
    import torch
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS
    from aux_ssm_tpu_torch.ops.cuda import kalman_fused as KF
    from aux_ssm_tpu_torch.ops.filtering import _make_associative_elements
    from aux_ssm_tpu_torch.ops.sampling import _backward_maps
    Fs, Qs, bs = steps[:3]
    n, d = bs.shape
    el = steps + (torch.cat([m0u[None], m0u.new_zeros(n - 1, d)]),
                  torch.cat([P0u[None], P0u.new_zeros(n - 1, d, d)]))
    elems = _make_associative_elements(*steps, m0u, P0u)
    _, ms, Ps, _, _ = FS.filter_scan(elems)
    ms, Ps = torch.cat([m0u[None], ms]), torch.cat([P0u[None], Ps])
    gains, incs = _backward_maps(eps, ms, Ps, Fs, Qs, bs)
    xs_ = FS.affine_scan(gains, incs, reverse=True)[1]
    filt = (ms[:-1].contiguous(), Ps[:-1].contiguous())
    traj = (xs_[:-1].contiguous(), xs_[1:].contiguous())
    margs = (Fs, Qs, bs, *filt, eps[:-1].contiguous())
    calls = {"make_elements": (KF.make_elements, el), "filter_scan": (FS.filter_scan, (elems,)),
             "ell": (KF.ell, steps + filt), "backward_maps": (KF.backward_maps, margs),
             "affine_scan": (FS.affine_scan, (gains, incs, True)),
             "logdensity_steps": (KF.logdensity_steps, steps + traj)}
    return calls, el, margs, elems, gains, incs


def time_calls(cs, res, tag, calls):
    """Each call's ms by CUDA events and device ms by the profiler, in f32
    and on its inputs cast to f64, into res[f"{tag}_{name}[_f64]_ms"]."""
    import torch
    for name, (fn, args) in calls.items():
        args64 = tuple(tuple(z.double() for z in a) if isinstance(a, tuple)
                       else a.double() if isinstance(a, torch.Tensor) else a for a in args)
        for dt, a in (("", args), ("_f64", args64)):
            res[f"{tag}_{name}{dt}_ms"] = cs.cuda_ms(lambda: fn(*a), 50)
            res[f"{tag}_{name}{dt}_device_ms"] = device_ms(lambda: fn(*a), 20)
    print(f"  {tag} kernels (events / device ms) " + ", ".join(
        f"{name}{dt} {res[f'{tag}_{name}{dt}_ms']:.4f} / {res[f'{tag}_{name}{dt}_device_ms']:.4f}"
        for name in calls for dt in ("", "_f64")), flush=True)


def sv32(cs, res, dev):
    """The six MH kernels' D = 32 instance on a real SV kalman-1 step's
    inputs, their clock64 phases, combine cycles and scan timelines, and SV
    kalman steps under the profiler."""
    import torch
    from aux_ssm_tpu_torch.experiments import RunConfig, runner
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS
    from aux_ssm_tpu_torch.ops.cuda import kalman_fused as KF
    f32 = torch.float32
    ys, xs, delta = cs.load_sv("kalman1", dev, f32)
    dyn, obs1, _, _ = sv.get_kalman_factories(ys, *cs.SV_PARAMS)
    gen = torch.Generator(device=dev).manual_seed(20)
    u = xs + (0.5 * float(delta)) ** 0.5 * torch.randn(xs.shape, generator=gen, device=dev)
    eps = torch.randn(xs.shape, generator=gen, device=dev)
    steps, m0u, P0u = cs.mh_inputs(dyn, obs1, xs, u, float(delta))
    calls, el, margs, elems, gains, incs = mh_calls(steps, m0u, P0u, eps)
    time_calls(cs, res, "sv32", calls)
    KF.elements_cycles(el)
    res["sv32_elements_phases"] = phases(KF.elements_cycles(el))
    KF.maps_cycles(margs)
    res["sv32_maps_phases"] = phases(KF.maps_cycles(margs))
    print("  sv32 make_elements median step cycles (staged, S, solve, K, end) "
          + " ".join(f"{v:.0f}" for v in res["sv32_elements_phases"])
          + "; backward_maps (staged, S, solve, cov, factor, end) "
          + " ".join(f"{v:.0f}" for v in res["sv32_maps_phases"]), flush=True)
    for dt in (torch.float32, torch.float64):
        for scan, pair in (("filter", elems), ("affine", (gains, incs))):
            for nt in (128, 256):
                res[f"sv32_{scan}_combine_cycles_{str(dt)[6:]}_nt{nt}"] = FS.combine_cycles(
                    tuple(z[:2].to(dt) for z in pair), nt, 50, scan=scan)[0]
    print("  sv32 combine cycles " + ", ".join(f"{k[5:]} {v:.0f}" for k, v in res.items()
                                               if "combine_cycles" in k and k.startswith("sv32")),
          flush=True)
    for scan, timeline in (("filter", lambda: FS.filter_scan_timeline(elems)),
                           ("affine", lambda: FS.affine_scan_timeline(gains, incs, True))):
        timeline()
        st = timeline()[1]
        res[f"sv32_{scan}_timeline_median_cycles"] = phases(st)
        res[f"sv32_{scan}_timeline_last_block_cycles"] = (st[-1] - st[-1, 0]).tolist()[1:]
        print(f"  sv32 {scan} timeline (cycles from a block's start: chunk, levels, hop, end): "
              "median " + " ".join(f"{v:.0f}" for v in res[f"sv32_{scan}_timeline_median_cycles"])
              + "; last block " + " ".join(
                  f"{v:.0f}" for v in res[f"sv32_{scan}_timeline_last_block_cycles"]), flush=True)
    for style, (name, order) in cs.SV_KALMAN.items():
        ys_, xs0, delta_ = cs.load_sv(name, dev, f32)
        init, kernel = sv.get_kalman_kernel(ys_, *cs.SV_PARAMS, True, order)
        g = torch.Generator(device=dev).manual_seed(3)
        state = runner.run_chain(kernel, init(xs0), RunConfig(n_samples=1, burnin=10,
                                                              learning_rate=0.0),
                                 generator=g, delta_init=delta_).state
        box = [state]
        key = f"sv32_{style}"
        res[key] = profile(lambda: box.__setitem__(0, kernel(box[0], delta_, generator=g)), 20,
                           MH_KERNELS)
        print(f"  profile {key}: " + ", ".join(f"{k} {v:.4f}" for k, v in res[key].items()),
              flush=True)


def lorenz(cs, res, dev):
    """The six MH kernels' D = 16 instance on a real Lorenz step's inputs
    (chip_smoke phase 23's: Mider freq 4, T=5001, dx=3, dy=5, delta 1e20), the
    two scans also at freq 2 (T=10001), f32 and f64; make_elements' and
    backward_maps' clock64 phases there; Lorenz Gibbs steps (freq 4, from the
    committed run's mean_x and theta) under the profiler."""
    if not hasattr(cs, "lorenz_step_inputs"):
        print("  lorenz: not in this checkout", flush=True)
        return
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.experiments.lorenz import mider_problem
    from aux_ssm_tpu_torch.models import lorenz as model
    from aux_ssm_tpu_torch.ops.cuda import kalman_fused as KF
    f32, delta = torch.float32, cs.LORENZ_DELTAS[0]
    for freq, tag, names in ((2, "lorenz_T10001", ("filter_scan", "affine_scan")),
                             (4, "lorenz", tuple(MH_KERNELS))):
        steps, m0u, P0u, eps = cs.lorenz_step_inputs(dev, freq, f32, delta, 23)[:4]
        calls, el, margs = mh_calls(steps, m0u, P0u, eps)[:3]
        time_calls(cs, res, tag, {k: calls[k] for k in names})
    KF.elements_cycles(el)  # freq 4's
    res["lorenz_elements_phases"] = phases(KF.elements_cycles(el))
    KF.maps_cycles(margs)
    res["lorenz_maps_phases"] = phases(KF.maps_cycles(margs))
    print("  lorenz make_elements median step cycles (staged, S, solve, K, end) "
          + " ".join(f"{v:.0f}" for v in res["lorenz_elements_phases"])
          + "; backward_maps (staged, S, solve, cov, factor, end) "
          + " ".join(f"{v:.0f}" for v in res["lorenz_maps_phases"]), flush=True)
    prob = mider_problem(4, device=dev)
    committed = np.load(cs.LORENZ_NPZ.format(4))
    init, kernel = model.get_gibbs_kernel(prob.ys, prob.Hs, prob.Rs, prob.cs, prob.m0, prob.P0,
                                          cs.LORENZ_SIGMA_X, prob.dt, prob.sigma_theta, True)
    box = [init(torch.as_tensor(committed["mean_x"], device=dev), committed["theta"])]
    g = torch.Generator(device=dev).manual_seed(3)
    for _ in range(5):
        box[0] = kernel(box[0], delta, generator=g)
    res["lorenz_gibbs"] = profile(lambda: box.__setitem__(0, kernel(box[0], delta, generator=g)),
                                  20, MH_KERNELS)
    print("  profile lorenz_gibbs: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                               res["lorenz_gibbs"].items()), flush=True)

def chains(cs, res, dev):
    """The six MH kernels' chain instances at C = 1, 8 and 32 against C
    one-chain launches, at the SV and the Lorenz shapes, and the batched
    steps under the profiler."""
    if not hasattr(cs, "chain_mh_calls"):
        print("  chains: not in this checkout", flush=True)
        return
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.experiments.lorenz import mider_problem
    from aux_ssm_tpu_torch.models import lorenz as model
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    for tag, inputs in (("sv32", cs.dense_sv_inputs), ("lorenz", cs.dense_lorenz_inputs)):
        for C in (1, 8, 32):
            gen = torch.Generator(device=dev).manual_seed(30)
            steps, m0u, P0u, eps = inputs(dev, C, gen)
            calls, _, _, _, ops = cs.chain_mh_calls(steps, m0u, P0u, eps)
            for name, (fn, _, args) in calls.items():
                key = f"chains_{tag}_C{C}_{name}"
                one = [cs.chain_slice(args, c) for c in range(C)]
                got = cs.as_tuple(fn(*args))
                res[key] = {
                    "device_ms": device_ms(lambda: fn(*args), 10),
                    "loop_device_ms": device_ms(lambda: [fn(*a) for a in one], 3),
                    "ms": cs.cuda_ms(lambda: fn(*args), 10),
                    "loop_ms": cs.cuda_ms(lambda: [fn(*a) for a in one], 3),
                    **cs.bound(cs.flatten(args) + list(got), 0, ops[name]),
                    "shape": [tuple(g.shape) for g in got]}
                r = res[key]
                print(f"  {key}: device {r['device_ms']:.4f} ms (C one-chain launches "
                      f"{r['loop_device_ms']:.4f}), events {r['ms']:.4f} (loop "
                      f"{r['loop_ms']:.4f}), bound {r['bound_ms']:.5f} by {r['bound_by']} "
                      f"({r['bytes'] / 1e6:.2f} MB, {r['operations'] / 1e6:.1f} Mop)",
                      flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    ys, xs, delta = cs.load_sv("kalman1", dev, torch.float32)
    C = cs.DENSE_CHAINS["sv"]
    init, kernel = sv.get_kalman_kernel(ys, *cs.SV_PARAMS, True, order=1, chains=True)
    box = [init(xs.expand(C, -1, -1).clone())]
    delta = delta.expand(C)
    for _ in range(5):
        box[0] = kernel(box[0], delta, generator=gen)
    res["chains_sv32_step"] = profile(lambda: box.__setitem__(0, kernel(box[0], delta,
                                                                         generator=gen)),
                                      10, MH_KERNELS)
    prob = mider_problem(4, device=dev)
    committed = np.load(cs.LORENZ_NPZ.format(4))
    C = cs.DENSE_CHAINS["lorenz"]
    init, kernel = model.get_gibbs_kernel(prob.ys, prob.Hs, prob.Rs, prob.cs, prob.m0, prob.P0,
                                          cs.LORENZ_SIGMA_X, prob.dt, prob.sigma_theta, True,
                                          chains=True)
    x0 = torch.as_tensor(committed["mean_x"], device=dev).expand(C, -1, -1).clone()
    theta = torch.as_tensor(committed["theta"], device=dev).expand(C, -1).clone()
    box = [init(x0, theta)]
    delta = torch.full((C,), cs.LORENZ_DELTAS[0], device=dev)
    for _ in range(5):
        box[0] = kernel(box[0], delta, generator=gen)
    res["chains_lorenz_step"] = profile(lambda: box.__setitem__(0, kernel(box[0], delta,
                                                                           generator=gen)),
                                        10, MH_KERNELS)
    for key in ("chains_sv32_step", "chains_lorenz_step"):
        print(f"  profile {key}: " + ", ".join(f"{k} {v:.4f}" for k, v in res[key].items()),
              flush=True)
    # Samples/s of all chains: the batched step against the chain loop, in turns.
    from aux_ssm_tpu_torch.parallel.chains import chain_loop
    sv_one = sv.get_kalman_kernel(ys, *cs.SV_PARAMS, True, order=1)[1]
    lz_one = model.get_gibbs_kernel(prob.ys, prob.Hs, prob.Rs, prob.cs, prob.m0, prob.P0,
                                    cs.LORENZ_SIGMA_X, prob.dt, prob.sigma_theta, True)[1]
    sv_init, sv_batched = sv.get_kalman_kernel(ys, *cs.SV_PARAMS, True, order=1, chains=True)
    C = cs.DENSE_CHAINS["sv"]
    sv_state = sv_init(xs.expand(C, -1, -1).clone())
    sv_delta = torch.full((C,), float(cs.load_sv("kalman1", dev, torch.float32)[2]), device=dev)
    runs = {"sv32": (sv_batched, chain_loop(sv_one), sv_state, sv_delta),
            "lorenz": (kernel, chain_loop(lz_one), box[0], delta)}
    for tag, (batched, looped, state, dl) in runs.items():
        C = dl.shape[0]
        for turn, (route, kern) in enumerate((("batched", batched), ("loop", looped),
                                              ("loop", looped), ("batched", batched))):
            st = state
            for _ in range(2):
                st = kern(st, dl, generator=gen)
            torch.cuda.synchronize()
            tic = time.perf_counter()
            for _ in range(10):
                st = kern(st, dl, generator=gen)
            torch.cuda.synchronize()
            res[f"chains_{tag}_{route}_samples_per_s_turn{turn}"] = 10 * C / (
                time.perf_counter() - tic)
        print(f"  {tag}, C = {C}, samples/s of all chains (turns: batched, loop, loop, batched): "
              + ", ".join(f"{res[f'chains_{tag}_{r}_samples_per_s_turn{t}']:.1f}"
                          for t, r in enumerate(("batched", "loop", "loop", "batched"))),
              flush=True)


def csmc_chains(cs, CF, res, dev):
    """The block-lane sweep's chain instance at C = 1, 8 and 32 against C
    one-chain launches, at the SV and the spatial shapes, and the batched
    csmc-guided steps against the chain loop."""
    if not hasattr(cs, "block_lane_chain_inputs"):
        print("  block-lane chains: not in this checkout", flush=True)
        return
    import torch
    from aux_ssm_tpu_torch.models import spatial as sp
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    from aux_ssm_tpu_torch.parallel.chains import chain_loop
    f32 = torch.float32
    d_sp = cs.SP_D * cs.SP_D
    for tag in ("sv", "spatial"):
        for C in (1, 8, 32):
            args = cs.block_lane_chain_inputs(dev, f32, tag, C, False, 40 + C)
            Mt, Gt, *rest = args
            if tag == "sv":
                n_ops = 6 * cs.SV_D * cs.SV_D + 20 * cs.SV_D
            else:
                n_ops = 2 * int((Gt.c.prec != 0).sum()) + 40 * d_sp
            _, n, d, N = rest[0].shape
            one = [cs.chain_components(args, c) for c in range(C)]
            got = CF.block_lane_scan(*args)
            key = f"chains_block_lane_{tag}_C{C}"
            res[key] = {
                "device_ms": device_ms(lambda: CF.block_lane_scan(*args), 10),
                "loop_device_ms": device_ms(lambda: [CF.block_lane_scan(*a) for a in one], 3),
                "ms": cs.cuda_ms(lambda: CF.block_lane_scan(*args), 10),
                "loop_ms": cs.cuda_ms(lambda: [CF.block_lane_scan(*a) for a in one], 3),
                **cs.bound([*rest, *Gt.cuda_operands(), *got], 0, C * n * N * n_ops),
                "shape": [tuple(g.shape) for g in got]}
            r = res[key]
            print(f"  {key}: device {r['device_ms']:.4f} ms (C one-chain launches "
                  f"{r['loop_device_ms']:.4f}), events {r['ms']:.4f} (loop "
                  f"{r['loop_ms']:.4f}), bound {r['bound_ms']:.5f} by {r['bound_by']} "
                  f"({r['bytes'] / 1e6:.2f} MB, {r['operations'] / 1e6:.1f} Mop)", flush=True)
    # Samples/s of all chains of the csmc-guided steps: batched against the
    # chain loop, in turns, from the same state; and the batched step's profile.
    gen = torch.Generator(device=dev).manual_seed(4)
    ys, xs, delta = cs.load_sv("csmc_guided_no-gradient", dev, f32)
    sp_xs, sp_ys = cs.spatial_data(dev, f32)
    sp_delta = torch.full((cs.SP_T,), cs.SP_DELTA0, dtype=f32, device=dev)
    builds = {"sv": (lambda c: sv.get_guided_csmc_kernel(ys, *cs.SV_PARAMS, cs.SV_N,
                                                         backward=True, chains=c), xs, delta,
                     cs.CSMC_CHAINS["sv"]),
              "spatial": (lambda c: sp.get_guided_csmc_kernel(sp_ys, *cs.SP_PARAMS, cs.SP_D,
                                                              cs.SP_N, backward=True, chains=c),
                          sp_xs, sp_delta, cs.CSMC_CHAINS["spatial"])}
    for tag, (build, x, dl, C) in builds.items():
        init, batched = build(True)
        looped = chain_loop(build(False)[1])
        state = init(x.expand(C, -1, -1).clone())
        dl = cs.chain_deltas(dl, C)
        box = [state]
        res[f"chains_guided_{tag}_step"] = profile(
            lambda: box.__setitem__(0, batched(box[0], dl, generator=gen)), 10,
            ("block_lane", "factor"))
        print(f"  profile chains_guided_{tag}_step (C = {C}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in res[f"chains_guided_{tag}_step"].items()), flush=True)
        for turn, (route, kern) in enumerate((("batched", batched), ("loop", looped),
                                              ("loop", looped), ("batched", batched))):
            st = state
            for _ in range(2):
                st = kern(st, dl, generator=gen)
            torch.cuda.synchronize()
            tic = time.perf_counter()
            for _ in range(10):
                st = kern(st, dl, generator=gen)
            torch.cuda.synchronize()
            res[f"chains_guided_{tag}_{route}_samples_per_s_turn{turn}"] = 10 * C / (
                time.perf_counter() - tic)
        print(f"  csmc-guided {tag}, C = {C}, samples/s of all chains (turns: batched, loop, "
              "loop, batched): " + ", ".join(
                  f"{res[f'chains_guided_{tag}_{r}_samples_per_s_turn{t}']:.1f}"
                  for t, r in enumerate(("batched", "loop", "loop", "batched"))), flush=True)


def onechain(cs, res, dev):
    """Samples/s of one chain's MH steps: the flagship (order 1 and 2), SV
    kalman-1 and the Lorenz Gibbs sampler, 20 steps after 3, two turns."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch import get_kernel
    from aux_ssm_tpu_torch.experiments.lorenz import mider_problem
    from aux_ssm_tpu_torch.models import lgssm_flagship, lorenz
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    f32 = torch.float32
    runs = {}
    dyn, obs1, obs2, tf = lgssm_flagship.build_order2_factory(cs.T, cs.DX, device=dev, dtype=f32)
    for order, obs in ((1, obs1), (2, obs2)):
        init, kernel = get_kernel(dyn, obs, tf, parallel=True)
        runs[f"flagship{order}"] = [kernel, init(torch.zeros(cs.T, cs.DX, dtype=f32, device=dev)),
                                    cs.DELTA]
    ys, xs, delta = cs.load_sv("kalman1", dev, f32)
    init, kernel = sv.get_kalman_kernel(ys, *cs.SV_PARAMS, True, order=1)
    runs["sv_kalman1"] = [kernel, init(xs), delta]
    prob = mider_problem(4, device=dev)
    committed = np.load(cs.LORENZ_NPZ.format(4))
    init, kernel = lorenz.get_gibbs_kernel(prob.ys, prob.Hs, prob.Rs, prob.cs, prob.m0, prob.P0,
                                           cs.LORENZ_SIGMA_X, prob.dt, prob.sigma_theta, True)
    runs["lorenz"] = [kernel, init(torch.as_tensor(committed["mean_x"], device=dev),
                                   committed["theta"]), cs.LORENZ_DELTAS[0]]
    gen = torch.Generator(device=dev).manual_seed(4)
    for turn in range(2):
        for tag, run in runs.items():
            kernel, state, delta = run
            for _ in range(3):
                state = kernel(state, delta, generator=gen)
            torch.cuda.synchronize()
            tic = time.perf_counter()
            for _ in range(20):
                state = kernel(state, delta, generator=gen)
            torch.cuda.synchronize()
            res[f"onechain_{tag}_samples_per_s_turn{turn}"] = 20 / (time.perf_counter() - tic)
            run[1] = state
    for tag in runs:
        print(f"  one chain, {tag}: samples/s (turns) "
              + ", ".join(f"{res[f'onechain_{tag}_samples_per_s_turn{t}']:.2f}" for t in range(2)),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
