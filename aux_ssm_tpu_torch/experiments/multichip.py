"""One step of every sharded path on tiny shapes over a device list
(counterpart of `dryrun_multichip` in the JAX package's `__graft_entry__.py`),
each held against its one-device counterpart, and a launcher that runs it in
several processes joined by `torch.distributed`.

    python -m aux_ssm_tpu_torch.experiments.multichip --devices cpu cpu cpu cpu
    python -m aux_ssm_tpu_torch.experiments.multichip --processes 2 --shards 2 \\
        --platform cpu --out DIR      # two gloo processes of two CPU shards each

`dryrun_multichip(devices)` returns a dict: for each path its check (True
where bit-equal to the one-device run, or the norm-relative error of the
time scans) and the particle-sharded PIT step's output, which a
multi-process run is held to against the one-process result
(`run_processes`).
"""
import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass

import torch

from ..kernels.csmc_base import (Distribution, Dynamics, Potential, UnivariatePotential,
                                 diag_gaussian_pair_factors)

PHI, SIG_X, SIG_Y = 0.9, 0.5, 0.4


def _lp(x, m, s):
    z = (x - m) / s
    return (-0.5 * z * z - math.log(s) - 0.5 * math.log(2 * math.pi)).sum(-1)


class Prior(Distribution, UnivariatePotential):
    """x_0 ~ N(0, I); also its own potential."""

    def sample_from_noise(self, eps):
        return eps

    def __call__(self, x):
        return _lp(x, 0.0, 1.0)


@dataclass(frozen=True)
class AR(Dynamics):
    """x_{t+1} ~ N(PHI x_t, SIG_X^2 I)."""

    def sample_from_noise(self, eps, x_t, params):
        return PHI * x_t + SIG_X * eps

    def logpdf(self, x_next, x_t, params):
        return _lp(x_next, PHI * x_t, SIG_X)


@dataclass(frozen=True)
class ARObs(Potential):
    """The AR transition times a Gaussian observation y_t (params (T-1, d))
    of x_{t+1}, pair-factorising."""
    supports_pairwise_factors = True

    def __call__(self, x_next, x_t, y):
        y = y.unsqueeze(-2) if x_next.dim() > y.dim() else y
        return _lp(x_next, PHI * x_t, SIG_X) + _lp(y, x_next, SIG_Y)

    def pairwise_factors(self, x_left, x_right, y):
        rf, cf, rb, cb = diag_gaussian_pair_factors(PHI * x_left, x_right, SIG_X)
        y = y.unsqueeze(-2) if x_right.dim() > y.dim() else y
        return rf, cf, rb, cb + _lp(y, x_right, SIG_Y)


@dataclass(frozen=True)
class ObsOnly(Potential):
    """A Gaussian observation y_t of x_{t+1}: with the AR proposal, the
    bootstrap filter's weight."""

    def __call__(self, x_next, x_t, y):
        y = y.unsqueeze(-2) if x_next.dim() > y.dim() else y
        return _lp(y, x_next, SIG_Y)


def _nrel(got, want):
    return float(max((g - w).norm() / w.norm().clamp_min(1e-300) for g, w in zip(got, want)))


def _equal(a, b):
    return bool(torch.equal(a.x.cpu(), b.x.cpu()) and torch.equal(a.updated.cpu(),
                                                                 b.updated.cpu()))


def dryrun_chains(devices, dtype, seed):
    """Two SV kalman-1 iterations (burn-in with delta adaptation, then
    sampling, with statistics) of 2 S chains on a `chains` mesh."""
    from ..models import stochastic_volatility as sv
    from ..parallel.chains import aggregate_chain_stats, broadcast_chains, run_sharded_chains
    from ..parallel.mesh import CHAINS, make_mesh
    from .runner import RunConfig
    mesh = make_mesh(devices=devices, axis_names=(CHAINS,))
    dev = torch.device(devices[0])
    C = 2 * mesh.shape[CHAINS]
    xs, ys = sv.get_data(0.0, 0.9, 2.0, 0.25, 2, 16, generator=torch.Generator().manual_seed(seed),
                         dtype=dtype, device=dev)
    init, kernel = sv.get_kalman_kernel(ys, 0.0, 0.9, 2.0, 0.25, True, 1, chains=True)
    res = run_sharded_chains(
        kernel, init(broadcast_chains(xs, C)), RunConfig(n_samples=1, burnin=1, delta_init=0.05),
        generator=torch.Generator(device=dev).manual_seed(seed), mesh=mesh,
        kernel_for=lambda shard, d: sv.get_kalman_kernel(ys.to(d), 0.0, 0.9, 2.0, 0.25, True,
                                                         1, chains=True)[1])
    stats = aggregate_chain_stats(res.stats, mesh)
    return bool(torch.isfinite(res.state.x).all() and torch.isfinite(stats.mean_x).all()
                and res.delta.shape == (C,))


def dryrun_csmc(devices, dtype, seed):
    """One particle-sharded cSMC step, ancestor scanning and backward
    sampling, against the one-device generic loop."""
    from ..kernels import csmc, csmc_sharded
    from ..parallel.mesh import PARTICLES, make_mesh
    mesh = make_mesh(devices=devices, axis_names=(PARTICLES,))
    dev = torch.device(devices[0])
    T, N, d = 8, 4 * mesh.shape[PARTICLES], 2
    g = torch.Generator().manual_seed(seed)
    ys = torch.randn(T - 1, d, generator=g, dtype=dtype).to(dev)
    x = torch.randn(T, d, generator=g, dtype=dtype).to(dev)
    out = {}
    for backward in (False, True):
        parts = (Prior(), Prior(), AR(), ObsOnly(params=ys))
        one = csmc.get_kernel(*parts, N, backward=backward)
        shard = csmc_sharded.get_sharded_kernel(*parts, N, mesh, backward=backward)
        noise = csmc.draw_noise(x, N, csmc.resampling_mod.multinomial,
                                torch.Generator(device=dev).manual_seed(seed + backward))
        out["backward" if backward else "scanning"] = _equal(
            one[1](one[0](x), noise=noise), shard[1](shard[0](x), noise=noise))
    return out


def dryrun_time_scan(devices, dtype, seed):
    """The time-sharded filtering and sampling scans of a small LGSSM's
    elements against the one-device scans: norm-relative errors."""
    from ..ops.cuda.filter_scan import affine_scan, filter_scan
    from ..parallel.mesh import make_mesh
    from ..parallel.time_scan import TIME, sharded_filtering_scan, sharded_sampling_scan
    mesh = make_mesh(devices=devices, axis_names=(TIME,))
    elems, (gains, incs) = scan_inputs(8 * mesh.shape[TIME] + 1, 3, dtype, devices[0], seed)
    return {"filter": _nrel(sharded_filtering_scan(mesh, elems), filter_scan(elems)),
            "affine": _nrel(sharded_sampling_scan(mesh, (gains, incs)),
                            affine_scan(gains, incs, reverse=True))}


def scan_inputs(n, d, dtype, device, seed):
    """Filtering elements of n steps of a random stable LGSSM (d states, d
    observations) and random affine maps (n, d, d), (n, d)."""
    from ..ops.filtering import _make_associative_elements, kalman_update
    g = torch.Generator().manual_seed(seed)
    kw = dict(generator=g, dtype=torch.float64)
    A = torch.randn(d, d, **kw)
    F = 0.9 * A / torch.linalg.matrix_norm(A, 2)
    L = 0.3 * torch.randn(d, d, **kw)
    Q = L @ L.mT + 0.1 * torch.eye(d, dtype=torch.float64)
    R = 0.2 * torch.eye(d, dtype=torch.float64)
    ys = torch.randn(n + 1, d, **kw)
    m0, P0, _ = kalman_update(ys[0], torch.zeros(d, dtype=torch.float64),
                              torch.eye(d, dtype=torch.float64), torch.eye(d, dtype=torch.float64),
                              torch.zeros(d, dtype=torch.float64), R)
    rep = lambda z: z.expand((n,) + z.shape).contiguous()  # noqa: E731
    elems = _make_associative_elements(rep(F), rep(Q), torch.zeros(n, d, dtype=torch.float64),
                                       rep(torch.eye(d, dtype=torch.float64)), rep(R),
                                       torch.zeros(n, d, dtype=torch.float64), ys[1:], m0, P0)
    gains = 0.5 * torch.randn(n, d, d, **kw) / math.sqrt(d)
    incs = torch.randn(n, d, **kw)
    cast = lambda z: z.to(dtype=dtype, device=device)  # noqa: E731
    return tuple(map(cast, elems)), (cast(gains), cast(incs))


def pit_model(T, d, dtype, device, seed):
    """(Mt, G0, Gt) of a PIT step: independent N(loc_t, 0.7^2) proposals,
    the AR-observation weight."""
    from ..kernels.csmc_independent import DiagonalGaussian
    g = torch.Generator().manual_seed(seed)
    kw = dict(dtype=dtype, device=device)
    Mt = DiagonalGaussian(loc=torch.randn(T, d, generator=g, dtype=dtype).to(device),
                          scale=torch.full((T,), 0.7, **kw))
    return Mt, Prior(), ARObs(params=(0.5 * torch.randn(T - 1, d, generator=g,
                                                          dtype=dtype)).to(device))


def pit_noise(T, N, x, seed):
    from ..kernels import pit
    g = torch.Generator(device=x.device).manual_seed(seed)
    return (torch.randn(T, N, x.shape[1], generator=g, dtype=x.dtype, device=x.device),
            ) + pit.draw_noise(T, N, x, g)


def dryrun_pit(devices, dtype, seed):
    """One time-sharded PIT step (T = 4 S, N = 16) and one particle-sharded
    step (N = 128 S, T = 8, both draws) against the one-device kernel.
    Returns the checks and the particle-sharded joint step's (x, picked)."""
    from ..kernels import pit, pit_sharded
    from ..parallel.mesh import PARTICLES, make_mesh
    from ..parallel.time_scan import TIME
    dev = torch.device(devices[0])
    tmesh = make_mesh(devices=devices, axis_names=(TIME,))
    pmesh = make_mesh(devices=devices, axis_names=(PARTICLES,))
    S = tmesh.shape[TIME]
    out = {}
    T, N = 4 * S, 16
    Mt, G0, Gt = pit_model(T, 1, dtype, dev, seed)
    x = torch.zeros(T, 1, dtype=dtype, device=dev)
    noise = pit_noise(T, N, x, seed)
    one = pit.get_kernel(Mt, G0, Gt, N)
    shard = pit_sharded.get_sharded_kernel(Mt, G0, Gt, N, tmesh)
    out["time_sharded"] = _equal(one[1](one[0](x), noise=noise),
                                 shard[1](shard[0](x), noise=noise))
    T, N = 8, 128 * S
    Mt, G0, Gt = pit_model(T, 1, dtype, dev, seed)
    x = torch.zeros(T, 1, dtype=dtype, device=dev)
    noise = pit_noise(T, N, x, seed)
    for draws in ("joint", "fused"):
        one = pit.get_kernel(Mt, G0, Gt, N, stitch="blocked", draws=draws, block_max="block")
        shard = pit_sharded.get_particle_sharded_kernel(Mt, G0, Gt, N, pmesh, draws=draws)
        got = shard[1](shard[0](x), noise=noise)
        out[f"particle_sharded_{draws}"] = _equal(one[1](one[0](x), noise=noise), got)
        if draws == "joint":
            out["particle_step"] = {"x": got.x.cpu().flatten().tolist(),
                                    "updated": got.updated.cpu().tolist()}
    return out


def dryrun_batch(devices, dtype, seed):
    """One batch-sharded spatial kalman-1 step (B = S^2 components, T = 16)
    against the unsharded step on the same noise: the largest difference of
    the states and whether the accepts agree."""
    import numpy as np
    from ..models import spatial as sp
    from ..native.precision import precision_stencil
    from ..parallel.batch import batch_sharded_kernel
    from ..parallel.mesh import BATCH, make_mesh
    mesh = make_mesh(devices=devices, axis_names=(BATCH,))
    dev = torch.device(devices[0])
    D, T = max(2, mesh.shape[BATCH]), 16
    _, ys = sp.get_data(np.random.default_rng(seed), 0.3, 1.0, -0.25, 4.0, D, T, device="cpu")
    ys = ys.to(dtype=dtype, device=dev)
    stencil = torch.as_tensor(precision_stencil(-0.25, 1.0), dtype=dtype, device=dev)
    x0 = sp.init_x_fn(ys, 0.3, 4.0, stencil, D, 32,
                      generator=torch.Generator(device=dev).manual_seed(seed))
    init, kernel = sp.get_kalman_kernel(ys, 0.3, 4.0, -0.25, 1.0, D, True, order=1)
    sharded = batch_sharded_kernel(kernel, mesh)
    g = torch.Generator(device=dev).manual_seed(seed)
    state = init(x0)
    noise = (torch.randn(state.x.shape, generator=g, dtype=dtype, device=dev),
             torch.randn(state.x.shape, generator=g, dtype=dtype, device=dev),
             torch.rand((), generator=g, dtype=dtype, device=dev))
    a, b = kernel(state, 0.05, noise=noise), sharded(state, 0.05, noise=noise)
    return {"max_abs": float((a.x - b.x).abs().max()),
            "same_accept": bool(torch.equal(a.updated.cpu(), b.updated.cpu()))}


def dryrun_multichip(devices, dtype=torch.float64, seed=0):
    """One step of each sharded path over `devices` (this process's shards;
    after `distributed.initialize` every process's): the chains train step
    with statistics and adaptation, the sharded cSMC (ancestor scanning and
    backward sampling), the time scans, the time- and particle-sharded PIT,
    and the batch-sharded spatial step. Returns their checks."""
    devices = [str(torch.device(d)) for d in devices]
    return {"chains": dryrun_chains(devices, dtype, seed),
            "csmc": dryrun_csmc(devices, dtype, seed),
            "time_scan": dryrun_time_scan(devices, dtype, seed),
            "pit": dryrun_pit(devices, dtype, seed),
            "batch": dryrun_batch(devices, dtype, seed)}


def _worker(argv):
    """A process of `run_processes`: join the group, run the dry run on its
    shards, write its result."""
    p = argparse.ArgumentParser()
    p.add_argument("--rendezvous")
    p.add_argument("--rank", type=int)
    p.add_argument("--processes", type=int)
    p.add_argument("--devices", nargs="+")
    p.add_argument("--out")
    p.add_argument("--dtype", default="float64")
    a = p.parse_args(argv)
    import time
    import torch.distributed as dist
    from ..parallel import distributed
    tic = time.perf_counter()
    info = distributed.initialize(a.rendezvous, a.processes, a.rank, local_devices=a.devices)
    init_s = time.perf_counter() - tic
    first_s = None
    dev = torch.device(a.devices[0])
    if dev.type == "cuda":  # the first collective on the card sets up NCCL's communicator
        tic = time.perf_counter()
        one = torch.ones(1, device=dev)
        dist.all_reduce(one)
        torch.cuda.synchronize(dev)
        first_s = time.perf_counter() - tic
        if float(one) != a.processes:
            raise RuntimeError(f"all_reduce over {a.processes} processes gave {float(one)}")
    try:
        result = dryrun_multichip(a.devices, getattr(torch, a.dtype))
    finally:
        distributed.shutdown()
    with open(a.out, "w") as f:
        json.dump({"info": info, "init_s": init_s, "first_collective_s": first_s,
                   "result": result}, f)


def run_processes(n_processes, devices_of, out_dir, timeout_s=300.0, dtype="float64"):
    """Run `dryrun_multichip` in `n_processes` processes joined by a
    `file://` rendezvous in `out_dir`; process r's shards are
    `devices_of(r)`. Each process has its own timeout; one that fails or
    times out raises RuntimeError (the others are killed). Returns each
    process's result, rank order."""
    os.makedirs(out_dir, exist_ok=True)
    rendezvous = "file://" + os.path.abspath(os.path.join(out_dir, "rendezvous"))
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs, outs = [], []
    for r in range(n_processes):
        outs.append(os.path.join(out_dir, f"rank{r}.json"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "aux_ssm_tpu_torch.experiments.multichip", "--worker",
             "--rendezvous", rendezvous, "--rank", str(r), "--processes", str(n_processes),
             "--devices", *map(str, devices_of(r)), "--out", outs[-1], "--dtype", dtype],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results, failed = [], []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r}: no end within {timeout_s} s")
                continue
            if p.returncode:
                failed.append(f"rank {r}: exit {p.returncode}: {err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        raise RuntimeError("multi-process dry run failed: " + "; ".join(failed))
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        return _worker(argv[1:])
    p = argparse.ArgumentParser("dryrun_multichip")
    p.add_argument("--devices", nargs="+", default=None,
                   help="this process's shards (default: every card)")
    p.add_argument("--processes", type=int, default=1)
    p.add_argument("--shards", type=int, default=2, help="shards a process (--processes > 1)")
    p.add_argument("--platform", default=None, help="None or gpu: the cards; cpu")
    p.add_argument("--out", default=None, help="the processes' rendezvous and results")
    a = p.parse_args(argv)
    if a.processes > 1:
        cpu = a.platform == "cpu"
        with tempfile.TemporaryDirectory() as tmp:
            results = run_processes(
                a.processes, lambda r: ["cpu" if cpu else
                                        f"cuda:{r % max(torch.cuda.device_count(), 1)}"]
                * a.shards, a.out or tmp)
        print(json.dumps([r["result"] for r in results]))
        return results
    devices = a.devices or [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    result = dryrun_multichip(devices)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
