"""One run of one cell: set-up, the measured window through the program's
own sampling loop, the traced steps, and the check that decides `correct`.

The window runs the batched step of all C chains through
`parallel.chains.run_sharded_chains` (-> `experiments.runner.run_chain`),
as `experiments.cli.run_maybe_sharded` calls it for `--n-chains C`: delta
frozen at the cell's value (learning rate 0), the cell's 64 interior
coordinates collected through `collect_fn`. The kernel the loop is handed
is `Stepper`, the benchmark's own wrapper of the program's kernel, which
counts steps, draws the noise of the checked steps and, in a traced run,
records a CUDA event after each step and the host's time in each call.

The window's length in steps is set at the end of set-up from the period of
the last set-up steps, so that it lasts `--seconds`; its ends are fenced
on the host clock, and every rate is taken over all of its steps and all
of its time. Which steps are checked is drawn from the seed.
"""
import time

import numpy as np
import torch

from portbench.manifest import Manifest


class Stepper:
    """The program's batched kernel, counted; `check_at` (1-based call
    numbers) steps take the style's noise and are kept with the sweeps'
    recorded outputs; with `trace`, a CUDA event after each step and the
    host's seconds in each call."""

    def __init__(self, kernel, style, traffic, check_gen, trace):
        self.kernel, self.style, self.traffic = kernel, style, traffic
        self.check_gen, self.trace = check_gen, trace
        self.calls, self.check_at, self.checks = 0, set(), []
        self.events, self.host_s = [], []

    def __call__(self, state, delta, generator=None):
        self.calls += 1
        tic = time.perf_counter() if self.trace else None
        if self.calls in self.check_at:
            noise = self.style.noise(state, self.traffic, self.check_gen)
            with self.style.recording() as record:
                out = self.kernel(state, delta, generator=generator, noise=noise)
            self.checks.append((state.x, delta, noise, self.style.outputs(out, record)))
        else:
            out = self.kernel(state, delta, generator=generator)
        if self.trace:
            self.host_s.append(time.perf_counter() - tic)
            if out.x.is_cuda:
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                self.events.append(event)
        return out

    def reset(self, check_at=()):
        self.calls, self.check_at, self.checks = 0, set(check_at), []
        self.events, self.host_s = [], []


def _fence(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches():
    from aux_ssm_tpu_torch.ops.cuda import launches
    return sum(launches().values())


class Cell:
    """A cell built for a run: its configuration, traffic, family and
    style, the benchmark's data (`ys64`, float64 on the CPU; `ys` on the
    device), the program's batched kernel, the C chains' start and the
    frozen delta, and the seeds drawn from the run's seed.

    The start is the driver's for the configuration's data set (`init_x_fn`
    seeded with `data_seed` + 1, as the drivers seed it from `--seed`), the
    same for every run: the chains share it, and a start drawn from the run's
    seed moved the window's ESS by seed (pooled ESS a second of 128 spatial
    chains over 20 s: quartiles 8.9% of the median apart over six seeds,
    1.4% from one start; NVIDIA H100 80GB HBM3, 700 W). The run's seed
    draws the chains' noise, the checked steps' noise and which steps are
    checked."""

    def __init__(self, manifest, workload, seed, device, fault=None):
        w = manifest.workload(workload)
        self.cfg, self.traffic = manifest.config(w["config"]), manifest.traffic(w["traffic"])
        self.family = manifest.module("families", self.cfg["family"])
        self.style = manifest.module("styles", self.traffic["style"])
        self.device = torch.device(device)
        self.dtype = getattr(torch, self.cfg["dtype"])
        seeds = np.random.SeedSequence(seed).generate_state(4, np.uint32)
        _, chain_seed, check_seed, self.pick_seed = (int(s) for s in seeds)
        from aux_ssm_tpu_torch.parallel.chains import broadcast_chains
        _, self.ys64 = self.family.simulate(self.cfg)
        ys = self.ys64.to(dtype=self.dtype, device=self.device)
        init, kernel = self.family.build(self.cfg, self.traffic, ys)
        self.kernel = kernel if fault is None else fault(kernel)
        self.C = C = self.traffic["chains"]
        start = self.family.start(self.cfg, self.traffic, ys, self.cfg["data_seed"] + 1)
        self.state = broadcast_chains(init(start), C)
        delta = torch.as_tensor(self.traffic["delta"], dtype=self.dtype, device=self.device)
        self.delta = delta.expand((C,) + tuple(delta.shape)).clone()
        self.gen = torch.Generator(device=self.device).manual_seed(chain_seed)
        self.check_gen = torch.Generator(device=self.device).manual_seed(check_seed)


def run_cell(workload, seed, seconds, trace, manifest=None, device="cuda", started=None,
             fault=None, controls=False, log=print):
    """One run of `workload`; returns (result, check lines). `fault`
    (tests): wraps the program's kernel, to break the timed path under the
    check. `controls`: the result also gets `control`, the numbers of the
    reference in the precision below the configuration's in the program's
    place on the same checked steps. `started`: the process's start on the
    host clock."""
    from aux_ssm_tpu_torch.experiments.runner import RunConfig
    from aux_ssm_tpu_torch.parallel.chains import run_sharded_chains
    started = time.perf_counter() if started is None else started
    manifest = manifest or Manifest()
    marks = [("imports", time.perf_counter())]
    cell = Cell(manifest, workload, seed, device, fault)
    marks.append(("data, build, start", time.perf_counter()))
    cfg, traffic, family, style = cell.cfg, cell.traffic, cell.family, cell.style
    device, C, state, delta, gen = cell.device, cell.C, cell.state, cell.delta, cell.gen
    stepper = Stepper(cell.kernel, style, traffic, cell.check_gen, trace)
    coords = torch.as_tensor(traffic["coords"], device=device)

    def collect(s):
        return s.x[:, coords[:, 0], coords[:, 1]]

    def loop(n, st, collect_samples=True):
        run = RunConfig(n_samples=n, burnin=1, learning_rate=0.0, verbose=False)
        return run_sharded_chains(stepper, st, run, generator=gen, collect_samples=collect_samples,
                                  collect_fn=collect, delta_init=delta)

    # Set-up: where the traffic asks for it, the drivers' burn-in (each
    # chain's delta adapted from `burnin_delta` toward update rate 0.5), which
    # brings the chains from the start into the posterior; then warm-up steps
    # at the frozen delta, a checked step among them, and the steps whose
    # period sets the window's length.
    if traffic["burnin"]:
        run = RunConfig(n_samples=1, burnin=traffic["burnin"], learning_rate=traffic["burnin_lr"],
                        target_alpha=0.5, verbose=False)
        state = run_sharded_chains(stepper, state, run, generator=gen,
                                   delta_init=torch.full_like(delta, traffic["burnin_delta"])).state
        marks.append(("burn-in", time.perf_counter()))
    stepper.reset(check_at=(2,))
    state = loop(traffic["warmup"], state).state
    marks.append(("warm-up", time.perf_counter()))
    stepper.reset()
    _fence(device)
    tic = time.perf_counter()
    state = loop(traffic["calibrate"], state).state
    _fence(device)
    period = (time.perf_counter() - tic) / stepper.calls
    n_window = max(traffic["check_steps"] + 2, int(round(seconds / period)) - 1)
    picks = np.random.default_rng(cell.pick_seed).choice(
        np.arange(2, n_window + 2), traffic["check_steps"], replace=False)
    stepper.reset(check_at=picks.tolist())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = _launches()
    setup_s = time.perf_counter() - started
    marks.append(("calibration", time.perf_counter()))

    _fence(device)
    tic = time.perf_counter()
    res = loop(n_window, state)
    _fence(device)
    window_s = time.perf_counter() - tic
    steps, window_launches = stepper.calls, _launches() - launches0
    events, host_s = stepper.events, stepper.host_s
    checks = stepper.checks
    log(f"window: {steps} steps of {C} chains in {window_s:.4f} s (set-up {setup_s:.4f} s, "
        f"period at set-up {1e3 * period:.4f} ms); update rate "
        f"{float(res.stats.accept_cum.double().mean()):.4f}; card: {card_state()}")
    log("set-up: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b) in
                               zip([("start", started)] + marks[:-1], marks)))

    traced = None
    if trace:
        from portbench.devtrace import profile
        stepper.trace = False
        after = res.state

        def traced_steps():
            stepper.reset()
            loop(traffic["profile_steps"], after, collect_samples=True)
            _fence(device)
        traced = profile(traced_steps)
        if traced is not None:
            traced["steps"] = stepper.calls
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if traced is not None:
        _log_kernels(traced, log)

    ctx = {"cfg": cfg, "traffic": traffic, "chains": C, "steps": steps, "window_s": window_s,
           "setup_s": setup_s, "stats": res.stats, "samples": res.samples,
           "launches": window_launches, "events": events, "host_s": host_s, "trace": traced}
    del res, state, stepper, cell.state
    steps_checked = _check(family, style, cfg, cell.ys64, checks, device)
    numbers = _largest(steps_checked, style.NUMBERS)
    control = (_largest(_check(family, style, cfg, cell.ys64, checks, device, True),
                        style.NUMBERS) if controls else None)
    del checks
    # A limit of null: the number is read and logged, not compared (no
    # reading of the control separates it from the program's).
    limits = {k: v for k, v in traffic["limits"].items() if v is not None}
    failed = sum(1 for s in steps_checked if any(not s[k] <= limits[k] for k in limits))
    if not steps_checked:
        failed = 1
    metrics = {}
    for m in manifest.metrics(workload, trace):
        value = manifest.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = _device_info(device, memory_peak)
    result = {"correct": failed == 0, "attempted": len(steps_checked), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and traced is not None:
        from portbench.devtrace import summarise
        summary = summarise(traced)
        device_info.update(busy_s=summary["busy_s"], window_s=traced["wall_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    if control is not None:
        result["control"] = control
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    lines = [f"not compared {k}: {numbers[k]!r}" for k in numbers if k not in limits]
    lines += [f"check {k}: {numbers[k]!r} (limit {limits[k]!r})" for k in limits]
    return result, lines


def _check(family, style, cfg, ys64, checks, device, control=False):
    """Each checked step's compared numbers, from the reference in float64
    on the run's device. With `control`, of the control's outputs instead
    of the program's: the reference in float32 with its products in TF32
    (the configurations state float32 with TF32 off), in the program's
    place on the same steps (`reference.gauss.tf32_matmul`)."""
    model = family.model(cfg, ys64, torch.float64, device)
    if control:
        low = family.model(cfg, ys64, torch.float32, device, tf32=True)
        checks = [(x, d, nz, style.control(low, x, d, nz)) for x, d, nz, _ in checks]
    return [{k: v if v == v else float("inf")
             for k, v in style.judge(model, x, delta, noise, out).items()}
            for x, delta, noise, out in checks]


def _largest(steps, names):
    """Each number's largest reading over the checked steps (inf where no
    step was checked)."""
    return {k: max((s[k] for s in steps), default=float("inf")) for k in names}


def _log_kernels(traced, log):
    """Each device operation's ms a traced step, marked L (a library's or
    PyTorch's) or H (hand-written)."""
    from portbench.kernels import is_library
    total = {}
    for name, s, e in traced["kernels"]:
        total[name] = total.get(name, 0.0) + (e - s) * 1e-3 / traced["steps"]
    for name, ms in sorted(total.items(), key=lambda kv: -kv[1]):
        log(f"  {'L' if is_library(name) else 'H'} {ms:.4f} ms a step  {name[:150]}")


def card_state():
    """nvidia-smi's name, clocks, power and power limit of the card, one
    line; None where it is not there."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
                              "power.draw,power.limit,temperature.gpu",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def _device_info(device, memory_peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": memory_peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": memory_peak}
