"""A few steps under `torch.profiler`: the device's kernels, their union in
time, the idle gaps between them and what the host ran in each.

In a process that has profiled before, a session's trace sometimes lists
none of its kernels, so a session that lists none is run again, up to
`tries` times (the rule of `device_ms` in the repository's `chip_smoke.py`);
None where none listed any: the device numbers are then not measured.
"""
import bisect
import time
from collections import defaultdict



def profile(run, tries=3):
    """Profile `run()` (which ends with the device's work fenced): the
    window's wall seconds, the kernels [(name, start_us, end_us)], the host
    ops [(name, start_us, end_us)]; None where no kernel was listed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    for _ in range(tries):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tic = time.perf_counter()
            run()
            wall = time.perf_counter() - tic
        kernels, host = [], []
        for e in prof.events():
            span = (e.name, e.time_range.start, e.time_range.end)
            (kernels if e.device_type == DeviceType.CUDA else host).append(span)
        if kernels:
            return {"wall_s": wall, "kernels": kernels, "host": host}
    return None


def summarise(trace, top=10):
    """busy_s (the union of the kernels' intervals), the longest idle gaps
    between them by the innermost host op running at each gap's middle,
    and the kernels that took most device time."""
    spans = sorted((s, e) for _, s, e in trace["kernels"])
    busy, gaps = 0.0, []
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_kernel = defaultdict(float)
    for name, s, e in trace["kernels"]:
        by_kernel[name] += (e - s) * 1e-6
    host = sorted(trace["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_host = defaultdict(float)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:400]:
        by_host[_innermost(host, starts, 0.5 * (s + e))] += (e - s) * 1e-6
    return {"busy_s": busy * 1e-6, "device_ops": _largest(by_kernel, top),
            "idle_gaps": _largest(by_host, top)}


def _largest(totals, top):
    return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:top]


def _innermost(host, starts, t, reach=4000):
    """The latest-starting host op that spans time t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        if host[j][2] >= t:
            return host[j][0]
    return "(no host op)"
