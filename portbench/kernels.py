"""The card's peaks, which device operations are the hand-written
kernels', and a kernel's share of its roofline.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit: 67 TFLOP/s
in float32 outside the tensor cores, 3.35 TB/s of HBM3.

A kernel's least time is the larger of its operations over the float32
rate and its bytes over the memory rate, counted from the cell's shapes at
the model's own width by `work/<kernel>.py` (each input byte read once,
each output byte written once); its share of the roofline is that least
time over the device time the profiler gives the launches it names.
"""
import functools
import re

from portbench.manifest import CHECKOUT, load_module

F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

SOURCES = CHECKOUT / "aux_ssm_tpu_torch" / "ops" / "cuda" / "csrc"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


@functools.lru_cache(maxsize=1)
def hand_written():
    """The names of the program's hand-written kernels: every `__global__`
    function of its CUDA sources."""
    return frozenset(m.group(1) for path in sorted(SOURCES.glob("*.cu*"))
                     for m in _GLOBAL.finditer(path.read_text()))


def function_name(name):
    """The kernel's function name in a profiler's name of a launch: `void
    (anonymous namespace)::scan_kernel<...>(int, ...)` -> `scan_kernel`."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return re.split(r"[<(]", name, 1)[0].split("::")[-1].strip()


def is_library(name):
    """Whether a device operation is PyTorch's, a library's (cuBLAS,
    cuSOLVER, MAGMA, CUB) or the runtime's (copies, fills), not one of the
    program's hand-written kernels."""
    return function_name(name) not in hand_written()


def least_seconds(operations, nbytes):
    return max(operations / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def roofline(ctx, kernel):
    """% of the roofline of `kernel` over the traced steps; None where the
    trace lists none of its launches."""
    tr = ctx["trace"]
    if tr is None:
        return None
    work = load_module("work", kernel)
    seconds = 1e-6 * sum(e - s for name, s, e in tr["kernels"]
                         if any(n in name for n in work.NAMES))
    if seconds <= 0:
        return None
    operations, nbytes = work.per_step(ctx["cfg"], ctx["traffic"])
    return 100.0 * least_seconds(operations, nbytes) * tr["steps"] / seconds
