"""Build and load the hand-written CUDA kernels of `csrc/`.

The sources are compiled with `nvcc` for Hopper (`sm_90a`) into one shared
library with a plain C interface, loaded with `ctypes`. No PyTorch header is
included, so a build takes seconds. The library is built at first use into
`build/aux_ssm_tpu_torch/<hash of the sources>/` at the root of the checkout,
so an edited source is rebuilt and an unchanged one is reused.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `launch` raises on a non-zero code.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("kalman_fused.cu", "scan.cu", "scalar_scan.cu", "csmc_fwd.cu", "csmc_lane.cu",
           "csmc_block_lane.cu", "stitching.cu")
HEADERS = ("tile.cuh", "lanes.cuh", "csmc_common.cuh", "csmc_models.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "aux_ssm_tpu_torch"
# --split-compile=0 runs the device optimizer on a source's kernels in parallel
# threads: on the card's 8-core host the seven sources built in 56 s with it,
# 85 s without (scan.cu alone 36 s against 94 s), with the same code.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0")

# The compile-time dimensions of the main-path kernels' instances (kalman_fused.cu
# kElemD / kWideD / kWide48D, scan.cu kNarrowD / kWideD / kWide48D): each call
# takes the least that holds its max(dx, dy). MAX_DIMS is the largest dx, dy
# each dtype's instances take: the D = 48 instance is float32 only (the
# float64 filter scan's plan does not fit a block's shared memory there, and
# the JAX package's Pallas kernels stop at d = 30 in float64).
INSTANCE_DIMS = (16, 32, 48)
MAX_DIMS = {torch.float32: 48, torch.float64: 32}


def max_dim(dtype):
    """The largest dimension the d x d kernels take in `dtype` (MAX_DIMS;
    32 for a dtype the kernels do not take, which `launch` refuses)."""
    return MAX_DIMS.get(dtype, MAX_DIMS[torch.float64])


def instance_dim(d, dtype):
    """The compile-time D of the instance that takes dimension d in `dtype`
    (as the C entries choose it); raises past `max_dim(dtype)`."""
    for D in INSTANCE_DIMS:
        if d <= D <= max_dim(dtype):
            return D
    raise ValueError(f"no {dtype} kernel instance for dimension {d} (at most {max_dim(dtype)})")


def has_instance(*dims, dtype):
    """Whether the d x d kernels have an instance for these state and
    observation widths in `dtype`: max(dims) <= max_dim(dtype) (48 in
    float32, 32 in float64). The callers of the d x d wrappers
    (`ops/filtering.py`, `ops/sampling.py`, `ops/lgssm.py`,
    `parallel/time_scan.py`) run the plain versions where it is false, on
    any device, as the JAX package leaves a shape whose Pallas instance does
    not fit to XLA (`aux_ssm_tpu/ops/filtering.py` `use_pallas`); the
    wrappers themselves still launch or raise."""
    return max(dims) <= max_dim(dtype)


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class _Library:
    """The loaded kernel library, built on first use."""

    def __init__(self):
        self._lib = None
        self.build_seconds = None
        self.source_seconds = {}  # seconds of each source's nvcc, where this process built it
        self.build_dir = None

    def _nvcc(self):
        found = shutil.which("nvcc")
        if found:
            return found
        path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if not path.exists():
            raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
        return str(path)

    def _digest(self):
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name in SOURCES + HEADERS:
            h.update(name.encode())
            h.update((CSRC / name).read_bytes())
        return h.hexdigest()[:16]

    def build(self):
        """Compile the sources (unless already built) and return the path of
        the library."""
        out_dir = BUILD_ROOT / self._digest()
        lib_path = out_dir / "libaux_ssm_kernels.so"
        self.build_dir = out_dir
        if lib_path.exists():
            self.build_seconds = 0.0
            return lib_path
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = self._nvcc()
        tic = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            objs, procs = [], {}
            for name in SOURCES:
                obj = Path(tmp) / (name + ".o")
                objs.append(str(obj))
                with open(Path(tmp) / (name + ".log"), "w") as out:
                    procs[name] = subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                        stdout=out, stderr=subprocess.STDOUT)
            while len(self.source_seconds) < len(procs):  # each source's time, as it ends
                for name, p in procs.items():
                    if name not in self.source_seconds and p.poll() is not None:
                        self.source_seconds[name] = time.perf_counter() - tic
                time.sleep(0.05)
            logs = [(Path(tmp) / (name + ".log")).read_text() for name in SOURCES]
            (out_dir / "ptxas.log").write_text("\n".join(logs))
            for name, log in zip(SOURCES, logs):
                if procs[name].returncode != 0:
                    raise RuntimeError(f"nvcc failed on {name}:\n{log}")
            tmp_lib = Path(tmp) / lib_path.name
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib), *objs],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
            os.replace(tmp_lib, lib_path)  # atomic: concurrent builders agree
        self.build_seconds = time.perf_counter() - tic
        return lib_path

    def get(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            lib.aux_error_string.argtypes = [ctypes.c_int]
            lib.aux_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


LIBRARY = _Library()


def launch(name, dtype, *args):
    """Call the C entry `aux_<name>_<f32|f64>` on the current CUDA stream.
    Tensors are passed as device pointers, None as a null pointer, Python
    ints as C ints, bools as 0/1; raises RuntimeError on a non-zero CUDA
    error code."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: the CUDA kernels take float32 or float64, not {dtype}")
    lib = LIBRARY.get()
    fn = getattr(lib, f"aux_{name}_{_SUFFIX[dtype]}")
    c_args, types = [], []
    for a in args:
        if isinstance(a, torch.Tensor) or a is None:
            c_args.append(ctypes.c_void_p(None if a is None else a.data_ptr()))
            types.append(ctypes.c_void_p)
        else:
            c_args.append(ctypes.c_int(int(a)))
            types.append(ctypes.c_int)
    fn.argtypes = types + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    code = fn(*c_args, stream)
    if code != 0:
        msg = lib.aux_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} (code {code})")


def check_cuda_inputs(name, tensors, dtype, max_dim, dims):
    """Validate what the kernels take: tensors on one CUDA device, of one
    float dtype, contiguous; every size in `dims` in [1, max_dim]. Returns the
    tensors (contiguous)."""
    device = tensors[0].device
    out = []
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: all inputs must be on {device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: all inputs must be {dtype}, got {t.dtype}")
        out.append(t.contiguous())
    for d in dims:
        if not 1 <= d <= max_dim:
            raise ValueError(f"{name}: the CUDA kernels are built for dimensions "
                             f"1..{max_dim}, got {d}")
    return out
