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
SOURCES = ("kalman_fused.cu", "scan.cu")
HEADERS = ("smallmat.cuh",)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "aux_ssm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_DIM = 16  # kMaxD of csrc/*.cu: the largest dx, dy the kernels are built for

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class _Library:
    """The loaded kernel library, built on first use."""

    def __init__(self):
        self._lib = None
        self.build_seconds = None
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
            objs, procs = [], []
            for name in SOURCES:
                obj = Path(tmp) / (name + ".o")
                objs.append(str(obj))
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            logs = [p.communicate()[0] for p in procs]
            (out_dir / "ptxas.log").write_text("\n".join(logs))
            for name, p, log in zip(SOURCES, procs, logs):
                if p.returncode != 0:
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
    Tensors are passed as device pointers, Python ints as C ints, bools as
    0/1; raises RuntimeError on a non-zero CUDA error code."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: the CUDA kernels take float32 or float64, not {dtype}")
    lib = LIBRARY.get()
    fn = getattr(lib, f"aux_{name}_{_SUFFIX[dtype]}")
    c_args, types = [], []
    for a in args:
        if isinstance(a, torch.Tensor):
            c_args.append(ctypes.c_void_p(a.data_ptr()))
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
