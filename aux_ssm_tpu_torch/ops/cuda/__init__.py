"""Hand-written CUDA kernels of the auxiliary-Kalman MH step (counterpart of
`aux_ssm_tpu/ops/pallas/`). Sources are in `csrc/`, built by `_build.py` at
first use. Every wrapper runs its plain PyTorch version for CPU tensors and
launches its kernel (or raises) for CUDA tensors, and counts its launches."""
from . import filter_scan, kalman_fused

WRAPPERS = (kalman_fused.make_elements, filter_scan.filter_scan, kalman_fused.ell,
            kalman_fused.backward_maps, filter_scan.affine_scan, kalman_fused.logdensity_steps)


def reset_launches():
    """Set every wrapper's launch count to 0."""
    for w in WRAPPERS:
        w.launches = 0


def launches():
    """The launch count of every wrapper, by name."""
    return {w.__name__: w.launches for w in WRAPPERS}
