"""Hand-written CUDA kernels of the auxiliary-Kalman MH step (dense d x d and
batched scalar layouts), the cSMC sweeps and the parallel-in-time stitching
(counterpart of `aux_ssm_tpu/ops/pallas/`). Sources are in `csrc/`, built by
`_build.py` at first use. Every wrapper runs its plain PyTorch version for CPU tensors and
launches its kernel (or raises) for CUDA tensors, and counts its launches."""
from . import csmc_fwd, filter_scan, kalman_fused, scalar_scan, stitching

WRAPPERS = (kalman_fused.make_elements, filter_scan.filter_scan, kalman_fused.ell,
            kalman_fused.backward_maps, filter_scan.affine_scan, kalman_fused.logdensity_steps,
            csmc_fwd.forward_factor_scan, csmc_fwd.backward_factor_scan,
            csmc_fwd.lane_scan, csmc_fwd.block_lane_scan,
            scalar_scan.scalar_filter_scan, scalar_scan.scalar_affine_scan,
            stitching.row_lse, stitching.col_sample, stitching.block_masses,
            stitching.stitch_draws, stitching.within_block_cols)


def reset_launches():
    """Set every wrapper's launch count to 0."""
    for w in WRAPPERS:
        w.launches = 0


def launches():
    """The launch count of every wrapper, by name."""
    return {w.__name__: w.launches for w in WRAPPERS}
