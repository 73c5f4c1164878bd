"""Several chains, shards and processes (counterpart of `aux_ssm_tpu/parallel/`).

Mesh axes and their roles:

  chains    -- independent MCMC chains (`chains.py`): each shard runs its
               chains, delta adaptation stays per chain, statistics reduce
               by psum;
  particles -- a cSMC particle population split inside one chain
               (`resampling.py`, `kernels/csmc_sharded.py`, the block masses
               of `kernels/pit_sharded.py`);
  time      -- the time axis of associative scans and of the PIT tree
               (`time_scan.py`, `kernels/pit_sharded.py`);
  batch     -- the independent components of a batched LGSSM (`batch.py`).

A mesh (`mesh.py`) is an array of `torch.device`s, repeats allowed (shards
on one card, or "cpu" shards); `collectives.py` stands for `shard_map`'s
collectives; `distributed.py` joins processes through `torch.distributed`.
"""
from .batch import batch_sharded_kernel, shard_batched_lgssm, shard_time_major
from .chains import (aggregate_chain_stats, broadcast_chains, chain_loop, run_sharded_chains,
                     shard_chains)
from .mesh import local_mesh, make_mesh

__all__ = ["aggregate_chain_stats", "batch_sharded_kernel", "broadcast_chains", "chain_loop",
           "local_mesh", "make_mesh", "run_sharded_chains", "shard_batched_lgssm",
           "shard_chains", "shard_time_major"]
