"""Several MCMC chains on one card (counterpart of `aux_ssm_tpu/parallel/`;
its meshes, batch sharding, distributed runs and sharded kernels span
several devices and are not ported)."""
from .chains import aggregate_chain_stats, broadcast_chains, chain_loop, run_sharded_chains

__all__ = ["aggregate_chain_stats", "broadcast_chains", "chain_loop", "run_sharded_chains"]
