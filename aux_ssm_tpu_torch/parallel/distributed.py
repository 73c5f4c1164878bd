"""Several processes, one mesh (counterpart of
`aux_ssm_tpu/parallel/distributed.py`).

Call `initialize` once in every process before building a mesh; a mesh built
afterwards (`parallel.mesh.make_mesh`) spans every process's shards, and the
collectives of `parallel/collectives.py` reach the other processes through
`torch.distributed`. The process group is `cpu:gloo,cuda:nccl`: a
collective on CUDA tensors runs over NCCL, one on CPU tensors over gloo,
chosen by the tensors' device (a PyTorch built without NCCL, which has no
CUDA tensors either, gets gloo alone). Without `initialize` there is one process
and every shard is its own.

    # torchrun --nproc-per-node 4 script.py, each process:
    info = distributed.initialize()            # reads the launcher's env://
    mesh = make_mesh(axis_names=(PARTICLES,))  # one shard a card, 4 in all
"""
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

_STATE = {"local_devices": None}


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, local_devices=None, timeout_s: float = 300.0):
    """Join the process group. With no address, count and id, the launcher's
    environment gives them (`env://`: MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK), the counterpart of a TPU pod's discovery. `coordinator_address`
    is `host:port` (a tcp:// rendezvous) or a URL such as `file:///path`.
    `local_devices`: this process's shards (default: card LOCAL_RANK, else
    the process id modulo the card count). Returns the JAX package's keys:
    process_index, process_count, local_devices, global_devices."""
    if coordinator_address is None and num_processes is None and process_id is None:
        init = dict(init_method="env://")
    else:
        url = coordinator_address
        if url is not None and "://" not in url:
            url = f"tcp://{url}"
        init = dict(init_method=url, world_size=num_processes, rank=process_id)
    backend = "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "cpu:gloo"
    dist.init_process_group(backend=backend,
                            timeout=datetime.timedelta(seconds=timeout_s), **init)
    if local_devices is None:
        if not torch.cuda.device_count():
            raise RuntimeError("distributed.initialize: no card for this process; pass "
                               "local_devices (e.g. ['cpu', 'cpu']) to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        local_devices = [f"cuda:{local % torch.cuda.device_count()}"]
    _STATE["local_devices"] = [torch.device(d) for d in local_devices]
    if _STATE["local_devices"][0].type == "cuda":  # NCCL's collectives run on the current card
        torch.cuda.set_device(_STATE["local_devices"][0])
    every, _ = gather_devices(_STATE["local_devices"])
    return {"process_index": dist.get_rank(), "process_count": dist.get_world_size(),
            "local_devices": len(_STATE["local_devices"]), "global_devices": len(every)}


def is_multihost():
    """More than one process in the group."""
    return process_count() > 1


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def process_index():
    return dist.get_rank() if is_initialized() else 0


def process_count():
    return dist.get_world_size() if is_initialized() else 1


def default_local_devices():
    """This process's shards: those given to `initialize`, else every card
    (ValueError where there is none; never the CPU)."""
    if is_initialized() and _STATE["local_devices"] is not None:
        return list(_STATE["local_devices"])
    n = torch.cuda.device_count()
    if not n:
        raise ValueError("make_mesh: torch.cuda.device_count() is 0; name the devices "
                         "(e.g. devices=['cpu'] * 8) to build a mesh without a card")
    return [torch.device("cuda", i) for i in range(n)]


def gather_devices(devices):
    """(every process's devices in rank order, the rank of each). Each
    process must hold as many shards as the others."""
    if not is_initialized():
        return list(devices), [0] * len(devices)
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, [str(d) for d in devices])
    if len({len(z) for z in lists}) != 1:
        raise ValueError(f"every process must hold as many shards: {[len(z) for z in lists]}")
    every = [torch.device(d) for z in lists for d in z]
    ranks = [r for r, z in enumerate(lists) for _ in z]
    return every, ranks


def shutdown():
    """Leave the process group."""
    if is_initialized():
        dist.destroy_process_group()
    _STATE["local_devices"] = None
