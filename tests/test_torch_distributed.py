"""Two processes, one mesh: `aux_ssm_tpu_torch.parallel.distributed` with two
CPU processes of two shards each (gloo), so four global shards, joined by a
`file://` rendezvous under the test's own `tmp_path` (parallel test workers
cannot collide).

- The cross-chain mean of the shards' values 0..3 by `psum` is 1.5 on both
  processes (the JAX package's `tests/test_distributed.py` check), and the
  mesh spans both processes' shards.
- One particle-sharded resample (all-gather, and the streaming variant,
  whose blocks cross between the processes by `ppermute`) equals the
  one-process result bit for bit, on both processes.
- The PIT part of the dry run (`experiments.multichip.dryrun_pit`): the
  time- and particle-sharded steps equal the one-device kernel's in both
  processes, and their particle-sharded step equals the one-process dry
  run's.
Each process has a timeout of its own.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, sys
import torch
sys.path.insert(0, {repo!r})
from aux_ssm_tpu_torch.parallel import collectives as col, distributed
from aux_ssm_tpu_torch.parallel import resampling as pres
from aux_ssm_tpu_torch.parallel.mesh import CHAINS, PARTICLES, make_mesh

rank = int(sys.argv[1])
info = distributed.initialize(sys.argv[2], 2, rank, local_devices=["cpu", "cpu"])
assert info["process_count"] == 2 and info["global_devices"] == 4, info
assert distributed.is_multihost()
mesh = make_mesh(axis_names=(CHAINS,))
assert mesh.shape == {{"chains": 4}} and mesh.local_shards(CHAINS) == [2 * rank, 2 * rank + 1]
values = [torch.tensor([float(s)]) for s in col.axis_index(mesh, CHAINS)]
mean = float(col.psum(mesh, values, CHAINS)[0]) / 4

g = torch.Generator().manual_seed(0)
w = torch.rand(16, generator=g, dtype=torch.float64)
w = w / w.sum()
p = torch.randn(16, 2, generator=g, dtype=torch.float64)
u = torch.rand(16, generator=g, dtype=torch.float64)
pmesh = make_mesh(axis_names=(PARTICLES,))
out = [pres.sharded_conditional_resample(pmesh, w, p, u).tolist(),
       pres.sharded_conditional_resample_streaming(pmesh, w, p, u).tolist()]
from aux_ssm_tpu_torch.experiments.multichip import dryrun_pit
pit = dryrun_pit(["cpu", "cpu"], torch.float64, 0)
distributed.shutdown()
print(json.dumps({{"mean": mean, "resampled": out, "pit": pit}}), flush=True)
"""


def _communicate(procs, timeout):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_two_gloo_processes_share_one_mesh(tmp_path):
    from aux_ssm_tpu_torch.experiments import multichip
    from aux_ssm_tpu_torch.parallel import resampling as pres
    from aux_ssm_tpu_torch.parallel.mesh import PARTICLES, make_mesh
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=REPO))
    rendezvous = "file://" + str(tmp_path / "rendezvous")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), rendezvous],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    results = [json.loads(out.strip().splitlines()[-1]) for out in _communicate(procs, 120)]

    g = torch.Generator().manual_seed(0)
    w = torch.rand(16, generator=g, dtype=torch.float64)
    w = w / w.sum()
    p = torch.randn(16, 2, generator=g, dtype=torch.float64)
    u = torch.rand(16, generator=g, dtype=torch.float64)
    want = pres.sharded_conditional_resample(
        make_mesh(devices=["cpu"] * 4, axis_names=(PARTICLES,)), w, p, u).tolist()
    one = multichip.dryrun_pit(["cpu"] * 4, torch.float64, 0)
    for r in results:
        assert r["mean"] == 1.5
        assert r["resampled"] == [want, want]
        for key in ("time_sharded", "particle_sharded_joint", "particle_sharded_fused"):
            assert r["pit"][key], key
        assert r["pit"]["particle_step"] == one["particle_step"]

