"""The entry point: no result without a card, and the check on loaded
modules, which compares whole top-level names."""
import json
import subprocess
import sys

from portbench.manifest import CHECKOUT


def test_no_card_no_result():
    code = ("import torch; torch.cuda.is_available = lambda: False; "
            "import runpy, sys; sys.argv = ['run.py', '--workload', 'sv30.kalman2.c32', "
            "'--seed', '1', '--seconds', '1']; runpy.run_path('portbench/run.py', "
            "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=CHECKOUT)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_banned_names_are_whole_top_level_names():
    code = ("import sys, types, json; sys.path.insert(0, 'portbench'); import run; "
            "before = run.banned_modules(); "
            "import aux_ssm_tpu_torch.experiments.sv, aux_ssm_tpu_torch.experiments.spatial; "
            "import portbench.harness; "
            "clean = run.banned_modules(); "
            "[sys.modules.setdefault(n, types.ModuleType(n)) for n in "
            "('aux_ssm_tpu.ops', 'jaxlib', 'jax_like', 'flax.linen')]; "
            "print(json.dumps([before, clean, run.banned_modules()]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=CHECKOUT, check=True)
    before, clean, planted = json.loads(out.stdout.strip().splitlines()[-1])
    assert before == [] and clean == []
    assert planted == ["aux_ssm_tpu.ops", "flax.linen", "jaxlib"]


def test_start_is_the_data_sets_and_the_seed_draws_the_chains(tmp_path):
    import torch

    from portbench.harness import Cell
    from portbench.tests.tiny import tiny_manifest
    manifest = tiny_manifest(tmp_path)
    for workload in ("spatial8.guided.c128", "sv30.guided.c128"):
        a, b = (Cell(manifest, workload, seed, "cpu") for seed in (2233445566, 1987654321))
        assert torch.equal(a.state.x, b.state.x)
        assert torch.equal(a.state.x[0], a.state.x[-1])
        draws = [torch.rand(4, generator=c.gen) for c in (a, b)]
        assert not torch.equal(*draws)
