"""The check sees a broken timed path: a run of each cell, at a tiny size
on the CPU (the look for a card skipped), with the program's step broken
underneath, comes out not correct. The faults a step of these cells can
have: its state returned unchanged; half of the chains left out; an answer
altered where it is produced. (One card: no exchange between cards.)"""
import dataclasses

import pytest
import torch

from portbench.harness import run_cell
from portbench.tests.tiny import tiny_manifest

CELLS = ("sv30.kalman2.c32", "spatial8.guided.c128", "sv30.guided.c128")


def unchanged(kernel):
    def step(state, delta, generator=None, noise=None):
        kernel(state, delta, generator=generator, noise=noise)
        return state
    return step


def half_left_out(kernel):
    def step(state, delta, generator=None, noise=None):
        h = state.x.shape[0] // 2 + 1

        def first(z):
            return z[:h] if isinstance(z, torch.Tensor) and z.dim() and z.shape[0] == \
                state.x.shape[0] else z
        sub = dataclasses.replace(state, **{f.name: first(getattr(state, f.name))
                                            for f in dataclasses.fields(state)})
        out = kernel(sub, delta[:h], generator=generator,
                     noise=None if noise is None else tuple(first(z) for z in noise))
        rest = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
        rest["updated"] = torch.zeros_like(state.updated)
        return dataclasses.replace(state, **{
            k: None if v is None else torch.cat([getattr(out, k), v[h:]])
            for k, v in rest.items()})
    return step


def altered(kernel):
    def step(state, delta, generator=None, noise=None):
        out = kernel(state, delta, generator=generator, noise=noise)
        x = out.x.clone()
        x[:, x.shape[1] // 2, 0] += 0.5
        return dataclasses.replace(out, x=x)
    return step


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return tiny_manifest(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(manifest, cell):
    result, lines = run_cell(cell, 2 ** 31 + 7, 0.3, False, manifest=manifest, device="cpu",
                             log=lambda *a: None)
    assert result["correct"], lines


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(manifest, cell, fault):
    result, lines = run_cell(cell, 2 ** 31 + 7, 0.3, False, manifest=manifest, device="cpu",
                             fault=fault, log=lambda *a: None)
    assert not result["correct"], lines
    assert result["failed"] >= 1
