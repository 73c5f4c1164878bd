"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import re

import pytest

from portbench.harness import run_cell
from portbench.manifest import CHECKOUT, PACKAGE, Manifest, load_module
from portbench.tests.tiny import tiny_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def test_keys_and_names(bench):
    assert set(bench) == KEYS
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    assert "setup_s" in e2e


def test_cells_name_their_files(bench):
    m = Manifest(bench)
    configs = {c["name"] for c in bench["configs"]}
    assert len({c["file"] for c in bench["configs"]}) == len(configs)
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        cfg, traffic = m.config(w["config"]), m.traffic(w["traffic"])
        assert cfg["name"] == w["config"]
        m.module("families", cfg["family"])
        style = m.module("styles", traffic["style"])
        assert set(traffic["limits"]) == set(style.NUMBERS)
        for metric in m.metrics(w["name"], False) + m.metrics(w["name"], True):
            assert hasattr(m.module("metrics", metric["name"]), "read")
        assert {x["name"] for x in m.metrics(w["name"], False)} >= {"setup_s", "samples_per_s"}
        assert m.metrics(w["name"], True)
    for c in bench["configs"]:
        assert c["reduced"] == [] and c["file"].startswith(bench["paths"][0] + "/")


def test_roofline_metrics_have_work_files(bench):
    for metric in bench["per_layer"]:
        if metric["name"].startswith("roofline."):
            work = load_module("work", metric["name"].split(".", 1)[1])
            assert work.NAMES and callable(work.per_step)


def test_paths_hold_only_the_benchmark(bench):
    assert bench["paths"] == ["portbench"] and bench["command"][1] == "portbench/run.py"
    assert (CHECKOUT / bench["command"][1]).is_file()
    assert PACKAGE == CHECKOUT / "portbench"


def test_added_metric_file_is_found_without_an_edit(tmp_path):
    """A metric's reader dropped beside the others, and its entry in the
    manifest, reach the run's result; no other file changes."""
    m = tiny_manifest(tmp_path)
    metrics_dir = tmp_path / m.bench["paths"][0] / "metrics"
    metrics_dir.mkdir(parents=True)
    (metrics_dir / "steps_seen.py").write_text("def read(ctx):\n    return float(ctx['steps'])\n")
    m.bench["end_to_end"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                                  "bound": 0.25, "source": "host_clock"})
    result, _ = run_cell("sv30.guided.c128", 5, 0.3, False, manifest=m, device="cpu",
                         log=lambda *a: None)
    steps = result["metrics"]["steps_seen"]["value"]
    assert steps >= 4 and steps == round(steps)
