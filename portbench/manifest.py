"""`BENCHMARK.json` and the files it names, found by name.

A configuration is `configs/<name>.json` (its `file`), a traffic mix
`traffic/<name>.json`, a metric's reader `metrics/<name>.py`, a kernel's
work `work/<kernel>.py`, a configuration family (the program's builder,
the start and the plain reference model) `families/<family>.py` and a
sampler style's check `styles/<style>.py`. A later change adds a cell, a
configuration or a metric by adding such files and entries; nothing here
lists them.
"""
import importlib.util
import json
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
CHECKOUT = PACKAGE.parent


def load_module(kind, name, package=PACKAGE):
    """`<kind>/<name>.py` of the benchmark (under `package`) as a module,
    loaded once."""
    path = Path(package) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    key = f"portbench.{kind}.{name}" if Path(package) == PACKAGE else f"{path}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


class Manifest:
    """The benchmark's description: `bench` (BENCHMARK.json's object) and
    the root its configuration and traffic files lie under."""

    def __init__(self, bench=None, root=CHECKOUT):
        self.root = Path(root)
        self.bench = bench if bench is not None else json.loads(
            (self.root / "BENCHMARK.json").read_text())

    def workload(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return json.loads((self.root / self.bench["paths"][0] / "traffic"
                           / f"{name}.json").read_text())

    def module(self, kind, name):
        """`<kind>/<name>.py`: the one under this manifest's root where it
        has one, else the benchmark's own."""
        own = self.root / self.bench["paths"][0]
        found = (own / kind / f"{name}.py").is_file()
        return load_module(kind, name, own if found else PACKAGE)

    def metrics(self, workload, trace):
        """The metric entries a run of `workload` reports: its end-to-end
        metrics, or with `trace` its per-layer ones."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[kind] if workload in m.get("workloads", [workload])]
