"""Discovery by name: the manifest (`BENCHMARK.json`) names each cell's
configuration, traffic mix and metrics, and each lives in a file of its own
under this folder. Adding a configuration, a mix, a limit or a per-layer
metric is adding a file and a manifest entry; no code here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

#: the benchmark's folder, under the root that holds BENCHMARK.json
FOLDER = "slambench"


class Cell:
    """One workload of the manifest, with everything it names loaded."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it names {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = json.loads((self.root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (self.bench_dir / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.limits = json.loads(
            (self.bench_dir / "limits" / f"{name}.json").read_text())["limits"]
        self.chips = int(self.workload["chips"])

    @property
    def bench_dir(self) -> Path:
        return self.root / FOLDER

    def metrics(self, kind: str) -> list:
        """The manifest's `end_to_end` or `per_layer` entries this cell
        reports: those without `workloads`, and those that list it."""
        return [m for m in self.manifest[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: dict):
        """The module of `metrics/<name>.py` that reads a metric."""
        return load_module(self.bench_dir / "metrics" / f"{metric['name']}.py")


def load_module(path: Path):
    """Import a file by its path, under a name of its own (metric files are
    named by metric names, which may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
