"""Finds every piece of a cell by its name: the cell and its metrics in
``BENCHMARK.json``, its workload file, its configuration file, its
scene kind's generator and reference, and each per-layer metric's
reader.  Adding a cell, a configuration or a metric adds files and
entries; no code here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads``: its workload file (in ``workloads``,
    ``workloads/`` beside this file by default), configuration and
    metrics."""

    def __init__(self, name: str, bench: dict | None = None,
                 workloads: Path = HERE / "workloads"):
        bench = benchmark() if bench is None else bench
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        self.workload = _load(Path(workloads) / f"{name}.json")
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _load(ROOT / self.config_entry["file"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]

    @property
    def scene_kind(self):
        """The module that makes the inputs and hands them to the
        program."""
        return importlib.import_module(f"solbench.scenes.{self.config['kind']}")

    @property
    def reference_kind(self):
        """The module that makes the reference's scene, and may render
        it (``render``)."""
        return importlib.import_module(
            f"solbench.reference.{self.config['kind']}")

    @property
    def settings(self) -> dict:
        """The configuration's ``render`` block: RenderConfig fields as
        JSON scalars, enums by name; empty where it has none."""
        return self.config.get("render", {})

    @property
    def spp(self) -> int:
        """Samples per pixel of a keyed frame (the workload's ``spp``)."""
        return self.workload.get("spp", 1)

    @property
    def keyed(self) -> bool:
        """Whether the frames draw from a key seeded by ``--seed``."""
        return self.workload.get("keyed", False)

    @property
    def lights(self) -> int:
        """The configuration's lights: its ``lights`` list, or one
        ``light``."""
        if "lights" in self.config:
            return len(self.config["lights"])
        return int("light" in self.config)


def reader(metric: str):
    """The per-layer metric's reader module, layer_metrics/<metric>.py."""
    path = HERE / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "solbench_layer_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
