"""The benchmark's data files, found by name.

A cell (`workloads/<cell>.json`) names its configuration (`configs/<name>.json`)
and its traffic mix (`traffic/<name>.json`); BENCHMARK.json at the root names
the metrics a cell reports; each per-layer metric is read by
`metrics/<metric>.py`, and each hand-written kernel of the program is mapped
to the function it implements by `kernels/<kernel>.json`. Adding any of
these is adding a file: nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"benchmark: no file {path}")
    return json.loads(path.read_text())


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"benchmark: {name!r} is not a name")
    return name


@dataclasses.dataclass(frozen=True)
class Cell:
    """One cell: its name, configuration, traffic mix and the metrics that
    BENCHMARK.json gives it."""

    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def entry(self) -> str:
        return self.traffic["entry"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` from its own file, checked against BENCHMARK.json's
    entry for it, with the end-to-end and per-layer metrics that entry
    reports (a metric without a `workloads` key is reported by every cell
    that reports the end-to-end metric it moves)."""
    here = root / HERE.name
    cell = _load_json(here / "workloads" / f"{_checked(name)}.json")
    bench = _load_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"benchmark: BENCHMARK.json has no cell {name!r}")
    for key in ("config", "traffic"):
        if entries[0][key] != cell[key]:
            raise ValueError(f"benchmark: cell {name}: {key} {cell[key]!r} in its file, "
                             f"{entries[0][key]!r} in BENCHMARK.json")
    config = _load_json(here / "configs" / f"{_checked(cell['config'])}.json")
    traffic = _load_json(here / "traffic" / f"{_checked(cell['traffic'])}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, config=config, traffic=traffic, end_to_end=e2e, per_layer=layer)


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """`read(summary) -> float | None` of metrics/<name>.py."""
    path = root / HERE.name / "metrics" / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"benchmark: no reader {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_map(root: Path = ROOT) -> list:
    """[(compiled name pattern, function)] of every kernels/*.json."""
    out = []
    for path in sorted((root / HERE.name / "kernels").glob("*.json")):
        k = json.loads(path.read_text())
        out.append((re.compile(k["pattern"]), k["function"]))
    return out


def function_of(kernel_name: str, kmap: list) -> Optional[str]:
    """The function a device kernel implements, None for plain ops."""
    for pattern, fn in kmap:
        if pattern.search(kernel_name):
            return fn
    return None


def reference_problem(config: dict):
    """The plain reference's Problem of a configuration: reference/<name>.py."""
    mod = importlib.import_module(f"{HERE.name}.reference.{_checked(config['name'])}")
    return mod.problem(config)
