"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells; everything
that belongs to one configuration, mix, cell or metric is a file of its
own under ``benchmark/``:

- ``configs/<config>.json``: the model's sizes as run;
- ``traffic/<traffic>.json``: the mix's parameters, and its ``kind``;
- ``kinds/<kind>.py``: the generator, driver and reference calls of one
  kind of traffic (``generate``, ``Driver``, ``planned``, ``references``,
  ``SPANS``), shared by every mix of that kind;
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct`` in that cell, with the readings they were set from;
- ``metrics/<metric>.py``: the reader of one per-layer metric, a
  function ``read(ctx) -> float | None``.

A metric is found under its own name or, where no file or key has it,
under its name less the last dotted part: ``dprnn_roofline.live`` and
``dprnn_roofline.offline`` share ``metrics/dprnn_roofline.py``, and the
end-to-end ``offline_xrt.mesh4`` is the offline driver's ``offline_xrt``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Iterable, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent


def lookup(name: str, known: Iterable[str]) -> Optional[str]:
    """``name`` if ``known`` holds it, else its name less the last dotted
    part if that is known, else ``None``."""
    known = set(known)
    for key in (name, name.rpartition(".")[0]):
        if key and key in known:
            return key
    return None


def _load(path: Path, modname: str) -> ModuleType:
    import sys

    modname = modname.replace(".", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path, bench_dir: Optional[Path] = None):
        self.root = Path(root)
        self.dir = Path(bench_dir) if bench_dir is not None else self.root / "benchmark"
        with open(self.root / "BENCHMARK.json") as f:
            self.doc = json.load(f)

    def cell(self, name: str) -> dict:
        for cell in self.doc["workloads"]:
            if cell["name"] == name:
                return cell
        known = ", ".join(c["name"] for c in self.doc["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")

    def _json(self, sub: str, name: str) -> dict:
        with open(self.dir / sub / f"{name}.json") as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def metrics_of(self, cell: dict, trace: bool) -> List[dict]:
        """The metric entries this cell reports: with ``trace``, the
        per-layer metrics whose ``workloads`` list it (or that list none
        and move an end-to-end metric the cell reports); else the
        end-to-end metrics that list it or list no cells."""
        name = cell["name"]
        e2e = [m for m in self.doc["end_to_end"]
               if "workloads" not in m or name in m["workloads"]]
        if not trace:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.doc["per_layer"]
                if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]

    def kind(self, name: str) -> ModuleType:
        """The module ``kinds/<name>.py``."""
        return _load(self.dir / "kinds" / f"{name}.py", f"_bench_kind_{name}")

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        """``read`` of ``metrics/<metric>.py``, or of the file of the
        metric's name less its last dotted part."""
        files = {p.stem for p in (self.dir / "metrics").glob("*.py")}
        key = lookup(metric, files)
        if key is None:
            raise FileNotFoundError(f"no reader metrics/{metric}.py for the metric {metric!r}")
        return _load(self.dir / "metrics" / f"{key}.py", f"_bench_metric_{key}").read
