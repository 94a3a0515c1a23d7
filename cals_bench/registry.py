"""Finds the benchmark's pieces by name, so that a cell, a configuration,
a traffic mix, a metric or a kernel family is added as files of its own:

- ``BENCHMARK.json`` at the repository root names the cells (workloads)
  and the metrics;
- ``configs/<name>.json``: a configuration (the tensor, its source, the
  sizes assumed and the keys reduced);
- ``traffic/<name>.json``: a traffic mix (the job, its engine settings,
  the precision control);
- ``metrics/<name>.py``: one metric's reader, ``read(run) -> float | None``
  (``run``: a ``runner.RunData``), end-to-end and per-layer alike; a
  metric split by the cells it is read in (``<name>.<part>``, each part
  with its own entry in ``BENCHMARK.json``) shares ``metrics/<name>.py``
  unless ``metrics/<name>.<part>.py`` exists;
- ``kernels/<family>.json``: the device-kernel name patterns of a kernel
  family (``{"patterns": [...]}``, substrings of the kernel's name; a
  kernel that two families' patterns name stops the trace's reading);
- ``limits/<cell>.json``: the numbers the cell's correctness check
  compares, each with its limit and the readings it was set from.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Registry:
    def __init__(self, root: Path | str = HERE.parent, bench_dir: Path | str | None = None):
        self.root = Path(root)
        self.dir = Path(bench_dir) if bench_dir is not None else HERE
        self.benchmark = json.loads((self.root / "BENCHMARK.json").read_text())
        self._metrics: dict = {}

    def _json(self, kind: str, name: str) -> dict:
        path = self.dir / kind / f"{name}.json"
        if not path.is_file():
            raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} ({path})")
        return json.loads(path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def kernel_families(self) -> dict[str, list[str]]:
        return {p.stem: json.loads(p.read_text())["patterns"] for p in sorted((self.dir / "kernels").glob("*.json"))}

    def metric(self, name: str):
        """The module ``metrics/<name>.py`` (or, for ``<base>.<part>``
        without a file of its own, ``metrics/<base>.py``), loaded once."""
        if name not in self._metrics:
            path = self.dir / "metrics" / f"{name}.py"
            if not path.is_file():
                path = self.dir / "metrics" / f"{name.split('.')[0]}.py"
            if not path.is_file():
                raise KeyError(f"no metric reader for {name!r} ({path})")
            spec = importlib.util.spec_from_file_location(f"cals_bench_metric_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._metrics[name] = mod
        return self._metrics[name]

    def metrics_of(self, workload: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries that this cell reports:
        those whose ``workloads`` list names it, or that have no such list."""
        return [m for m in self.benchmark[kind] if workload in m.get("workloads", [workload])]
