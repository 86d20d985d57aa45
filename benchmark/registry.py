"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

- configuration ``<config>``: ``configs/<config>.json``;
- traffic mix ``<traffic>``: ``mixes/<traffic>.json``;
- the check's limits and sample of cell ``<workload>``:
  ``limits/<workload>.json``;
- metric ``<name>``: ``metrics/<name>.py``, else ``metrics/<stem>.py`` with
  ``<stem>`` the name before its first dot (``qps_noheur``,
  ``read_us_per_q.dyn`` -> ``read_us_per_q.py``); the module's
  ``read(run)`` returns the number or None when it finds nothing to read.
  A reader of the program's own recorder (``epa_ng_tpu_torch.utils.timer``)
  lists the names it reads there: ``SPANS = ("dispatch",)`` for span
  names, ``COUNTS = (...)`` for count names. A program that never records
  one of them in the run (an older one, or one without the recorder) does
  not have what the metric measures: the run leaves the metric out and
  names it, where a reader that declares nothing and reads nothing stops
  the run (``run.silent_metrics``).

A later cell adds files; none of these has to change.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Registry:
    def __init__(self, spec_path: str | None = None, base: str = HERE):
        self.base = base
        with open(spec_path or os.path.join(ROOT, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self._modules = {}

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.base, *parts)) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", f"{name}.json")

    def mix(self, name: str) -> dict:
        return self._json("mixes", f"{name}.json")

    def limits(self, workload: str) -> dict:
        return self._json("limits", f"{workload}.json")

    def metrics(self, kind: str, workload: str) -> list:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.spec[kind]
                if workload in m.get("workloads", [workload])]

    def _module(self, name: str):
        if name not in self._modules:
            path = os.path.join(self.base, "metrics", f"{name}.py")
            if not os.path.exists(path):
                path = os.path.join(self.base, "metrics",
                                    f"{name.split('.')[0]}.py")
            spec = importlib.util.spec_from_file_location(
                f"benchmark_metric_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[name] = mod
        return self._modules[name]

    def reader(self, name: str):
        return self._module(name).read

    def program_names(self, name: str) -> tuple:
        """(span names, count names) the reader of ``name`` reads from the
        program's recorder; both empty for a reader of anything else."""
        mod = self._module(name)
        return (tuple(getattr(mod, "SPANS", ())),
                tuple(getattr(mod, "COUNTS", ())))
