"""A cell cut to a size the CPU tests hold, as new files beside copies of
the benchmark's own: the registry finds them by name."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.registry import HERE, ROOT, Registry

CELL = "tiny.cell"


def config_path(name: str) -> str:
    """A configuration of the benchmark, or a model file of the tests'
    own (``lg-g4``: the K = 20 reference at a tiny size)."""
    path = os.path.join(HERE, "configs", f"{name}.json")
    if os.path.exists(path):
        return path
    return os.path.join(HERE, "tests", f"{name}.json")


def tiny_registry(tmp_path, config: str = "neotrop-gtr-g4",
                  traffic: str = "dyn", taxa: int = 16, sites: int = 300,
                  span=(60, 120), pool: int = 64, chunk: int = 16,
                  sample: int = 16, compute_dtype: str = "f64",
                  limits: dict | None = None) -> Registry:
    base = os.path.join(str(tmp_path), "benchmark")
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(base, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", taxa=taxa, sites=sites,
               compute_dtype=compute_dtype)
    cfg["reads"] = dict(cfg["reads"], pool=pool, span_min=span[0],
                        span_max=span[1], begin_min=0, begin_max=None)
    _dump(cfg, base, "configs", "tiny.json")
    with open(os.path.join(base, "mixes", f"{traffic}.json")) as f:
        mix = json.load(f)
    cli = list(mix["cli"])
    cli[cli.index("--chunk-size") + 1] = str(chunk)
    _dump(dict(mix, name="tiny" + traffic, cli=cli), base, "mixes",
          f"tiny{traffic}.json")
    with open(os.path.join(base, "limits", f"neotrop.{traffic}.json")) as f:
        lim = json.load(f)
    lim.update(sample=sample, **(limits or {}))
    _dump(lim, base, "limits", f"{CELL}.json")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": CELL, "config": "tiny",
                              "traffic": "tiny" + traffic, "chips": 1,
                              "why": "a cell the CPU tests hold"})
    rate = "card_ms_per_kq" if traffic == "dyn" else "qps_noheur"
    _add_mix_metrics(spec, traffic, rate)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("setup_s", "build_s", rate) or m["name"].endswith(
                "." + traffic):
            if "workloads" in m:
                m["workloads"].append(CELL)
    _dump(spec, base, "spec.json")
    return Registry(os.path.join(base, "spec.json"), base)


def _add_mix_metrics(spec: dict, traffic: str, rate: str):
    """Where ``BENCHMARK.json`` has no cell of this mix, its rate as an
    end-to-end metric and its per-layer metrics as the ``dyn`` ones with
    the mix's suffix, moving the rate (the readers are the same files)."""
    names = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    if rate not in names:
        spec["end_to_end"].append({
            "name": rate, "unit": "queries/s", "better": "higher",
            "bound": 0.25, "source": "host_clock", "workloads": []})
    for m in list(spec["per_layer"]):
        stem, dot, mix = m["name"].partition(".")
        if mix == "dyn" and f"{stem}.{traffic}" not in names:
            spec["per_layer"].append(dict(m, name=f"{stem}.{traffic}",
                                          moves=rate, workloads=[]))


def _dump(obj, *parts):
    with open(os.path.join(*parts), "w") as f:
        json.dump(obj, f)
