"""A cell's files are found by name: a configuration, a mix, a limit file
and a metric reader dropped in as new files, with no existing file
edited; and ``BENCHMARK.json`` keeps to the shape its readers expect."""

import hashlib
import json
import os
import re

import pytest

from benchmark.registry import HERE, ROOT, Registry
from benchmark.tests.tiny import CELL, tiny_registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _digests(base):
    out = {}
    for d, _, files in os.walk(base):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, base)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_drop_in_files_are_found_by_name(tmp_path):
    reg = tiny_registry(tmp_path)
    before = _digests(HERE)
    with open(os.path.join(reg.base, "metrics", "tiny_metric.py"), "w") as f:
        f.write("def read(run):\n    return 2.0 * run.written\n")
    w = reg.workload(CELL)
    assert reg.config(w["config"])["taxa"] == 16
    assert "--chunk-size" in reg.mix(w["traffic"])["cli"]
    assert reg.limits(CELL)["sample"] == 16
    assert reg.reader("tiny_metric")(type("R", (), {"written": 3})) == 6.0
    # a dotted name falls back to the file of its stem
    assert reg.reader("tiny_metric.dyn") is not None
    assert reg.reader("read_us_per_q.dyn").__module__ != \
        reg.reader("tiny_metric").__module__
    names = [m["name"] for m in reg.metrics("per_layer", CELL)]
    assert "read_us_per_q.dyn" in names and "build_s" in names
    assert "read_us_per_q.noheur" not in names
    assert _digests(HERE) == before


def test_benchmark_json_shape():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    reg = Registry()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    cfg_names = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert NAME.match(c["name"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    used = set()
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in cfg_names
        used.add(w["config"])
        reg.mix(w["traffic"])
        assert set(reg.limits(w["name"])) >= {"sample", "missing",
                                              "output_bad", "logl_err",
                                              "opt_gap"}
        e2e = [m["name"] for m in reg.metrics("end_to_end", w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reg.metrics("per_layer", w["name"])
    assert used == cfg_names
    e2e_names = {m["name"] for m in spec["end_to_end"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert reg.reader(m["name"]) is not None
    for m in spec["per_layer"]:
        assert m["moves"] in e2e_names
        moved = next(e for e in spec["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get(
            "workloads", [w["name"] for w in spec["workloads"]]))


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(HERE) for f in fs if f.endswith(".py")))
def test_harness_imports_no_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|epa_ng_tpu)\b"
                         r"(?!_torch)", text, re.M), path


@pytest.mark.parametrize("name", ["model", "datagen", "reference", "compare",
                                  "counts"])
def test_yardstick_imports_nothing_of_the_program(name):
    with open(os.path.join(HERE, f"{name}.py")) as f:
        assert "epa_ng_tpu" not in f.read()


def test_card_time_is_the_window_busy_time_over_the_reads():
    """``card_ms_per_kq``: the union of the device's operations in the
    window, over every read written; nothing without a timeline."""
    from benchmark.trace import DeviceTimeline
    read = Registry().reader("card_ms_per_kq")
    s = 10 ** 9
    # two overlapping operations (0.5-1.5 s, 1.0-2.0 s) count once, and
    # what lies outside the window [0, 3 s] not at all
    events = [("gemm", 7, s // 2, 3 * s // 2), ("gather", 8, s, 2 * s),
              ("copy", 7, 4 * s, 5 * s)]
    tl = DeviceTimeline(events, 0, 3 * s)
    run = type("R", (), {"timeline": tl, "written": 3000})
    assert tl.busy_s == pytest.approx(1.5)
    assert read(run) == pytest.approx(1.5e3 / 3)
    assert read(type("R", (), {"timeline": None, "written": 3000})) is None
    idle = DeviceTimeline([], 0, 3 * s)
    assert read(type("R", (), {"timeline": idle, "written": 3000})) is None
