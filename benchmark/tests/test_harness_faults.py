"""Whole runs of a cell cut to a CPU's size: the harness's look for a
card skipped, everything else as on the chip. A sound run comes out
correct; with the timed path broken underneath, ``correct`` comes out
false, once for each fault the cell can have (one card: no exchange
between chips to leave out)."""

import time

import numpy as np
import pytest

from benchmark import run as brun
from benchmark.tests.tiny import CELL, tiny_registry
from epa_ng_tpu_torch.core.engine import PlacementEngine
from epa_ng_tpu_torch.core.lwr import ChunkPlacements
from epa_ng_tpu_torch.ops import newton

SEED = 2 ** 31 + 17


def _run(tmp_path, traffic="dyn", trace=False, **kw):
    reg = tiny_registry(tmp_path, traffic=traffic, **kw)
    return brun.run(reg, reg.workload(CELL), SEED, 1.0, trace, device="cpu",
                    t_start=time.perf_counter())


def _checks(res):
    return {k: v["value"] for k, v in res["checks"].items()}


@pytest.mark.parametrize("traffic", ["dyn", "noheur"])
def test_sound_run_is_correct(tmp_path, traffic):
    kw = dict(taxa=10, pool=32) if traffic == "noheur" else {}
    res = _run(tmp_path, traffic, trace=True, **kw)
    assert res["correct"], _checks(res)
    assert res["failed"] == 0 and res["attempted"] >= 32
    assert f"read_us_per_q.{traffic}" in res["metrics"]
    assert "build_s" in res["metrics"]
    assert list(res)[-1] == "checks"


def test_state_left_unchanged(tmp_path, monkeypatch):
    orig = newton.blo_optimize_batch

    def frozen(*a, **kw):
        kw["max_smoothings"] = 0
        return orig(*a, **kw)
    monkeypatch.setattr(newton, "blo_optimize_batch", frozen)
    res = _run(tmp_path, taxa=24, sites=500, span=(300, 450))
    assert not res["correct"]
    c = _checks(res)
    assert c["opt_gap"] > res["checks"]["opt_gap"]["limit"], c


def _wrap_finalize(monkeypatch, change):
    orig = PlacementEngine.finalize_chunk

    def finalize(self, handle):
        return change(self, orig(self, handle))
    monkeypatch.setattr(PlacementEngine, "finalize_chunk", finalize)


def test_half_the_batch_left_out(tmp_path, monkeypatch):
    def half(self, cp):
        n = len(cp) // 2
        offs = cp.offsets
        cut = lambda a: a[:offs[n]]
        return ChunkPlacements(headers=cp.headers[:n], counts=cp.counts[:n],
                               edges=cut(cp.edges), logls=cut(cp.logls),
                               lwrs=cut(cp.lwrs), pendants=cut(cp.pendants),
                               distals=cut(cp.distals),
                               seq_id_offset=cp.seq_id_offset)
    _wrap_finalize(monkeypatch, half)
    res = _run(tmp_path)
    assert not res["correct"] and _checks(res)["missing"] > 0


def test_answer_altered_where_produced(tmp_path, monkeypatch):
    def shifted(self, cp):
        cp.edges = (cp.edges + 1) % self.num_edges
        return cp
    _wrap_finalize(monkeypatch, shifted)
    res = _run(tmp_path)
    assert not res["correct"]
    c = _checks(res)
    assert c["logl_err"] > res["checks"]["logl_err"]["limit"], c


def test_weights_altered_where_produced(tmp_path, monkeypatch):
    def flat(self, cp):
        cp.lwrs = np.repeat(1.0 / np.maximum(cp.counts, 1), cp.counts)
        return cp
    _wrap_finalize(monkeypatch, flat)
    res = _run(tmp_path)
    assert not res["correct"] and _checks(res)["output_bad"] > 0


def _rows_cut(cp, keep, scale=None):
    """``cp`` with the flat rows where ``keep`` holds, LWRs times
    ``scale`` (one factor a read)."""
    q = np.repeat(np.arange(len(cp)), cp.counts)
    lwrs = cp.lwrs if scale is None else cp.lwrs * scale[q]
    return ChunkPlacements(
        headers=cp.headers, counts=np.bincount(q[keep], minlength=len(cp))
        .astype(np.int32), edges=cp.edges[keep], logls=cp.logls[keep],
        lwrs=lwrs[keep], pendants=cp.pendants[keep],
        distals=cp.distals[keep], seq_id_offset=cp.seq_id_offset)


def _rank(cp):
    return np.arange(len(cp.edges)) - np.repeat(cp.offsets[:-1], cp.counts)


def test_only_the_top_row_written(tmp_path, monkeypatch):
    _wrap_finalize(monkeypatch, lambda self, cp: _rows_cut(cp, _rank(cp) == 0))
    res = _run(tmp_path)
    assert not res["correct"]
    c = _checks(res)
    assert c["rows_off"] > res["checks"]["rows_off"]["limit"], c


def test_runner_up_candidate_dropped(tmp_path, monkeypatch):
    def drop(self, cp):
        rank = _rank(cp)
        w2 = np.zeros(len(cp))
        second = rank == 1
        w2[np.repeat(np.arange(len(cp)), cp.counts)[second]] = cp.lwrs[second]
        return _rows_cut(cp, ~second, 1.0 / (1.0 - w2))
    _wrap_finalize(monkeypatch, drop)
    res = _run(tmp_path)
    assert not res["correct"]
    c = _checks(res)
    assert c["rows_off"] > res["checks"]["rows_off"]["limit"], c
