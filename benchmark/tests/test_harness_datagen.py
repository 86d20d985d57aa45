"""The vectorised evolved-read generator: deterministic per seed, the same
spans for every seed, reads that come from their true edges."""

import json

import numpy as np
import pytest

from benchmark import datagen, reference
from benchmark.model import Model
from benchmark.tests.tiny import config_path


def _cfg(name="neotrop-gtr-g4", **kw):
    with open(config_path(name)) as f:
        cfg = json.load(f)
    reads = kw.pop("reads", {})
    cfg.update(kw)
    cfg["reads"] = dict(cfg["reads"], **reads)
    return cfg


TINY = dict(taxa=20, sites=300, reads=dict(pool=50, span_min=40,
                                           span_max=90, begin_min=0,
                                           begin_max=None))


@pytest.mark.parametrize("name", ["neotrop-gtr-g4", "lg-g4"])
def test_same_seed_same_data(tmp_path, name):
    cfg = _cfg(name, **TINY)
    a, b = (datagen.generate(cfg, 2 ** 31 + 5) for _ in range(2))
    c = datagen.generate(cfg, 2 ** 31 + 6)
    for f in ("parent", "length", "states", "read_node", "read_begin",
              "read_span", "read_codes"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert not np.array_equal(a.states, c.states)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    pa = datagen.write_files(a, str(tmp_path / "a"))
    pb = datagen.write_files(b, str(tmp_path / "b"))
    for k in pa:
        with open(pa[k], "rb") as fa, open(pb[k], "rb") as fb:
            assert fa.read() == fb.read(), k


def test_spans_are_one_multiset_and_windows_fit():
    cfg = _cfg(**TINY)
    a, b = datagen.generate(cfg, 1), datagen.generate(cfg, 2)
    assert np.array_equal(np.sort(a.read_span), np.sort(b.read_span))
    assert not np.array_equal(a.read_span, b.read_span)
    assert a.read_span.min() >= 40 and a.read_span.max() <= 90
    assert ((a.read_begin + a.read_span) <= cfg["sites"]).all()
    region = _cfg()["reads"]
    big = datagen.generate(_cfg(taxa=8, reads=dict(pool=400)), 3)
    assert big.read_begin.min() >= region["begin_min"]
    assert big.read_begin.max() <= region["begin_max"]


def test_pool_fasta(tmp_path):
    ds = datagen.generate(_cfg("lg-g4", **TINY), 7)
    paths = datagen.write_files(ds, str(tmp_path))
    with open(paths["pool"]) as f:
        lines = f.read().split("\n")
    names, rows = lines[0:-1:2], lines[1::2]
    assert names == [">" + ds.read_name(i) for i in range(ds.num_reads)]
    assert len(set(rows)) == ds.num_reads
    for i in (0, 17, ds.num_reads - 1):
        b, s = ds.read_begin[i], ds.read_span[i]
        row = rows[i]
        assert set(row[:b] + row[b + s:]) <= {"-"}
        want = "".join(ds.alphabet[c] for c in ds.read_codes[i, :s])
        assert row[b:b + s] == want


def test_reads_come_from_their_true_edges():
    """With a short pendant and long reads, the true edge is among the
    reference's three best preplacement edges for nearly every read."""
    cfg = _cfg(taxa=24, sites=400, reads=dict(
        pool=24, span_min=300, span_max=400, begin_min=0, begin_max=None,
        pendant=0.001))
    ds = datagen.generate(cfg, 11)
    ref = reference.Reference(ds, Model(cfg), np.arange(cfg["sites"]))
    scores = ref.preplace(np.arange(ds.num_reads))
    edges = ref.edge_nodes
    top3 = edges[np.argsort(-scores, axis=1)[:, :3]]
    hit = (top3 == ds.read_node[:, None]).any(axis=1)
    assert hit.mean() >= 0.9
