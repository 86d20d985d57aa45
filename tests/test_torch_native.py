"""The port's native FASTA reader (``io/native.py``, ``native/fastseq.cpp``):
one pass over the file builds a finished chunk (lookup-column codes,
valid ranges, row hashes, labels). Held against the readers it stands in
for, the python ``io/fasta.py::MSAStream`` and the native passthrough scan
(``NativeMSAStream.read_next``), each followed by ``from_msa``
(``encode_rows``), ``check_chunk`` and ``collapse``: codes, ranges,
headers and the collapsed groups; the errors; the counts of the scan's two
paths and of the duplicate pre-screen; the library's name, keyed on its
source; and the CLI's jplace with and without the native reader."""

import dataclasses
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import datagen
from epa_ng_tpu_torch.cli import main as torch_main
from epa_ng_tpu_torch.core import chunk as chunk_mod
from epa_ng_tpu_torch.core.engine import PlacementEngine
from epa_ng_tpu_torch.io import fasta as fio
from epa_ng_tpu_torch.io import native
from epa_ng_tpu_torch.models.charmaps import INVALID_COL, lookup_col_table
from epa_ng_tpu_torch.utils.synth import synth_files
from epa_ng_tpu_torch.utils.timer import RECORDER

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "configs",
    "neotrop-gtr-g4.json")
GTR = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}"


@pytest.fixture(autouse=True)
def _native_lib():
    if native.get_lib() is None:
        pytest.skip("the native fastseq library did not build here")


def _pool(tmp_path, seed, n=120):
    """A small read pool from the benchmark's generator: single-line
    aligned reads of 60-200 columns inside columns 150-400 of 700."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg.update(taxa=16, sites=700)
    cfg["reads"] = dict(cfg["reads"], pool=n, span_min=60, span_max=200,
                        begin_min=150, begin_max=400)
    ds = datagen.generate(cfg, seed, pool=n)
    return datagen.write_files(ds, str(tmp_path))["pool"]


def _write(path, records, wrap=None, eol="\n", pad="", blank=False):
    """FASTA of (label, sequence) records; sequences wrapped every ``wrap``
    columns, lines ended by ``eol`` after ``pad``, a blank line after each
    record if ``blank``."""
    out = []
    for label, seq in records:
        out.append(f">{label}{eol}")
        step = wrap or max(1, len(seq))
        for i in range(0, len(seq), step):
            out.append(seq[i:i + step] + pad + eol)
        if blank:
            out.append(eol)
    with open(path, "w", newline="") as f:
        f.write("".join(out))
    return str(path)


def _check(ec, premasking):
    """``PlacementEngine.check_chunk`` on a copy of a chunk, at its own
    width (it rewrites the ranges with premasking off)."""
    eng = SimpleNamespace(num_sites=ec.codes.shape[1],
                          options=SimpleNamespace(premasking=premasking))
    return PlacementEngine.check_chunk(eng, dataclasses.replace(ec))


def _chunks(path, premask, num_states, size, how, shard=None):
    """Every chunk of a file: ``fused`` (the one native pass),
    ``passthrough`` (the native byte scan, then ``from_msa``) or
    ``python`` (``MSAStream``, then ``from_msa``)."""
    info = fio.make_msa_info(path)
    cls = fio.MSAStream if how == "python" else native.NativeMSAStream
    reader = cls(path, info, premask, shard=shard)
    if how != "python":
        assert isinstance(reader, native.NativeMSAStream)
    out = []
    while True:
        if how == "fused":
            ec = reader.read_next_encoded(size, num_states)
            if ec is None:
                return out
        else:
            msa = reader.read_next(size)
            if not len(msa):
                return out
            ec = chunk_mod.from_msa(msa, num_states)
        out.append(ec)


def _assert_same_chunks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.headers == w.headers
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.ranges, w.ranges)
        assert g.ranges.dtype == np.int32 and g.codes.dtype == np.uint8
        np.testing.assert_array_equal(g.row_hash,
                                      chunk_mod.code_hashes(g.codes))
        assert w.row_hash is None


def _assert_same_collapsed(got, want, premask):
    for g, w in zip(got, want):
        g = chunk_mod.collapse(_check(g, premask))
        w = chunk_mod.collapse(_check(w, premask))
        assert g.headers == w.headers
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.ranges, w.ranges)


def _compare(path, premask, num_states, size, shard=None):
    got = _chunks(path, premask, num_states, size, "fused", shard)
    for how in ("passthrough", "python"):
        want = _chunks(path, premask, num_states, size, how, shard)
        _assert_same_chunks(got, want)
        _assert_same_collapsed(got, want, premask)
    return got


@pytest.mark.parametrize("seed", [3141592101, 2718281828])
@pytest.mark.parametrize("premask", [True, False])
@pytest.mark.parametrize("size", [7, 120])
def test_pool_matches_the_readers_it_replaces(tmp_path, seed, premask,
                                              size):
    path = _pool(tmp_path, seed)
    before = RECORDER.counts()
    got = _compare(path, premask, 4, size)
    assert sum(len(ec) for ec in got) == 120
    if premask:
        # the reads cover columns 150-599 of 700: premasking drops the rest
        assert got[0].codes.shape[1] < 700
    gathered = RECORDER.counts().get("read.rows_gather", 0)
    # the benchmark's single-line pool: every record takes the gather
    # (the fused pass here, and the passthrough scan of the reference)
    assert gathered - before.get("read.rows_gather", 0) == 2 * 120
    assert (RECORDER.counts().get("read.rows_byteloop", 0)
            == before.get("read.rows_byteloop", 0))


@pytest.mark.parametrize("shard,size", [((0, 50), 16), ((37, 40), 7),
                                        ((100, 20), 64), ((119, 1), 1)])
def test_shards_and_chunk_boundaries(tmp_path, shard, size):
    path = _pool(tmp_path, 3141592101)
    names = [label for label, _ in fio.iter_fasta(path)]
    got = _compare(path, True, 4, size, shard=shard)
    assert [h[0] for ec in got for h in ec.headers] == names[
        shard[0]:sum(shard)]
    assert sum(len(ec) for ec in got) == shard[1]
    assert max(len(ec) for ec in got) <= size


def test_process_split_covers_the_pool_once(tmp_path):
    path = _pool(tmp_path, 2718281828, n=101)
    info = fio.make_msa_info(path)
    want = [label for label, _ in fio.iter_fasta(path)]
    names = []
    for pidx in range(3):
        r = native.NativeMSAStream(path, info, True, split=True,
                                   process_index=pidx, process_count=3)
        while (ec := r.read_next_encoded(9, 4)) is not None:
            names += [h[0] for h in ec.headers]
    assert names == want and len(names) == 101


def _protein_records(seed, n=40, width=90):
    rng = np.random.default_rng(seed)
    table = lookup_col_table(20)
    alphabet = [c for c in "ACDEFGHIKLMNPQRSTVWYXBZacdefghiklmnpqrstvwyx?-"
                if table[ord(c.upper())] != INVALID_COL]
    letters = np.array([c for c in alphabet if c not in "-?"])
    recs = []
    for i in range(n):
        b = int(rng.integers(0, 30))
        e = int(rng.integers(b + 10, width))
        row = np.full(width, "-")
        row[b:e] = rng.choice(letters, size=e - b)
        row[b + 3] = "?"
        recs.append((f"prot {i} sample=A", "".join(row)))
    recs.append(("edge ?", "?" + "-" * 40 + "W" + "-" * (width - 42)))
    recs.append(recs[5])                       # a duplicate
    return recs


@pytest.mark.parametrize("premask", [True, False])
@pytest.mark.parametrize("wrap", [None, 25])
def test_protein_matches_the_readers_it_replaces(tmp_path, premask, wrap):
    path = _write(tmp_path / "prot.fasta", _protein_records(7), wrap=wrap)
    got = _compare(path, premask, 20, 16)
    assert got[0].headers[0] == ["prot 0 sample=A"]


_LAYOUTS = {
    "multi-line": dict(wrap=37),
    "crlf": dict(eol="\r\n"),
    "trailing-space": dict(pad=" \t"),
    "blank-lines": dict(blank=True),
    "wrapped-crlf": dict(wrap=50, eol="\r\n", pad=" "),
}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_other_layouts_take_the_byte_loop_with_the_same_output(tmp_path,
                                                               layout):
    src = _pool(tmp_path, 3141592101, n=60)
    records = list(fio.iter_fasta(src))
    path = _write(tmp_path / "other.fasta", records, **_LAYOUTS[layout])
    before = RECORDER.counts()
    got = _chunks(path, True, 4, 16, "fused")
    after = RECORDER.counts()
    assert (after["read.rows_byteloop"]
            - before.get("read.rows_byteloop", 0)) == 60
    assert (after.get("read.rows_gather", 0)
            == before.get("read.rows_gather", 0))
    want = _chunks(src, True, 4, 16, "fused")
    for g, w in zip(got, want):
        assert g.headers == w.headers
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.ranges, w.ranges)
        np.testing.assert_array_equal(g.row_hash, w.row_hash)
    _compare(path, True, 4, 16)


def test_mixed_layouts_count_each_record_once(tmp_path):
    recs = [(f"r{i}", "--ACGTAC" * 8) for i in range(10)]
    single = _write(tmp_path / "a.fasta", recs[:6])
    wrapped = _write(tmp_path / "b.fasta", recs[6:], wrap=10)
    path = tmp_path / "mixed.fasta"
    path.write_bytes(open(single, "rb").read() + open(wrapped, "rb").read())
    before = RECORDER.counts()
    got = _compare(str(path), False, 4, 4)
    after = RECORDER.counts()
    delta = {k: after[k] - before.get(k, 0)
             for k in ("read.rows_gather", "read.rows_byteloop")}
    # the fused pass and the passthrough reference each read the file
    assert delta == {"read.rows_gather": 2 * 6, "read.rows_byteloop": 2 * 4}
    assert sum(len(ec) for ec in got) == 10


def test_edges_case_and_uracil_collapse_like_the_python_reader(tmp_path):
    core = "ACGTTGCC"
    recs = [("plain", "--" + core + "--"),
            ("qm-left", "??" + core + "--"),        # '?' keeps the range
            ("qm-right", "--" + core + "??"),
            ("uracil", "--" + core.replace("T", "U") + "--"),
            ("lower", "--" + core.lower() + "--"),
            ("qm-left again", "??" + core + "--"),
            ("other", "--" + core[::-1] + "--"),
            ("full", "AC" + core + "GT")]           # no column is all gaps
    path = _write(tmp_path / "edges.fasta", recs)
    got = _compare(path, True, 4, 16)
    ec = got[0]
    np.testing.assert_array_equal(ec.ranges[:3], [[2, 8], [0, 10], [2, 10]])
    groups = chunk_mod.collapse(_check(ec, True)).headers
    assert groups == [["plain", "uracil", "lower"],
                      ["qm-left", "qm-left again"], ["qm-right"],
                      ["other"], ["full"]]
    # premasking off: every range is the whole width, so the edges merge
    groups = chunk_mod.collapse(_check(_chunks(path, True, 4, 16,
                                               "fused")[0], False)).headers
    assert groups == [["plain", "qm-left", "qm-right", "uracil", "lower",
                       "qm-left again"], ["other"], ["full"]]


@pytest.mark.parametrize("bad,shown", [("j", "J"), ("!", "!")])
@pytest.mark.parametrize("wrap", [None, 7])
def test_invalid_character_names_the_sequence(tmp_path, bad, shown, wrap):
    recs = [(f"s {i}", "--ACGTACGTAC--") for i in range(5)]
    recs[3] = ("s 3", "--ACGTAC" + bad + "TAC--")
    path = _write(tmp_path / "bad.fasta", recs, wrap=wrap)
    msg = f"invalid character {shown!r} in sequence (sequence 's 3')"
    for how in ("fused", "passthrough", "python"):
        with pytest.raises(ValueError) as err:
            _chunks(path, True, 4, 16, how)
        assert str(err.value) == msg, how


def test_gather_and_byte_loop_report_the_same_invalid_character(tmp_path):
    recs = [(f"s{i}", "--ACGT" + "ACGTNRYX"[i] + "CGT--") for i in range(8)]
    recs[2] = ("s2", "--ACGTZCGTQ-")
    msgs = []
    for name, kw in (("one.fasta", {}), ("wrapped.fasta", dict(wrap=5)),
                     ("crlf.fasta", dict(eol="\r\n"))):
        path = _write(tmp_path / name, recs, **kw)
        with pytest.raises(ValueError) as err:
            _chunks(path, False, 4, 16, "fused")
        msgs.append(str(err.value))
    assert msgs == ["invalid character 'Z' in sequence (sequence 's2')"] * 3


@pytest.mark.parametrize("wrap", [None, 4])
@pytest.mark.parametrize("sites", [11, 13])
def test_width_mismatch_keeps_its_message(tmp_path, wrap, sites):
    path = _write(tmp_path / "w.fasta", [("a", "ACGTACGTACGT")], wrap=wrap)
    reader = native.NativeChunkReader(path, sites)
    with pytest.raises(ValueError, match="^sequence width mismatch$"):
        reader.read_chunk(4, native.encoded_map(4))


@pytest.mark.parametrize("text", [
    ">a\nACGTAC GTACG\n",              # full width, but a space in it
    ">a\nACGTACGTACGT\nA\n",           # full width, then one more line
    ">a\nACGTACGTACGT\n\nA\n",         # ... after a blank line
], ids=["space", "continued", "continued-after-blank"])
def test_full_width_lines_that_are_not_the_record_fail_the_width(tmp_path,
                                                                 text):
    path = tmp_path / "w.fasta"
    path.write_text(text)
    reader = native.NativeChunkReader(str(path), 12)
    with pytest.raises(ValueError, match="^sequence width mismatch$"):
        reader.read_chunk(4, native.encoded_map(4))


def test_over_long_labels_keep_their_message(tmp_path):
    path = _write(tmp_path / "l.fasta", [("x" * 600, "ACGT")])
    reader = native.NativeChunkReader(path, 4)
    with pytest.raises(RuntimeError, match=r"native read failed \(-5\)"):
        reader.read_chunk(1, native.encoded_map(4))


def test_collapse_sends_only_duplicate_chunks_to_the_exact_comparison(
        tmp_path):
    distinct = _pool(tmp_path, 3141592101, n=80)
    before = RECORDER.counts().get("collapse.exact", 0)
    for ec in _chunks(distinct, True, 4, 16, "fused"):
        assert len(chunk_mod.collapse(_check(ec, True))) == len(ec)
    assert RECORDER.counts().get("collapse.exact", 0) == before

    # chunk 0: reads 0-11 and copies of reads 0-3; chunk 1: reads 12-27
    recs = list(fio.iter_fasta(distinct))
    recs = (recs[:12] + [(f"dup{i}", recs[i][1]) for i in range(4)]
            + recs[12:28])
    dups = _write(tmp_path / "dups.fasta", recs)
    got = _chunks(dups, True, 4, 16, "fused")
    before = RECORDER.counts().get("collapse.exact", 0)
    for ec in got:
        fused = chunk_mod.collapse(_check(ec, True))
        plain = chunk_mod.collapse(_check(chunk_mod.EncodedChunk(
            headers=ec.headers, codes=ec.codes, ranges=ec.ranges), True))
        assert fused.headers == plain.headers
        np.testing.assert_array_equal(fused.codes, plain.codes)
    # chunk 0 alone, once through the reader's hash, once through numpy's
    assert RECORDER.counts()["collapse.exact"] - before == 2
    assert chunk_mod.collapse(_check(got[0], True)).headers[:2] == [
        [recs[0][0], "dup0"], [recs[1][0], "dup1"]]


def test_counts_add_up_to_the_records_read(tmp_path):
    path = _pool(tmp_path, 2718281828, n=90)
    before = RECORDER.counts()
    n = sum(len(ec) for ec in _chunks(path, True, 4, 25, "fused"))
    after = RECORDER.counts()
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("read.rows_gather", "read.rows_byteloop")}
    assert n == 90 and delta == {"read.rows_gather": 90,
                                 "read.rows_byteloop": 0}


def test_a_library_from_other_source_is_never_loaded(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the library")
    here = os.path.join(native._native_dir(), "fastseq.cpp")
    shutil.copy(here, tmp_path / "fastseq.cpp")
    # a library left from an older source, without the one-pass reader
    old = tmp_path / "old.cpp"
    old.write_text('extern "C" long fs_read_chunk() { return 0; }\n')
    assert native._build(str(old), str(tmp_path / "_fastseq.so"))
    monkeypatch.setattr(native, "_native_dir", lambda: str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    lib = native.get_lib()
    assert lib is not None and hasattr(lib, "fs_read_encoded")
    built = native._lib_path(str(tmp_path / "fastseq.cpp"))
    assert os.path.exists(built) and os.path.basename(built) != "_fastseq.so"
    # another source, another name
    with open(tmp_path / "fastseq.cpp", "a") as f:
        f.write("// edited\n")
    assert native._lib_path(str(tmp_path / "fastseq.cpp")) != built


def test_cli_jplace_is_the_same_without_the_native_reader(tmp_path,
                                                          monkeypatch):
    tree, ref, qry = synth_files(str(tmp_path), n_taxa=12, sites=80,
                                 n_queries=24, seed=11)
    recs = list(fio.iter_fasta(qry))
    # duplicates, lower case and names with spaces, in one-line records
    recs = ([(f"read {i} of 24", s.lower() if i % 5 == 0 else s)
             for i, (_, s) in enumerate(recs)]
            + [("dup a", recs[2][1]), ("dup b", recs[7][1])])
    qry = _write(tmp_path / "reads.fasta", recs)
    args = ["--tree", tree, "--ref-msa", ref, "--query", qry, "--model", GTR,
            "--outdir", str(tmp_path / "out"), "--redo", "--device", "cpu",
            "--chunk-size", "8"]
    jplace = tmp_path / "out" / "epa_result.jplace"
    before = RECORDER.counts().get("read.rows_gather", 0)
    assert torch_main(args) == 0
    assert RECORDER.counts()["read.rows_gather"] - before == 26
    with_native = jplace.read_bytes()
    monkeypatch.setenv("EPA_NG_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.get_lib() is None
    assert torch_main(args) == 0
    assert jplace.read_bytes() == with_native
    assert b'"dup a"' in with_native
