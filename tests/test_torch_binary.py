"""Port parity of ``io/binary.py`` (``--dump-binary`` / ``-b``), f64 on the
CPU: the store's npz format (v3) is the JAX package's, so a store written
by either package loads in the other, and placing from it gives the loading
package's direct-run jplace (1e-6, as ``test_torch_engine``).

The round trips run with ``--no-pre-mask``: with premasking on, the JAX
package's ``-b`` drops the columns that are gaps in every query and then
refuses the reads' length, which evolved reads (whose windows never reach
the last column) always trigger. The port keeps those columns (the
store has them); ``test_binary_premask_keeps_every_column`` shows it.
"""

import os

import numpy as np
import pytest
import torch

from epa_ng_tpu.cli import main as jax_main
from epa_ng_tpu.utils.synth import evolved_dataset, write_fasta

from epa_ng_tpu_torch.cli import main as torch_main
from epa_ng_tpu_torch.io import binary as tbinary
from test_torch_engine import _placements, assert_same_placements

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)

GTR = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}"
MAINS = {"jax": jax_main,
         "torch": lambda argv: torch_main(argv + ["--device", "cpu"])}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("binary")
    tree, ref, qry, _ = evolved_dataset(n_taxa=24, sites=120, n_queries=48,
                                        seed=7)
    tpath = str(d / "tree.nwk")
    with open(tpath, "w") as f:
        f.write(tree.plain_newick() + "\n")
    rpath, qpath = str(d / "ref.fasta"), str(d / "q.fasta")
    write_fasta(ref, rpath)
    write_fasta(qry, qpath)
    return tpath, rpath, qpath


def _dump(pkg, files, model, outdir):
    tpath, rpath, _ = files
    assert MAINS[pkg](["--tree", tpath, "--ref-msa", rpath, "--model",
                       model, "--dump-binary", "--outdir", outdir,
                       "--redo"]) == 0
    return os.path.join(outdir, "epa_binary_file.npz")


def _place(pkg, files, outdir, model=None, store=None, extra=()):
    tpath, rpath, qpath = files
    src = (["-b", store] if store else
           ["--tree", tpath, "--ref-msa", rpath, "--model", model])
    assert MAINS[pkg](src + ["--query", qpath, "--outdir", outdir,
                             "--redo", *extra]) == 0
    return _placements(os.path.join(outdir, "epa_result.jplace"))


@pytest.mark.parametrize("model", [GTR, "HKY+I{0.2}+G4", "BIN+G2{1.2}"])
@pytest.mark.parametrize("writer,loader", [
    ("torch", "torch"), ("jax", "torch"), ("torch", "jax")])
def test_binary_store_round_trip(tmp_path, files, model, writer, loader):
    """A store dumped by ``writer`` and placed from by ``loader`` gives
    ``loader``'s direct run of the same files. The binary model places
    reads of 0/1 states (the DNA reads' A/C/G/T recoded)."""
    if model.startswith("BIN"):
        files = _recode_binary(files, tmp_path)
    store = _dump(writer, files, model, str(tmp_path / "dump"))
    flags = ("--no-pre-mask",)
    got = _place(loader, files, str(tmp_path / "b"), store=store,
                 extra=flags)
    want = _place(loader, files, str(tmp_path / "direct"), model=model,
                  extra=flags)
    assert len(got) == 48
    assert_same_placements(want, got)


def _recode_binary(files, tmp_path):
    """The files with A/G as 0 and C/T as 1 (gaps kept)."""
    out = []
    for path in files[1:]:
        with open(path) as f:
            text = f.read()
        body = "\n".join(
            ln if ln.startswith(">") else ln.translate(
                str.maketrans("AGCT", "0011"))
            for ln in text.splitlines())
        new = str(tmp_path / ("bin_" + os.path.basename(path)))
        with open(new, "w") as f:
            f.write(body + "\n")
        out.append(new)
    return (files[0], *out)


def test_binary_premask_keeps_every_column(tmp_path, files):
    """With premasking on (the default), ``-b`` in the port places the
    reads on the store's every column, each read over its own range, as
    the direct run does; the queries leave the last column a gap in all
    of them."""
    qpath = files[2]
    with open(qpath) as f:
        seqs = [ln for ln in f.read().splitlines() if not ln.startswith(">")]
    assert all(s[-1] == "-" for s in seqs)
    store = _dump("torch", files, GTR, str(tmp_path / "dump"))
    got = _place("torch", files, str(tmp_path / "b"), store=store)
    want = _place("torch", files, str(tmp_path / "direct"), model=GTR)
    assert_same_placements(want, got)


def test_binary_store_holds_the_jax_format(tmp_path, files):
    """The port's store carries the JAX package's keys, version and
    dtypes, and the model arrays round-trip through both readers."""
    from epa_ng_tpu.io import binary as jbinary
    store = _dump("torch", files, "HKY+I{0.2}+G4", str(tmp_path / "dump"))
    jstore = _dump("jax", files, "HKY+I{0.2}+G4", str(tmp_path / "jdump"))
    a, b = np.load(store), np.load(jstore)
    assert sorted(a.files) == sorted(b.files)
    assert int(a["format_version"]) == tbinary._MODEL_VERSION == 3
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        if a[k].dtype.kind in "fiu":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-10, atol=1e-300,
                                       err_msg=k)
        else:
            assert (a[k] == b[k]).all(), k
    mt, mj = tbinary._model_from_arrays(a), jbinary._model_from_arrays(b)
    for f in ("num_states", "alpha", "pinv", "num_ratecats", "rate_sym"):
        assert getattr(mt, f) == getattr(mj, f), f
    np.testing.assert_array_equal(mt.subst_rates, mj.subst_rates)
