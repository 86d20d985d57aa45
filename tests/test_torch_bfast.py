"""The port's ``-c/--bfast`` conversion and ``--rate-scalers`` against the
JAX package's CLI, f64 on the CPU, on ``synth_files`` data (the JAX
package's own ``test_bfast_convert_and_place`` reads reference data that
is not in the repository).

- ``-c`` writes the same bfast bytes in both packages;
- a query read from that file places as the same query read from the
  FASTA file, in both packages: the same jplace, but for the invocation
  line, whose query path differs;
- ``--rate-scalers on`` is parsed into ``Options.scaling``, which neither
  package reads (the port keeps per-(rate, site) log-scale accumulators
  always): its jplace is the ``off`` run's.
"""

import json
import os

import pytest
import torch

from epa_ng_tpu.cli import main as jax_main
from epa_ng_tpu.utils.synth import synth_files

from epa_ng_tpu_torch.cli import build_parser, main as torch_main
from epa_ng_tpu_torch.cli import options_from_args
from epa_ng_tpu_torch.utils.options import NumericalScaling
from test_torch_engine import _placements, assert_same_placements

# one intra-op thread per test process: the suite runs in parallel
# workers, and a thread per core in each of them oversubscribes the
# CPU and slows the small tensor ops here by orders of magnitude
torch.set_num_threads(1)

GTR = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 20-taxon reference (120 sites) and 24 reads as files, and each
    package's ``-c`` conversion of the reads."""
    d = tmp_path_factory.mktemp("bfast")
    paths = synth_files(str(d), n_taxa=20, sites=120, n_queries=24, seed=3)
    out = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("torch", torch_main, ["--device", "cpu"])):
        outdir = str(d / f"convert_{name}")
        assert main(["-c", paths[2], "--outdir", outdir] + extra) == 0
        out[name] = os.path.join(outdir, "query.fasta.bfast")
    return d, paths, out


def _jplace(path):
    """The jplace document without its invocation line."""
    with open(path) as f:
        doc = json.load(f)
    doc["metadata"].pop("invocation")
    return doc


def _place(main, paths, query, outdir, extra=()):
    assert main(["--tree", paths[0], "--ref-msa", paths[1], "--query", query,
                 "--model", GTR, "--outdir", outdir, "--redo",
                 *extra]) == 0
    return os.path.join(outdir, "epa_result.jplace")


def test_bfast_bytes_match_jax(files):
    _, _, out = files
    with open(out["jax"], "rb") as a, open(out["torch"], "rb") as b:
        want, got = a.read(), b.read()
    assert len(got) > 0 and got == want


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_bfast_places_as_fasta(files, package):
    """Each package places the reads from its bfast file as from the
    FASTA file: the same jplace but for the invocation; and the two
    packages' bfast runs agree (assert_same_placements' 1e-6)."""
    d, paths, out = files
    main, extra = ((jax_main, ()) if package == "jax"
                   else (torch_main, ("--device", "cpu")))
    runs = {src: _place(main, paths, query, str(d / f"{package}_{src}"),
                        extra)
            for src, query in (("fasta", paths[2]), ("bfast", out[package]))}
    fasta, bfast = (_jplace(runs[k]) for k in ("fasta", "bfast"))
    assert len(bfast["placements"]) == 24
    assert bfast == fasta
    if package == "torch":
        jax_run = _place(jax_main, paths, out["jax"], str(d / "jax_cross"))
        assert_same_placements(_placements(jax_run),
                               _placements(runs["bfast"]))


def test_rate_scalers_on_changes_nothing(files):
    """``--rate-scalers on`` reaches Options.scaling and places as
    ``off``: neither package reads the option."""
    d, paths, _ = files
    for mode in ("on", "off"):
        args = build_parser().parse_args(["--rate-scalers", mode])
        assert options_from_args(args).scaling is NumericalScaling(mode)
    runs = [_jplace(_place(torch_main, paths, paths[2],
                           str(d / f"scalers_{mode}"),
                           ("--device", "cpu", "--rate-scalers", mode)))
            for mode in ("on", "off")]
    assert runs[0] == runs[1]
