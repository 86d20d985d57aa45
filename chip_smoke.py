"""Smoke run of the PyTorch/CUDA port (``epa_ng_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card: name and power limit from nvidia-smi, cross-checked against
   torch.cuda.get_device_name;
2. build the CUDA Newton kernel (csrc/blo_newton.cu) with nvcc, its five
   libraries (without and with the +I term, times K = 4, K = 20 and K = 20
   mixtures; ``blo_kernel.LIBRARIES``) side by side, and print each
   instantiation's registers and spill (the K = 20 cluster's and the
   K = 4 runtime-R shared-home ones must not spill, the latter within
   168 registers: 3 CTAs an SM);
3. hold the kernel against its plain PyTorch version on the card, in f32
   and in f64, for both call shapes (blocked: full stores + per-pair
   windows, with the sumtable in shared memory at the main path's width
   and at the widest window that keeps it there, and in device memory;
   per-pair: pre-sliced windows), on 4096 (query, edge) pairs drawn from
   the main path's reference state (each query's top preplacement
   candidates), bit for bit (logl max abs 0.0 against the f32 plain
   version, counters (K5) equal on every pair), with the pairs off the
   f64 plain version counted and the launch geometry as the library reads
   it from the runtime (threads, CTAs per SM, shared bytes, registers),
   checked against ``kernel_geometry``;
3b. the same for the +I kernel (K2 blocked, K4 per-pair) on the +I cell's
   pairs, with the share of in-span (pair, site) cells whose invariant
   term is > 0;
3c-3e. the same for the K = 20 instantiations: LG+G4{0.8} on the protein
   path's pairs, the four-component mixture on the mixture path's, and
   LG+I{0.2}+G4{0.8} on protein data with 20% invariant columns;
3f-3h. the same at 16 rate categories: GTR+G16 and GTR+I{0.2}+G16 (the K = 4
   runtime-R instantiation, whose pairs must also stay on the f64 plain
   version: 0 pairs off it in every shape and home) on the DNA and +I
   pairs, LG+G16{0.8} (the K = 20 cluster: two CTAs a pair, 8 rates
   each) on the protein pairs;
3i-3k. the K = 20 cluster once more: LG+I{0.2}+G16{0.8} on the protein +I
   pairs, and 16- and 32-component LG-derived mixtures (+G16{0.9},
   +G32{0.9}: clusters of 2 and 4 CTAs) on the mixture pairs, 2048 each;
4. the main path: ``epa_ng_tpu_torch.cli.main`` places 8192 evolved
   queries on a 512-taxon, 512-site tree under
   GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}, chunk 1024
   (the JAX package's bench headline shape), with the kernel's launch
   counts reset just before and read just after;
4b. the +I main path: the same shape with 20% of the columns made
   invariant (:func:`with_invariant_sites`) under the same model +I{0.2};
4c. the protein main path: 2048 LG-evolved queries on 256 taxa x 256
   sites under LG+G4{0.8}, chunk 512 (the JAX bench's ``aa`` shape);
4d. the mixture main path: 1024 random protein queries on 128 taxa x 256
   sites under four LG-derived components +G4{0.9}, chunk 512 (the JAX
   bench's ``mixture`` cell);
4e-4f. the headline data under GTR+G16{0.6} and the protein data under
   LG+G16{0.8}, each through its instantiation past 8 rates;
4g-4h. the protein +I data under LG+I{0.2}+G16{0.8} and the mixture data
   under the 16-component mixture, through the cluster; every main path
   must launch only its own instantiation, always with the counters, and
   never the torch Newton;
5. correctness on a small input: the card's f32 placements against the
   port's own f64 CPU run (plain paths) of the same files, under the main
   model, under +IC on data with invariant columns, under LG+G4, the
   mixture and LG+IC+G4 (all on seed 5), and past 8 rates under
   GTR+I{0.2}+R10 on data with invariant columns, under LG+G16 and under
   the 32-component mixture (a cluster of 4 CTAs); then GTR+G16 under the
   exact budgets, ``-G 0.1`` and ``--baseball-heur`` (top-k up to E, the
   budget not halved), through the K = 4 runtime-R instantiation only,
   and the same under GTR+G4, LG+G4 and the four-component mixture, each
   through its own instantiation;
5b. the flags no other phase runs on the card: ``--lookup-dtype bf16`` on
   the headline and protein data against phase 4's runs (top edge up to
   ties), ``--compute-dtype f64`` and ``--pallas off`` (the torch twin on
   the card, in f64 and in f32) against the small reference's f64 CPU run
   (1e-8 absolute; 1e-5 relative), ``--no-pre-mask`` on a small reference
   of its own, and a ``-c`` bfast file placed as its FASTA file is;
6. the DNA, +I, protein, mixture, GTR+G16 and LG+G16 main paths once more
   under torch.profiler (device time by kernel, busy share);
7. the rest of the one-card CLI, each path with the counts reset just
   before it and read just after: ``--opt-model`` from the generic GTR+G
   start on the JAX bench's opt_model cell cut to 64 taxa
   (``synth_dataset(64, 256, seed=37)``, f32), then 2048 reads placed on
   the optimized model through the kernel; ``--dump-binary`` on the
   headline, then ``-b``
   placing its 8192 reads from the store through the kernel;
   ``--raxml-blo`` on the headline, and BIN+G2{1.2} and
   GTGTR4{1.5/2.5/0.8/1.2/3.0/1.0}+FE+G4{0.8} at its shape (evolved
   over the "01" and the genotype alphabets), each through the torch
   Newton only (0 kernel launches, ``twin_launches`` > 0); the five on
   the small reference against the port's f64 CPU run (for
   ``--opt-model`` also the card's f32 optimum within OPT_EPSILON of the
   f64 one, on 32 taxa); and five L-BFGS steps of another
   ``--opt-model`` run under torch.profiler, after its first two, that
   run stopped after them;
8. ``--memsave`` on the JAX bench's memsave cell (``synth_dataset(2048,
   256, 2048, seed=19)``, 4,093 edges, GTR+G4, chunk 512): the resident
   run, then three budgets through the CLI, each with the counts reset
   just before and read just after: 0 (pure streaming: every pair on
   streamed windows through the kernel's per-pair shape), half the host
   store (the cached prefix's pairs through the blocked shape, the rest
   streamed) and 1000 GB (the fused path); then the cell with a fifth of
   its columns invariant under GTR+I{0.2}+G4, resident and at budget 0
   (the +I per-pair shape). Per run q/s, the cache, the host store, the
   bytes streamed, blocked and per-pair launches, and the device memory
   the built engine holds (its cache, and no more) and adds while it
   places (at most the resident run's temporaries plus its staging
   rings, which stay within depth x their largest request); every tier
   against the resident run and the tiers against each other (top edge
   up to ties on >= 99% and the best logl on shared top edges within
   MEMSAVE_LOGL_ABS; on every query 1e-5 relative against the resident
   run and the fused tier, MEMSAVE_LOGL_ABS between the exact-path
   tiers), and a control run at budget 0 with each streamed pair's mask
   one site late that these gates must refuse; then the small references
   under GTR+G4 and +I{0.2}+G4 (seed 5) at budget 0 and at a quarter of
   the store, and a ``--dump-binary`` -> ``-b --memsave`` round trip,
   against the f64 CPU run;
8b. ``--memsave`` past DNA G4 through the CLI on phase 4's data: LG+G4
   (budget 0 and half the store), LG+I{0.2}+G4 on the protein +I data,
   the four-component mixture, LG+G16 (0 and half), LG+I+G16, the
   16-component mixture, and GTR+G16 and GTR+I{0.2}+G16 on the headline's
   and the +I data's first 2048 reads: each only its own instantiation's
   per-pair shape at budget 0 (and the blocked one on the cached prefix
   at half), never the twin, against the cell's resident run (phase 4's,
   or one run here) by phase 8's gates at the cell's own tolerance (four
   f32 spacings at its largest |best logl|, ``f32_steps``); and the
   negative control again on the LG+G4 cell.

9. multi-device and multi-process placement on the one card, each path
   with the counts reset just before it and read just after: (a)
   ``--mesh 1x1`` through the CLI on the headline and the +I data (the
   JAX bench's mesh1x1 cell: the state built on the CPU, the sharded step
   with the blocked kernel on its shard), against phase 4's and 4b's runs
   (phase 8's gates: top edge up to ties on >= 99%, shared top edges
   within MEMSAVE_LOGL_ABS), with q/s and its ratio to the resident run,
   then the protein, LG+I+G4, mixture and LG+G16 cells (the K = 20
   blocked shapes on the shard) against their resident runs at their own
   tolerance;
   (b) the JAX bench's bigtree evolved cell (2048 taxa x 256 sites, 4,093
   edges, 2048 reads, seed 19, chunk 512) through the library with
   ``make_mesh(1, 4, [cuda:0] * 4)`` and ``make_mesh(2, 2, [cuda:0] *
   4)`` attached to a CPU-built engine, against the resident engine
   (every shard's blocked launches, never the twin, each shard's bytes
   and the pad edges), then a forced exact redo of 256 pairs through the
   mesh engine's ``_thorough`` (the per-pair shape on the host store's
   windows) against the resident engine's; then the LG+G16 cell on
   ``make_mesh(1, 4)`` the same way (the cluster's blocked shape on every
   shard, padded edges included, and its per-pair shape in the exact
   redo); (c) two CLI processes on the
   card joined by ``--distributed 127.0.0.1:PORT,2,RANK`` (gloo), even
   and with ``--adaptive-split``: the merged jplace holds every name
   once in input order, no shard is left, each rank launched the kernel
   and never the twin (its log's "Newton:" line), and the adaptive
   shards cover the file once; (d) the JAX CLI's refusals: a mesh of
   more cards than there are, a dp that is not a power of two, --mesh
   with --memsave, a bad --distributed spec. Every phase prints its
   seconds.

``python3 chip_smoke.py --fmad-ab`` runs phase 1 and then times the
kernel built with and without nvcc's mul+add contraction, in turns, on
16384 DNA and 4096 protein main-path pairs, with each build's agreement
with the plain version.

The last two lines are the card (nvidia-smi) and
``{"ok": true, "device": {...}}``; the line before them lists the kernels
with their launches, parity and times. Everything it writes goes under
``chiprun_out/chip_smoke/`` beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out", "chip_smoke")
FREQS = (0.27, 0.23, 0.24, 0.26)
MODEL = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}"
PINV_MODEL = ("GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+I{0.2}"
              "+G4{0.6}")
IC_MODEL = ("GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+IC"
            "+G4{0.6}")
# more than 8 rate categories: the K = 4 runtime-R instantiation, the
# K = 20 cluster
G16_MODEL = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G16{0.6}"
G16_PINV_MODEL = ("GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}"
                  "+I{0.2}+G16{0.6}")
R10_MODEL = ("GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+I{0.2}"
             "+R10{0.05/0.15/0.3/0.5/0.7/0.9/1.2/1.6/2.2/3.4}")
INVARIANT_SHARE = 0.2    # of the +I cells' columns
# protein (K = 20): the JAX bench's ``aa`` and ``mixture`` cells
# (bench.py:278-287, :398-423)
AA_MODEL = "LG+G4{0.8}"
AA_PINV_MODEL = "LG+I{0.2}+G4{0.8}"
AA_IC_MODEL = "LG+IC+G4{0.8}"
AA_G16_MODEL = "LG+G16{0.8}"
AA_PINV_G16_MODEL = "LG+I{0.2}+G16{0.8}"
MIXTURE = "SMOKEMIX4M"   # four LG-derived components, gamma-coupled
MIX_MODEL = MIXTURE + "+G4{0.9}"
# mixtures past 8 components (the K = 20 cluster: 2 and 4 CTAs a pair),
# register_mixture's recipe with 16 and 32 components
MIXTURE16, MIXTURE32 = "SMOKEMIX16M", "SMOKEMIX32M"
MIX16_MODEL = MIXTURE16 + "+G16{0.9}"
MIX32_MODEL = MIXTURE32 + "+G32{0.9}"
# parity pairs past 8 rates beyond the LG+G16 ones (4096)
CLUSTER_PAIRS = 2048
AA = "ARNDCQEGHILKMFPSTWYV"
# the paths the JAX package runs on its XLA twin, never on Pallas: binary
# (K = 2) and genotype (K = 10) models, over their alphabets in state order
# (the genotype one is pll_map_diploid10's: AA CC GG TT AC AG CG AT CT GT)
BIN_MODEL = "BIN+G2{1.2}"
BIN = "01"
GT_MODEL = "GTGTR4{1.5/2.5/0.8/1.2/3.0/1.0}+FE+G4{0.8}"
GT = "ACGTMRSWYK"
# --opt-model: the JAX bench's opt_model cell (bench.py:515-537), a generic
# start on random data, at (taxa, sites): cut from the cell's 256 taxa to
# 64 to pay for phase 9 within the script's time (on the H100 the
# 256-taxon run took 173.5 s of an 885.3-s script, and 128 taxa 134.6 s
# in 500 L-BFGS steps; PERF.md)
OPT_MODEL = "GTR+G"
OPT_CELL = (64, 256)
# small references at K = 20 (taxa, sites, queries, --no-heur queries):
# smaller than the DNA one's, as the f64 CPU run they are held against
# does 5x the rate-state lanes per site at RK = 80
AA_SMALL = (48, 200, 128, 32)
MIX_SMALL = (32, 160, 96, 24)
# LG+G16's (RK = 320): at AA_SMALL it took 117-138 s of the script, the
# most of any phase, on the H100 machines (PERF.md, PR 10); cut to keep
# the script well inside its time limit on a slower host
AA_G16_SMALL = (24, 160, 64, 16)
# the 32-component mixture's (RK = 640: 8x the f64 work a site of the
# four-component one's)
MIX32_SMALL = (16, 96, 32, 8)
# --memsave: the JAX bench's memsave cell (bench.py:473-512), (taxa,
# sites, queries, seed), placed in chunks of MEMSAVE_CHUNK
MEMSAVE_CELL = (2048, 256, 2048, 19)
MEMSAVE_CHUNK = 512
# random reads tie across more edges than the default --filter-max (7)
# keeps: every run of the cell keeps them all, so each run's top edge is
# in the other runs' lists whenever they scored it (as small_reference
# does for random data)
MEMSAVE_KEEP = ("--filter-max", "256")
# phase 8's logl tolerance: the cell's best logls are about -226,000,
# where f32 values lie 2^-6 = 0.015625 apart; runs of one host build, and
# the resident runs where they share the top edge, differ by at most two
# such steps (0.03125), and a site mask one site late on the streamed
# pairs (a control) by up to 1,905 (PERF.md §6). The tolerance is four
# such steps: f32_steps(226_000) = 4 x 2^(17 - 23) = 0.0625, and every
# other cell's (phases 8b and 9) is f32_steps at its own largest |best
# logl|, as it comes out (never rounded up)
MEMSAVE_LOGL_ABS = 0.0625
LOGL_STEPS = 4
# phase 8b: --memsave past DNA G4 on phase 4's cells, their reads cut to
# this many where a cell has more (the G16 headline and its +I copy)
MEMSAVE_WIDE_READS = 2048
# phase 5's --no-pre-mask reference (taxa, sites, queries, --no-heur)
NO_PREMASK_SIZE = (32, 200, 128, 32)
# the device memory a built --memsave engine may hold beyond its cache
# (the model's constants and character CLVs take kilobytes)
MEMSAVE_REST_SLACK_MB = 1.0
# what a --memsave run may add while placing beyond the resident run's
# temporaries and its own staging rings
MEMSAVE_PEAK_SLACK_MB = 16.0
# phase 9b: the JAX bench's bigtree evolved cell (taxa, sites, reads, seed)
# and its chunk; phase 9c: each rank's time limit
BIGTREE_CELL = (2048, 256, 2048, 19)
BIGTREE_CHUNK = 512
RANK_TIMEOUT_S = 300
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
LOGL_ABS_TOL = 0.05      # f32 sums over hundreds of sites, other order
LEN_Q90_TOL = 0.01       # lengths on logl-sharp pairs (test_pallas rule)
# the device's head start before a timed window: 1e8 clock cycles, 50 ms
# at the H100's 1.98 GHz boost clock, against ~5 ms for the host to launch
# 10 calls of the kernel's wrapper
HEAD_START_CYCLES = 100_000_000


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def f32_steps(pl, steps=LOGL_STEPS) -> float:
    """``steps`` f32 spacings at the largest |best logl| of the jplace
    placements ``pl`` (as :func:`read_jplace` gives them): what two f32
    runs of one cell that sum the same sites in other orders may differ
    by, where they share the top edge."""
    import numpy as np
    worst = max(abs(max(r["likelihood"] for r in rows))
                for rows in pl.values())
    return steps * float(np.spacing(np.float32(worst)))


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0 and res.stdout.strip(),
          f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list:
    """nvcc's -Xptxas -v output as one entry per kernel instantiation:
    "R<rates> <shared|device> <plain|pinv>: <n> regs, <b> B spill" for the
    DNA ones (``blo_newton_dna_kernel``; R0 is the runtime-R one, past 8
    rates), "K20 <single|mixture> <shared|device> <plain|pinv>[ cluster]:
    ..." for the K = 20 ones (rate count at run time; ``cluster`` past 8
    rates)."""
    import re
    out, cur = [], None
    home = lambda b: "device" if b == "1" else "shared"
    flavour = lambda b: "pinv" if b == "1" else "plain"
    for ln in log.splitlines():
        m = re.search(r"Function properties for \S*blo_newton_dna_kernel"
                      r"ILi(\d+)ELb([01])ELb([01])E", ln)
        if m:
            cur = f"R{m.group(1)} {home(m.group(2))} {flavour(m.group(3))}"
            spill = None
            continue
        m = re.search(r"Function properties for \S*blo_newton_team_kernel"
                      r"ILi(\d+)ELb([01])ELb([01])ELb([01])ELb([01])E", ln)
        if m:
            kind = "mixture" if m.group(2) == "1" else "single"
            cur = (f"K{m.group(1)} {kind} {home(m.group(3))} "
                   f"{flavour(m.group(4))}"
                   + (" cluster" if m.group(5) == "1" else ""))
            spill = None
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if cur and m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if cur and m:
            out.append(f"{cur}: {m.group(1)} regs, {spill} B spill")
            cur = None
    return sorted(out, key=lambda s: (s[0], int(s.split()[0][1:]), s))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of the device's work for one ``fn()`` over ``reps``
    runs, by CUDA events, after one warm-up run. The device first spins for
    HEAD_START_CYCLES (``torch.cuda._sleep``) while the host launches the
    runs behind it, so the window between the events holds device work
    only, however long the host takes to launch a call (a K = 4 call takes
    about as long to launch as to run); a run that waits on the device
    (the plain version's loop tests) starves it again from there on."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(HEAD_START_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def write_data(tree, ref, qry, outdir):
    """tree.nwk, ref.fasta and query.fasta in ``outdir``; their paths."""
    from epa_ng_tpu_torch.utils.synth import write_fasta
    os.makedirs(outdir, exist_ok=True)
    paths = tuple(os.path.join(outdir, n)
                  for n in ("tree.nwk", "ref.fasta", "query.fasta"))
    with open(paths[0], "w") as f:
        f.write(tree.plain_newick() + "\n")
    write_fasta(ref, paths[1])
    write_fasta(qry, paths[2])
    return paths


def make_data(n_taxa, sites, n_queries, seed, outdir, model=MODEL,
              alphabet="ACGT"):
    """Reference + queries evolved under ``model`` over ``alphabet``,
    written as tree/FASTA files."""
    from epa_ng_tpu_torch.utils.synth import evolved_dataset
    tree, ref, qry, true_edges = evolved_dataset(
        n_taxa=n_taxa, sites=sites, n_queries=n_queries, seed=seed,
        model_str=model, alphabet=alphabet)
    paths = write_data(tree, ref, qry, outdir)
    return (tree, ref, qry, true_edges), paths


def register_mixture(n=4, name=MIXTURE):
    """Register ``name`` in the port's matrix-mixture table: ``n``
    components built as the JAX bench builds its mixture cell's four (LG
    rates and frequencies times exp(0.35 randn), RandomState(11)),
    gamma-coupled."""
    import numpy as np

    from epa_ng_tpu_torch.models import aa_matrices
    rng = np.random.RandomState(11)
    lg_r, lg_f = aa_matrices.MATRICES["LG"]
    comps = []
    for _ in range(n):
        r = lg_r * np.exp(0.35 * rng.randn(190))
        f = lg_f * np.exp(0.35 * rng.randn(20))
        comps.append((r, f / f.sum()))
    aa_matrices.MIXTURES[name] = (comps, "gamma")


def make_random_data(n_taxa, sites, n_queries, seed, outdir):
    """Random protein reference + queries (``synth_dataset``, as the JAX
    bench's mixture cell; ``evolved_dataset`` takes one matrix only),
    written as files; no true edges."""
    from epa_ng_tpu_torch.utils.synth import AA, synth_dataset
    tree, ref, qry = synth_dataset(n_taxa=n_taxa, sites=sites,
                                   n_queries=n_queries, seed=seed,
                                   alphabet=AA)
    return (tree, ref, qry, None), write_data(tree, ref, qry, outdir)


def with_invariant_sites(ref, qry, freqs, share, seed, alphabet="ACGT"):
    """Copies of the alignments ``ref`` and ``qry`` in which a ``share`` of
    the columns (drawn with numpy from ``seed``) are invariant: every
    reference row holds one state there, drawn from ``freqs`` over
    ``alphabet`` (A, C, G, T by default; the 20 amino acids for protein),
    and every query's non-gap character in that column is set to the same
    state. Evolved data has few invariant columns of its own (none at 512
    taxa), so without this a +I model's invariant term is 0 everywhere.
    Works on either package's MSA. Returns (ref, qry, columns)."""
    import numpy as np
    as_arr = lambda s: np.frombuffer(s.sequence.encode(), np.uint8).copy()
    ref_rows = [(s.header, as_arr(s)) for s in ref]
    S = len(ref_rows[0][1])
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.choice(S, size=int(round(share * S)), replace=False))
    p = np.asarray(freqs, np.float64)
    states = np.frombuffer(alphabet.encode(), np.uint8)[
        rng.choice(len(alphabet), size=len(cols), p=p / p.sum())]
    gaps = np.frombuffer(b"-.?", np.uint8)

    def rebuild(msa, rows, query):
        out = type(msa)()
        for header, a in rows:
            if query:
                on = ~np.isin(a[cols], gaps)
                a[cols[on]] = states[on]
            else:
                a[cols] = states
            out.append(header, a.tobytes().decode())
        return out

    return (rebuild(ref, ref_rows, False),
            rebuild(qry, [(s.header, as_arr(s)) for s in qry], True), cols)


def make_pinv_data(data, seed, outdir, freqs=FREQS, alphabet="ACGT"):
    """The +I cell's data: ``data`` with INVARIANT_SHARE of its columns
    made invariant (states drawn from ``freqs``), written as files."""
    tree, ref, qry, true_edges = data
    ref, qry, _ = with_invariant_sites(ref, qry, freqs, INVARIANT_SHARE,
                                       seed, alphabet)
    return (tree, ref, qry, true_edges), write_data(tree, ref, qry, outdir)


def lg_freqs():
    from epa_ng_tpu_torch.models import aa_matrices
    return aa_matrices.MATRICES["LG"][1]


def main_path_pairs(data, device, n_pairs, model=MODEL):
    """(query, edge) pairs of the main path's Newton stage: each query's 4
    best preplacement candidates, sorted by range begin, on the engine's
    f32 reference state. With a +I model, also the invariant inputs."""
    import numpy as np
    import torch

    from epa_ng_tpu_torch.core.engine import PlacementEngine
    from epa_ng_tpu_torch.models import Model
    from epa_ng_tpu_torch.ops import blo_kernel as bk
    from epa_ng_tpu_torch.utils.options import Options

    tree, ref, qry, _ = data
    eng = PlacementEngine(tree, ref, Model.from_string(model),
                          Options(compute_dtype="f32"), device=device)
    n_q = n_pairs // 4
    ec = eng.encode_msa(_head(qry, n_q))
    codes, ranges = ec.codes, ec.ranges
    tQ, invq = eng._query_tensors_codes(codes)
    scores = eng.preplace(codes, ranges)
    top = np.argsort(-scores, axis=1, kind="stable")[:, :4]
    pq = np.repeat(np.arange(n_q), 4).astype(np.int32)
    pe = top.reshape(-1).astype(np.int32)
    order = np.argsort(ranges[pq, 0], kind="stable")
    pe, pq = pe[order], pq[order]
    pb = ranges[pq, 0].astype(np.int32)
    sp = ranges[pq, 1].astype(np.int32)
    d = lambda x: torch.as_tensor(np.asarray(x), device=eng.device)
    e_t, q_t, b_t, s_t = d(pe), d(pq), d(pb), d(sp)
    pinv = eng.model.pinv > 0
    return dict(eng=eng, tQ=tQ, e=e_t, q=q_t, b=b_t, s=s_t, sp=sp,
                orig=eng.blo.lengths[e_t.long()], pinv=pinv,
                invq=invq if pinv else None,
                omp=bk._omp(eng.consts, torch.float32) if pinv else None,
                skip=torch.zeros(len(pe), dtype=torch.float32,
                                 device=eng.device))


def _pinv_kw(pr, dt):
    """+I keyword arguments of blo_newton(_plain) in type ``dt``."""
    if not pr["pinv"]:
        return {}
    return dict(invq=pr["invq"].to(dt), ls=pr["eng"].blo.ls.to(dt),
                omp=pr["omp"].to(dt))


def plain_runs(pr, width, counters=False, f64=True):
    """The plain version on the pairs in f32 and (``f64``) in f64, on the
    same f32 inputs widened."""
    import torch

    from epa_ng_tpu_torch.ops import blo_kernel as bk
    eng, blo = pr["eng"], pr["eng"].blo
    ids = (pr["e"], pr["q"], pr["b"], pr["s"])
    out = []
    for dt in (torch.float32, torch.float64)[:2 if f64 else 1]:
        w = lambda t: t.to(dt)
        out.append(bk.blo_newton_plain(
            bk._kernel_scalars(eng.consts, dt), w(blo.tU), w(blo.tV),
            w(pr["tQ"]), *ids, w(pr["orig"]), w(pr["skip"]), width,
            counters=counters and dt == torch.float32, **_pinv_kw(pr, dt)))
    return out


def compare(k, p32, p64):
    """Kernel vs its plain version, pair by pair: logl (``max_abs_err``,
    against the plain version in f32: the same arithmetic in the same
    precision), and lengths by the 0.9 quantile over pairs whose logl
    agrees to 1e-3. Against the plain version in f64 (``*_f64``) the counts
    show where f32 itself is borderline: there another rounding of the same
    sums can take another Newton stop or rollback; ``off_f64`` lists up to
    8 such pairs (index, then logl, pendant and distal of the kernel and of
    the f64 plain version)."""
    import numpy as np
    n = lambda t: t.double().cpu().numpy()
    k0, a0, b0 = n(k[0]), n(p32[0]), n(p64[0])
    d32, d64 = np.abs(k0 - a0), np.abs(k0 - b0)
    sharp = d32 < 1e-3
    q90 = [float(np.quantile(np.abs(n(k[i]) - n(p32[i]))[sharp], 0.9))
           for i in (1, 2)]
    off = [[int(i)] + [float(n(t[j])[i]) for j in range(3) for t in (k, p64)]
           for i in np.nonzero(d64 > LOGL_ABS_TOL)[0][:8]]
    return dict(max_abs_err=float(d32.max()), off_f64=off,
                max_rel_err=float((d32 / np.abs(a0)).max()),
                max_abs_err_f64=float(d64.max()),
                pairs_off_f32=int((d32 > LOGL_ABS_TOL).sum()),
                pairs_off_f64=int((d64 > LOGL_ABS_TOL).sum()),
                plain_f32_off_f64=int((np.abs(a0 - b0) > LOGL_ABS_TOL).sum()),
                sharp_frac=float(sharp.mean()), pendant_q90=q90[0],
                distal_q90=q90[1])


def compare_counts(k_smooth, k_iters, p_smooth, p_iters):
    """The kernel's per-pair counters (K5) against the plain version's."""
    import numpy as np
    ks, ki = (np.asarray(t.cpu().numpy(), np.int64)
              for t in (k_smooth, k_iters))
    ps, pi = (np.asarray(t.cpu().numpy(), np.int64)
              for t in (p_smooth, p_iters))
    same = (ks == ps) & (ki == pi)
    return dict(counts_equal=float(same.mean()),
                max_abs_err_iters=int(np.abs(ki - pi).max()),
                mean_smoothings=float(ks.mean()),
                mean_newton_iters=float(ki.mean()))


def bound(sp, counts, R, has_pinv, counters=False, K=4, mixture=False):
    """The least time the card could take for these pairs' work (ms), and
    what bounds it: bytes over the memory rate or operations over the f32
    rate, both counted from this run's spans and the kernel's own executed
    smoothings and Newton iterations."""
    from epa_ng_tpu_torch.ops import blo_kernel as bk
    smooth, iters = (t.cpu().numpy() for t in counts)
    ops = bk.blo_op_count(sp, smooth, iters, R, has_pinv, K)
    nbytes = bk.blo_byte_count(sp, R, has_pinv, counters, K, mixture)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes > t_ops else "operations",
                flops=ops, bytes=nbytes)


def kernel_parity(data, device, n_pairs=4096, reps=3, model=MODEL):
    """Phases 3-3e: the kernel vs its plain version on the card, both call
    shapes, the blocked shape once more in the other sumtable homes (the
    widest window whose T stays in shared memory, and device memory), the
    kernel's counters and its launch geometry; with a +I ``model`` the +I
    kernel on data whose invariant term bites."""
    import numpy as np
    import torch

    from epa_ng_tpu_torch.ops import blo_kernel as bk

    pr = main_path_pairs(data, device, n_pairs, model)
    eng, blo, tQ = pr["eng"], pr["eng"].blo, pr["tQ"]
    S = eng.num_sites
    sp, e_t, q_t, b_t, s_t = pr["sp"], pr["e"], pr["q"], pr["b"], pr["s"]
    orig, pinv = pr["orig"], pr["pinv"]
    Wk = bk.kernel_width(sp)
    R = int(eng.consts.rates.shape[0])
    RK, Kq = blo.tU.shape[1], tQ.shape[1]
    K = int(eng.consts.A.shape[-1])
    mix = eng.consts.A.ndim == 3
    shape = dict(K=K, mixture=mix)
    cuda = device == "cuda"
    inv_kw = dict(invq=pr["invq"], ls=blo.ls) if pinv else {}
    res = {}

    # --- blocked call shape (the fused step's and the exact path's)
    site = torch.arange(S, device=eng.device)
    full = ((site[None] >= b_t[:, None])
            & (site[None] < (b_t + s_t)[:, None]))
    ls_sum = (full.float() * blo.ls[e_t.long()]).sum(1)
    blocked = lambda w, counters=False: bk.blo_optimize_batch_kernel_blocked(
        eng.consts, blo.tU, blo.tV, tQ, e_t, q_t, b_t, s_t, orig, ls_sum, w,
        counters=counters, **inv_kw)
    p32, p64 = plain_runs(pr, Wk, counters=True)
    shift = lambda p: (p[0] + ls_sum.to(p[0].dtype), p[1], p[2])
    kout = blocked(Wk, counters=True)
    r = compare((kout[0], kout[1], kout[3]), shift(p32), shift(p64))
    r.update(compare_counts(kout[6], kout[7], p32[5], p32[6]))
    r.update(bound(sp, kout[6:], R, pinv, **shape))
    r["ms"] = cuda_ms(lambda: blocked(Wk), reps) if cuda else None
    # the kernel's call alone, without the wrapper's tables and epilogue
    args, _ = _kernel_args(pr)
    r["kernel_call_ms"] = (cuda_ms(lambda: bk.blo_newton(
        *args, **_pinv_kw(pr, torch.float32)), reps) if cuda else None)
    r["plain_ms"] = (cuda_ms(lambda: plain_runs(pr, Wk, f64=False), 1)
                     if cuda else None)
    r.update(pairs=len(sp), width=Wk, mean_span=float(sp.mean()))
    res["blocked"] = r
    if pinv:
        # the invariant term over the in-span (pair, site) cells
        pv = torch.exp(pr["invq"][q_t.long()] - blo.ls[e_t.long()])[full]
        res["pv"] = dict(share_positive=float((pv > 0).float().mean()),
                         share_inf=float(torch.isinf(pv).float().mean()),
                         max=float(pv[torch.isfinite(pv)].max()))
    else:
        # K5: the counted launch against the plain version with counters
        kc = dict(compare((kout[0], kout[1], kout[3]), shift(p32),
                          shift(p64)))
        kc.update(compare_counts(kout[6], kout[7], p32[5], p32[6]))
        kc.update(bound(sp, kout[6:], R, pinv, counters=True, **shape))
        kc["ms"] = (cuda_ms(lambda: blocked(Wk, counters=True), reps)
                    if cuda else None)
        kc["plain_ms"] = (cuda_ms(lambda: plain_runs(pr, Wk, counters=True,
                                                     f64=False), 1)
                          if cuda else None)
        res["counted"] = kc

    # --- blocked again in the other homes: T in shared memory at the
    # widest window that keeps it there, and in device memory past it (the
    # same pairs in a wider stride, so the same plain results)
    Ws = bk.max_shared_sites(RK, pinv, K, mix)
    for home, w in (("blocked_widest_shared", Ws),
                    ("blocked_device_memory", Ws + 32)):
        kout = blocked(w, counters=True)
        r = compare((kout[0], kout[1], kout[3]), shift(p32), shift(p64))
        r.update(compare_counts(kout[6], kout[7], p32[5], p32[6]))
        r["ms"] = cuda_ms(lambda: blocked(w), reps) if cuda else None
        r["width"] = w
        res[home] = r
    if cuda:
        # the main path's launch geometry as the library reads it from the
        # runtime, against kernel_geometry's at the registers ptxas gave
        # (the clusters the card holds at once are the runtime's alone)
        geo = bk.blo_newton.team_geometry(K, R, Wk, mix, pinv)
        pred = bk.kernel_geometry(K, R, Wk, mix, pinv, regs=geo["regs"])
        check(all(geo[k] == pred[k] for k in geo if k in pred),
              f"K = {K} geometry {geo} is not the predicted {pred}")
        check(geo["active_clusters"] >= 1,
              f"K = {K}: the card holds no cluster of {geo['cluster']}")
        res["geometry"] = geo

    # --- per-pair call shape (pre-sliced windows)
    W = 64
    while W < int(sp.max()):
        W *= 2
    W = min(W, S)
    wb = torch.clamp(b_t, max=S - W).long()
    idx = wb[:, None] + torch.arange(W, device=eng.device)[None]
    rk = torch.arange(RK, device=eng.device)[None, :, None]
    kq = torch.arange(Kq, device=eng.device)[None, :, None]
    e_l, q_l = e_t.long(), q_t.long()
    tu = blo.tU[e_l[:, None, None], rk, idx[:, None, :]]
    tv = blo.tV[e_l[:, None, None], rk, idx[:, None, :]]
    tq = tQ[q_l[:, None, None], kq, idx[:, None, :]]
    lw = blo.ls[e_l[:, None], idx]
    iv = (pr["invq"][q_l[:, None], idx] if pinv
          else torch.full_like(lw, -torch.inf))
    local = (b_t - wb).long()
    w = torch.arange(W, device=eng.device)
    mask = ((w[None] >= local[:, None])
            & (w[None] < (local + s_t)[:, None])).float()
    per_pair = lambda counters=False: bk.blo_optimize_batch_kernel(
        eng.consts, tu, tv, tq, lw, mask, orig, iv, has_pinv=pinv,
        counters=counters)
    kout = per_pair(counters=True)
    lw_sum = (mask * lw).sum(1)
    r = compare((kout[0], kout[1], kout[3]),
                *[(p[0] + lw_sum.to(p[0].dtype), p[1], p[2])
                  for p in (p32, p64)])
    r.update(compare_counts(kout[6], kout[7], p32[5], p32[6]))
    r.update(bound(sp, kout[6:], R, pinv, **shape))
    r["ms"] = cuda_ms(per_pair, reps) if cuda else None
    ids = torch.arange(len(sp), dtype=torch.int32, device=eng.device)
    pinv_pp = (dict(invq=iv, ls=lw, omp=pr["omp"]) if pinv else {})
    r["plain_ms"] = (cuda_ms(lambda: bk.blo_newton_plain(
        bk._kernel_scalars(eng.consts, torch.float32), tu, tv, tq, ids, ids,
        local, s_t, orig, pr["skip"], W, **pinv_pp), 1) if cuda else None)
    r["width"] = W
    res["per_pair"] = r
    del eng, pr
    return res


def _timed_in_turns(builds, args, rounds, reps):
    """Times of each build of the kernel (a dict of callables) on the same
    arguments, taken in turns within this call (A B B A ...)."""
    keys = list(builds)
    ms = {k: [] for k in keys}
    for r in range(rounds):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            ms[k].append(cuda_ms(lambda: builds[k](*args), reps))
    return ms


def _kernel_args(pr):
    """blo_newton's arguments for a main path's pairs at their width."""
    from epa_ng_tpu_torch.ops import blo_kernel as bk
    eng, blo = pr["eng"], pr["eng"].blo
    Wk = bk.kernel_width(pr["sp"])
    tables = bk._kernel_scalars(eng.consts, blo.tU.dtype)
    return (tables, blo.tU, blo.tV, pr["tQ"], pr["e"], pr["q"], pr["b"],
            pr["s"], pr["orig"], pr["skip"], Wk), Wk


def fmad_ab(cases, rounds=3, reps=20):
    """The kernel built with and without nvcc's mul+add contraction (FMA),
    on each case's main-path pairs (``cases``: name -> (data, model,
    pairs)): times taken in turns within this call, and each build's
    agreement with the plain version in f32 and in f64."""
    from concurrent.futures import ThreadPoolExecutor

    from epa_ng_tpu_torch.ops import blo_kernel as bk

    builds = {fmad: bk._BloNewton(fmad=fmad) for fmad in (False, True)}
    with ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(k.build_all) for k in builds.values()]
        try:
            for fut in futs:
                fut.result()
        except RuntimeError as e:
            raise SmokeFailure(str(e)) from e
    res = {}
    for name, (data, model, n_pairs) in cases.items():
        pr = main_path_pairs(data, "cuda", n_pairs, model)
        args, Wk = _kernel_args(pr)
        p32, p64 = plain_runs(pr, Wk)
        out = {}
        for fmad, k in builds.items():
            kout = k(*args)
            out[f"fmad_{fmad}"] = compare((kout[0], kout[1], kout[2]), p32,
                                          p64)
        ms = _timed_in_turns({f"fmad_{f}": k for f, k in builds.items()},
                             args, rounds, reps)
        for key, t in ms.items():
            out[key]["ms"] = t
        out.update(pairs=n_pairs, width=Wk, reps_per_time=reps)
        res[name] = out
        del pr
    return res


def _head(msa, n):
    from epa_ng_tpu_torch.io.fasta import MSA
    out = MSA()
    for i, s in enumerate(msa):
        if i >= n:
            break
        out.append(s.header, s.sequence)
    return out


def read_jplace(path):
    with open(path) as f:
        doc = json.load(f)
    fields = doc["fields"]
    out = {}
    for p in doc["placements"]:
        rows = [dict(zip(fields, r)) for r in p["p"]]
        for n in p["n"]:
            out[n] = rows
    return out


def run_cli(paths, outdir, device, chunk, extra=(), model=MODEL,
            binary=None):
    """``epa_ng_tpu_torch.cli.main`` on (tree, reference, query) files; a
    query of None runs without one (``--dump-binary``), and ``binary``
    loads that CLV store (``-b``) in place of the tree and reference."""
    from epa_ng_tpu_torch import cli
    src = (["-b", binary] if binary else
           ["--tree", paths[0], "--ref-msa", paths[1], "--model", model])
    qry = ["--query", paths[2]] if paths[2] else []
    argv = src + qry + ["--outdir", outdir, "--redo", "--chunk-size",
                        str(chunk), "--device", device, *extra]
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli.main returned {rc} on {device}")
    return dict(cli.LAST_RUN_STATS), wall


def main_path(paths, n_queries, true_edges, device, model=MODEL,
              name="main", chunk=1024, extra=(), binary=None):
    """Phases 4-4f and 7: the CLI over the full shape; the kernel's launch
    counts set to 0 just before and read just after, and the calls of the
    torch Newton (``ops.newton.blo_optimize_batch``) counted in the run.
    ``extra`` flags and a ``binary`` store go to :func:`run_cli`."""
    import numpy as np

    from epa_ng_tpu_torch.ops import newton
    from epa_ng_tpu_torch.ops.blo_kernel import blo_newton
    outdir = os.path.join(OUT, name)
    twin, twin_calls = newton.blo_optimize_batch, []

    def counted_twin(*a, **k):
        twin_calls.append(1)
        return twin(*a, **k)

    newton.blo_optimize_batch = counted_twin
    try:
        blo_newton.reset_counts()
        stats, wall = run_cli(paths, outdir, device, chunk=chunk,
                              model=model, extra=extra, binary=binary)
        counts = blo_newton.counts()
    finally:
        newton.blo_optimize_batch = twin
    pl = read_jplace(os.path.join(outdir, "epa_result.jplace"))
    check(len(pl) == n_queries,
          f"{name}: jplace places {len(pl)} of {n_queries} queries")
    vals = np.array([[r["likelihood"], r["like_weight_ratio"],
                      r["pendant_length"], r["distal_length"]]
                     for rows in pl.values() for r in rows])
    check(np.isfinite(vals).all(), f"{name}: non-finite values in the jplace")
    check(all(len(rows) >= 1 for rows in pl.values()),
          f"{name}: empty placement")
    best = np.array([pl[f"Q{i}"][0]["edge_num"] for i in range(n_queries)])
    pairs = max(stats["newton_pairs"], 1)
    stats.update(cli_wall_s=wall, **counts, twin_calls=len(twin_calls),
                 qps=stats["reads"] / stats["placing_s"],
                 top_is_true_edge=(None if true_edges is None else
                                   float((best == true_edges).mean())),
                 mean_smoothings=stats["newton_smoothings"] / pairs,
                 mean_newton_iters=stats["newton_iters"] / pairs)
    return stats


def agreement(a, b, tol, absolute=False):
    """Run ``a``'s jplace placements against run ``b``'s: the share of
    queries whose top edge is ``b``'s top edge, the share whose top edge
    ``b`` scores within ``tol`` (relative, or ``absolute``) of its own best
    (short reads often tie exactly between edges that meet at a node), and
    the largest relative and absolute differences of the best logl, over
    every query and over the queries whose top edge both runs share."""
    import numpy as np
    best = lambda rows: max(r["likelihood"] for r in rows)
    same = [a[q][0]["edge_num"] == b[q][0]["edge_num"] for q in a]
    diff = [abs(best(a[q]) - best(b[q])) for q in a]
    rel = [d / abs(best(b[q])) for d, q in zip(diff, a)]

    def agrees(q):
        ll = {r["edge_num"]: r["likelihood"] for r in b[q]}
        top = ll.get(a[q][0]["edge_num"], -np.inf)
        return top >= best(b[q]) - (tol if absolute
                                    else tol * abs(best(b[q])))

    shared = lambda xs: max([x for x, s in zip(xs, same) if s], default=0.0)
    return dict(
        top_edge_identical=float(np.mean(same)),
        top_edge_up_to_ties=float(np.mean([agrees(q) for q in a])),
        max_rel_best_logl=max(rel), max_rel_best_logl_same_top=shared(rel),
        max_abs_best_logl=max(diff), max_abs_best_logl_same_top=shared(diff))


def small_reference(device, model=MODEL, invariant_share=0.0, name="small",
                    alphabet="ACGT", freqs=FREQS, random_data=False,
                    size=(64, 200, 256, 64), seed=5, data_model=None,
                    extra=(), binary=False, prepared=None):
    """Phase 5: the card's f32 runs against the port's f64 CPU runs of the
    same files: the default heuristic on all queries, and --no-heur (every
    pair through the exact path's kernel slabs) on the first few. Short
    reads often tie exactly between edges that meet at a node, so a top
    edge counts as agreeing when the f64 run scores it within 1e-5 relative
    of its own best; the best logl itself must agree everywhere. The data
    are evolved under ``model`` over ``alphabet`` (``random_data``: random,
    as for a mixture) at ``size`` = (taxa, sites, queries, --no-heur
    queries); with an ``invariant_share`` that share of the columns is
    made invariant (states from ``freqs``); ``seed`` makes the data.
    ``data_model`` evolves the data under another model than the default
    one of its alphabet (binary, genotype); ``prepared`` = ((tree, ref,
    qry), paths) takes given data instead. ``extra`` flags go to every
    run; with ``binary`` each device first dumps the CLV store
    (``--dump-binary``) and then places from it (``-b``). Returns the
    agreement per configuration, the kernel's launch counts over the
    card's runs and the calls of the torch twin they made (and, under
    ``--memsave``, the host store's MB)."""
    from epa_ng_tpu_torch.ops.blo_kernel import blo_newton
    from epa_ng_tpu_torch.utils.synth import write_fasta
    outdir = os.path.join(OUT, name)
    n_taxa, sites, n_queries, n_few = size
    if prepared is not None:
        (tree, ref, qry, _), paths = prepared
    elif random_data:
        (tree, ref, qry, _), paths = make_random_data(n_taxa, sites,
                                                      n_queries, seed, outdir)
    else:
        (tree, ref, qry, _), paths = make_data(
            n_taxa, sites, n_queries, seed, outdir,
            model=data_model or (MODEL if alphabet == "ACGT" else AA_MODEL),
            alphabet=alphabet)
    if invariant_share:
        ref, qry, _ = with_invariant_sites(ref, qry, freqs, invariant_share,
                                           seed, alphabet)
        paths = write_data(tree, ref, qry, outdir)
    os.makedirs(outdir, exist_ok=True)
    few = os.path.join(outdir, f"query{n_few}.fasta")
    write_fasta(_head(qry, n_few), few)
    # random reads tie across more edges than the default --filter-max (7)
    # keeps, and each run would keep another 7 of the tied edges: keep
    # them all, so the f64 run scores whichever the card put on top
    keep = ("--filter-max", "256") if random_data else ()
    stores = {}
    if binary:
        for dev in (device, "cpu"):
            d = os.path.join(outdir, f"dump_{dev}")
            run_cli((paths[0], paths[1], None), d, dev, chunk=256,
                    extra=("--dump-binary",), model=model)
            stores[dev] = os.path.join(d, "epa_binary_file.npz")
    out = {}
    twin = 0
    blo_newton.reset_counts()
    for cfg, qpath, flags, n in (("dyn", paths[2], (), n_queries),
                                 ("noheur", few, ("--no-heur",), n_few)):
        runs = []
        for dev in (device, "cpu"):
            d = os.path.join(outdir, f"{cfg}_{dev}")
            st, _ = run_cli((paths[0], paths[1], qpath), d, dev, chunk=256,
                            extra=flags + keep + tuple(extra), model=model,
                            binary=stores.get(dev))
            if dev == device:
                twin += st["twin_launches"]
                if "memsave_host_mb" in st:
                    out["memsave_host_mb"] = st["memsave_host_mb"]
            runs.append(read_jplace(os.path.join(d, "epa_result.jplace")))
        a, b = runs
        check(a.keys() == b.keys() and len(a) == n,
              f"{name} {cfg} run lost queries")
        out[cfg] = ag = agreement(a, b, 1e-5)
        check(ag["top_edge_up_to_ties"] >= 0.99,
              f"{name} {cfg}: top placements agree (up to ties) on "
              f"{ag['top_edge_up_to_ties']:.3f} < 0.99")
        check(ag["max_rel_best_logl"] <= 1e-5, f"{name} {cfg}: best logl "
              f"rel diff {ag['max_rel_best_logl']:.3g}")
    out["launches"] = blo_newton.counts()
    out["twin_launches"] = twin
    return out


EXACT_BUDGETS = {"fixed": ("-G", "0.1"), "baseball": ("--baseball-heur",)}


def exact_budgets(device, heuristics=EXACT_BUDGETS, model=G16_MODEL,
                  size=(64, 200, 256), seed=5, name="exact_budgets",
                  alphabet="ACGT", random_data=False, family="k4_launches",
                  past8=True):
    """Phase 5's exact budgets: ``-G`` (fixed) and ``--baseball-heur`` give
    the fused step exact budgets (ceil(G E) and 40 candidates a query,
    not halved), so under ``model`` the kernel runs at top-k up to E
    (GTR+G16: the K = 4 runtime-R instantiation; GTR+G4, LG+G4, the
    mixture). Each heuristic's run on ``device`` is held against the
    port's f64 CPU run of the same files (``size`` = taxa, sites, queries;
    ``seed``; evolved over ``alphabet``, or ``random_data`` as for a
    mixture, whose ties every run keeps): top edge up to ties on >= 99%,
    best logl within 1e-5 relative; on the card only launches of the
    ``family`` instantiation (past 8 rates iff ``past8``), and no
    torch-twin call. Returns per heuristic the agreement, the launches
    and the twin's calls."""
    from epa_ng_tpu_torch.ops.blo_kernel import blo_newton
    outdir = os.path.join(OUT, name)
    n_taxa, sites, n_queries = size
    if random_data:
        _, paths = make_random_data(n_taxa, sites, n_queries, seed,
                                    os.path.join(outdir, "data"))
    else:
        _, paths = make_data(n_taxa, sites, n_queries, seed,
                             os.path.join(outdir, "data"),
                             model=MODEL if alphabet == "ACGT" else AA_MODEL,
                             alphabet=alphabet)
    keep = MEMSAVE_KEEP if random_data else ()
    out = {}
    for key, flags in heuristics.items():
        runs = {}
        for dev in (device, "cpu"):
            d = os.path.join(outdir, f"{key}_{dev}")
            blo_newton.reset_counts()
            st, _ = run_cli(paths, d, dev, chunk=256, extra=flags + keep,
                            model=model)
            if dev == device:
                counts, twin = blo_newton.counts(), st["twin_launches"]
            runs[dev] = read_jplace(os.path.join(d, "epa_result.jplace"))
        a, b = runs[device], runs["cpu"]
        check(a.keys() == b.keys() and len(a) == n_queries,
              f"{name} {key}: a run lost queries")
        if device == "cuda":
            check(counts["launches"] > 0 and twin == 0
                  and counts[family] == counts["launches"]
                  and counts["past8_launches"] == (counts["launches"]
                                                   if past8 else 0),
                  f"{name} {key}: launches {counts}, twin {twin}")
        ag = agreement(a, b, 1e-5)
        check(ag["top_edge_up_to_ties"] >= 0.99,
              f"{name} {key}: top placements agree (up to ties) "
              f"on {ag['top_edge_up_to_ties']:.3f} < 0.99")
        check(ag["max_rel_best_logl"] <= 1e-5, f"{name} {key}: "
              f"best logl rel diff {ag['max_rel_best_logl']:.3g}")
        out[key] = dict(agreement=ag, launches=counts["launches"],
                        twin_launches=twin)
    return out


# phase 5's exact budgets past GTR+G16: exact_budgets' arguments per cell;
# size (taxa, sites, queries): GTR+G4 at GTR+G16's taxa and sites, LG+G4
# and the mixture at the K = 20 small references' (48 x 200; the
# mixture's 32 x 160), each with fewer reads (the f64 CPU runs take most
# of the time)
EXACT_CELLS = {
    "gtr_g4": dict(model=MODEL, size=(64, 200, 128), name="exact_gtr_g4",
                   past8=False),
    "lg_g4": dict(model=AA_MODEL, size=(48, 200, 32), name="exact_lg_g4",
                  alphabet=AA, family="k20_launches", past8=False),
    "mixture": dict(model=MIX_MODEL, size=(32, 160, 24), name="exact_mix",
                    random_data=True, family="mixture_launches",
                    past8=False)}


def exact_budgets_wide(device) -> dict:
    """Phase 5's exact budgets past GTR+G16 (EXACT_CELLS): GTR+G4 (K = 4,
    R = 4), LG+G4 (K = 20) and the four-component mixture on random
    reads, each under ``-G 0.1`` and ``--baseball-heur`` against the f64
    CPU run."""
    return {k: exact_budgets(device, **kw) for k, kw in EXACT_CELLS.items()}


def _jplace_doc(path):
    """A jplace document without its invocation line."""
    with open(path) as f:
        doc = json.load(f)
    doc["metadata"].pop("invocation")
    return doc


def lookup_bf16(device, base, paths, n, true_edges, model, family,
                chunk) -> dict:
    """Phase 5b: ``--lookup-dtype bf16`` (the residual preplacement GEMM in
    bf16, ranking only) on phase 4's run ``base`` of these files, against
    that run with the f32 table: only the ``family`` instantiation, and
    the top edge up to ties (f32_steps of the f32 run) on >= 99% of the
    queries; logl is not compared."""
    st = main_path(paths, n, true_edges, device, model=model,
                   name=f"{base}_bf16", chunk=chunk,
                   extra=("--lookup-dtype", "bf16"))
    check_main(f"{base} --lookup-dtype bf16", st, family)
    pl = {k: read_jplace(os.path.join(OUT, k, "epa_result.jplace"))
          for k in (base, f"{base}_bf16")}
    tol = f32_steps(pl[base])
    ag = agreement(pl[f"{base}_bf16"], pl[base], tol, absolute=True)
    check(ag["top_edge_up_to_ties"] >= 0.99,
          f"{base} --lookup-dtype bf16: top edge up to ties "
          f"{ag['top_edge_up_to_ties']:.4f} < 0.99 against the f32 table")
    return dict(qps=st["qps"], tie_tol=tol, agreement=ag)


TWIN_FLAGS = {"f64": (("--compute-dtype", "f64"), 1e-8, True),
              "pallas_off": (("--pallas", "off"), 1e-5, False)}


def small_paths() -> tuple:
    """The files of phase 5's GTR+G4 small reference (``small_reference``'s
    default run): tree, reference and query."""
    return tuple(os.path.join(OUT, "small", f)
                 for f in ("tree.nwk", "ref.fasta", "query.fasta"))


def twin_on_card(device, key) -> dict:
    """Phase 5b: the torch twin on the card, on phase 5's small reference
    (its files and its f64 CPU run): ``--compute-dtype f64`` against the
    f64 CPU run within ROADMAP's f64 tolerance, 1e-8 absolute, and
    ``--pallas off`` (f32) by the small references' 1e-5 relative; every
    query's best logl, and the top edge up to ties at that tolerance; no
    kernel launch."""
    from epa_ng_tpu_torch.ops.blo_kernel import blo_newton
    flags, tol, absolute = TWIN_FLAGS[key]
    d = os.path.join(OUT, f"small_{key}_{device}")
    blo_newton.reset_counts()
    st, _ = run_cli(small_paths(), d, device, chunk=256, extra=flags)
    counts = blo_newton.counts()
    check(counts["launches"] == 0 and st["twin_launches"] > 0,
          f"{key} on {device}: kernel launches {counts['launches']}, "
          f"twin launches {st['twin_launches']}")
    ag = agreement(read_jplace(os.path.join(d, "epa_result.jplace")),
                   read_jplace(os.path.join(OUT, "small", "dyn_cpu",
                                            "epa_result.jplace")),
                   tol, absolute=absolute)
    worst = ag["max_abs_best_logl" if absolute else "max_rel_best_logl"]
    check(ag["top_edge_up_to_ties"] >= 0.99 and worst <= tol,
          f"{key} on {device} against the f64 CPU run: {ag} (tolerance "
          f"{tol}, {'absolute' if absolute else 'relative'})")
    return dict(agreement=ag, twin_launches=st["twin_launches"],
                placing_s=st["placing_s"])


def no_pre_mask(device) -> dict:
    """Phase 5b: ``--no-pre-mask`` on a small reference of its own (both
    devices; :func:`small_reference`'s gates), through the kernel."""
    sm = small_reference(device, name="small_nopremask",
                         size=NO_PREMASK_SIZE, extra=("--no-pre-mask",))
    check(sm["launches"]["launches"] > 0 and sm["twin_launches"] == 0,
          f"--no-pre-mask small reference: launches {sm['launches']}, "
          f"twin launches {sm['twin_launches']}")
    return sm


def bfast_round_trip(device, paths) -> dict:
    """Phase 5b: ``-c`` converts the query file to bfast; placed from it
    on ``device``, the reads give the same jplace as from the FASTA file
    but for the invocation line."""
    from epa_ng_tpu_torch import cli
    d = os.path.join(OUT, "bfast")
    check(cli.main(["-c", paths[2], "--outdir", d]) == 0,
          "-c: the conversion failed")
    bfast = os.path.join(d, os.path.basename(paths[2]) + ".bfast")
    docs = {}
    for src, query in (("fasta", paths[2]), ("bfast", bfast)):
        out = os.path.join(d, f"place_{src}")
        run_cli((paths[0], paths[1], query), out, device, chunk=256)
        docs[src] = _jplace_doc(os.path.join(out, "epa_result.jplace"))
    check(docs["bfast"] == docs["fasta"] and docs["fasta"]["placements"],
          "-c: the bfast file places otherwise than the FASTA file")
    return dict(placements=len(docs["bfast"]["placements"]), identical=True)


def flags_phase(device, mains) -> dict:
    """Phase 5b: the CLI flags that no earlier phase runs on the card:
    ``--lookup-dtype bf16`` on phase 4's runs in ``mains`` (name -> its
    paths, reads, true edges, model, family, chunk), ``--compute-dtype
    f64`` and ``--pallas off`` on phase 5's small reference,
    ``--no-pre-mask``, and ``-c`` on the small reference's reads."""
    res = {f"{base}_bf16": lookup_bf16(device, base, *args)
           for base, args in mains.items()}
    for key in TWIN_FLAGS:
        res[key] = twin_on_card(device, key)
    res["no_pre_mask"] = no_pre_mask(device)
    res["bfast"] = bfast_round_trip(device, small_paths())
    return res


def explicit_gtr(model) -> str:
    """A GTR+G model's parameters as a model string at full precision
    (``Model.to_string`` keeps six digits and names free parameters only by
    their mode)."""
    num = lambda v: f"{float(v):.17g}"
    return (f"GTR{{{'/'.join(num(r) for r in model.subst_rates)}}}"
            f"+FU{{{'/'.join(num(f) for f in model.base_freqs)}}}"
            f"+G{model.num_ratecats}{{{num(model.alpha)}}}")


def small_opt_model(device, size=(32, 200, 256, 64), seed=5):
    """Phase 7f: ``--opt-model`` on the small reference. The optimizer
    (``core.evaluate.optimize_model``, which the CLI calls) runs on the
    card in f32 and on the CPU in f64 from the generic OPT_MODEL start; the
    card's optimum must lie within OPT_EPSILON log-units of the f64 one.
    Then the card-optimized tree and model, written out at full precision,
    go through :func:`small_reference`'s gates (the card's f32 placements
    against the port's f64 CPU run of the same files)."""
    import torch

    from epa_ng_tpu_torch.core.evaluate import OPT_EPSILON, optimize_model
    from epa_ng_tpu_torch.models import Model
    from epa_ng_tpu_torch.tree import Tree
    outdir = os.path.join(OUT, "small_opt")
    n_taxa, sites, n_queries, _ = size
    (tree, ref, qry, _), paths = make_data(n_taxa, sites, n_queries, seed,
                                           outdir)
    res, models, trees = {"paths": paths}, {}, {}
    for dev, dtype in ((device, torch.float32), ("cpu", torch.float64)):
        t = Tree.from_string(tree.plain_newick())
        m = Model.from_string(OPT_MODEL)
        st = {}
        t0 = time.perf_counter()
        optimize_model(t, ref, m, dtype=dtype, device=dev, stats=st)
        st.update(seconds=time.perf_counter() - t0, alpha=float(m.alpha))
        res[dev], models[dev], trees[dev] = st, m, t
    gap = abs(res[device]["final_logl"] - res["cpu"]["final_logl"])
    res["optimum_gap"] = gap
    check(gap <= OPT_EPSILON, f"--opt-model small reference: the card's f32 "
          f"optimum is {gap:.4f} from the f64 one (> {OPT_EPSILON})")
    opt_paths = write_data(trees[device], ref, qry,
                           os.path.join(outdir, "optimized"))
    opt_tree = Tree.from_file(opt_paths[0])
    res["placement"] = small_reference(
        device, model=explicit_gtr(models[device]), name="small_opt_placed",
        size=size, prepared=((opt_tree, ref, qry, None), opt_paths))
    return res


def profile_main(paths, device, model=MODEL, name="profiled", chunk=1024,
                 extra=()):
    """Phase 6: a main path once more under torch.profiler: device time by
    kernel and the device's busy share of the CLI run (reference build +
    placement; profiling adds host overhead, so the share is a lower bound
    on the unprofiled run's)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats, wall = run_cli(paths, os.path.join(OUT, name), device,
                              chunk=chunk, model=model, extra=extra)
    total_ms, top = device_time(prof)
    return dict(device_ms=total_ms, cli_wall_s=wall,
                busy_share=(total_ms / 1e3 / wall if total_ms else None),
                top_kernels=top)


def device_time(prof):
    """A profile's device time (ms) and its 8 largest entries [name, ms,
    count]: device-side events (kernels, copies) only, since the CPU ops
    that launched them carry the same device time again, and no user
    annotation (``torch.optim``'s ``Optimizer.step#...``), whose device
    span covers the kernels inside it."""
    from torch.autograd import DeviceType
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and dev_us(e) > 0
           and not getattr(e, "is_user_annotation", False)]
    top = sorted(evs, key=dev_us, reverse=True)[:8]
    return (sum(dev_us(e) for e in evs) / 1e3,
            [[e.key[:60], dev_us(e) / 1e3, e.count] for e in top])


class _WindowDone(Exception):
    """Raised out of the profiled ``--opt-model`` run once its window has
    been traced: the rest of the run is phase 7a's."""


def profile_opt_window(paths, device, skip=2, active=5):
    """Phase 7g: a ``--opt-model`` CLI run with torch.profiler on for
    ``active`` L-BFGS steps after the first ``skip``, stopped there: device
    time by kernel and the device's busy share over that window's wall
    time (the steps' objective evaluations, with and without the
    gradient, and the line searches between them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    lbfgs_step, n, wall = torch.optim.LBFGS.step, [0], []

    def step(self, closure):
        if n[0] == skip:
            torch.cuda.synchronize()
            prof.start()
            wall.append(time.perf_counter())
        out = lbfgs_step(self, closure)
        n[0] += 1
        if n[0] == skip + active:
            torch.cuda.synchronize()
            wall.append(time.perf_counter())
            prof.stop()
            raise _WindowDone
        return out

    torch.optim.LBFGS.step = step
    t0 = time.perf_counter()
    try:
        run_cli(paths, os.path.join(OUT, "profiled_opt"), device, chunk=1024,
                model=OPT_MODEL, extra=("--opt-model",))
    except _WindowDone:
        pass
    finally:
        torch.optim.LBFGS.step = lbfgs_step
    check(len(wall) == 2, f"--opt-model took {n[0]} L-BFGS steps, fewer "
          f"than the profiled window's {skip + active}")
    total_ms, top = device_time(prof)
    window_s = wall[1] - wall[0]
    check(total_ms < window_s * 1e3, f"--opt-model profile: {total_ms} ms "
          f"of device time in a {window_s} s window")
    return dict(steps=active, after_steps=skip, window_s=window_s,
                device_ms=total_ms, run_s=time.perf_counter() - t0,
                busy_share=(total_ms / 1e3 / window_s if total_ms else None),
                top_kernels=top)


def check_parity(tag, res):
    """Every call shape and home within the gates, and bit for bit (the
    plain version adds in the kernel's team order): logl max abs 0.0 and
    the counters equal on every pair."""
    for name, r in res.items():
        if name in ("pv", "geometry"):
            continue
        check(r["max_abs_err"] <= LOGL_ABS_TOL,
              f"{tag} {name}: logl max abs err {r['max_abs_err']}")
        check(r["max_abs_err"] == 0.0 and r["counts_equal"] == 1.0,
              f"{tag} {name}: not bit for bit (logl max abs "
              f"{r['max_abs_err']}, counters equal on "
              f"{r['counts_equal']:.4f})")
        check(max(r["pendant_q90"], r["distal_q90"]) <= LEN_Q90_TOL,
              f"{tag} {name}: length q90 {r['pendant_q90']}, "
              f"{r['distal_q90']}")


def parity_phase(tag, data, model, n_pairs=4096):
    """One parity phase on the card, printed and checked."""
    res = kernel_parity(data, "cuda", n_pairs=n_pairs, model=model)
    for k, v in res.items():
        print(f"{tag} {k}: " + json.dumps(v), flush=True)
    check_parity(tag, res)
    if "pv" in res:
        check(res["pv"]["share_positive"] > 0,
              f"{tag}: the invariant term is 0 on every in-span cell")
    return res


def check_main(tag, st, family, pinv=False, past8=False, cluster=False):
    """A main path launched the kernel's ``family`` instantiation and only
    it, every launch with the counters (with +I iff ``pinv``, at more than
    8 rate categories iff ``past8``, on clusters iff ``cluster``), and
    never ran the torch Newton."""
    check(st[family] > 0, f"{tag}: the {family} instantiation never ran")
    check(st[family] == st["launches"],
          f"{tag}: {st['launches'] - st[family]} launches of another "
          f"instantiation than {family}")
    check(st["pinv_launches"] == (st["launches"] if pinv else 0),
          f"{tag}: {st['pinv_launches']} of {st['launches']} launches "
          "with +I")
    check(st["past8_launches"] == (st["launches"] if past8 else 0),
          f"{tag}: {st['past8_launches']} of {st['launches']} launches "
          "past 8 rate categories")
    check(st["cluster_launches"] == (st["launches"] if cluster else 0),
          f"{tag}: {st['cluster_launches']} of {st['launches']} launches "
          "on clusters")
    check(st["counted_launches"] == st["launches"],
          f"{tag}: launched the kernel without its counters")
    check(st["twin_calls"] == 0,
          f"{tag}: the torch Newton ran {st['twin_calls']} times")


def check_twin(tag, st):
    """A path that the JAX package runs on its XLA twin ran the torch twin
    on the card, and never the kernel."""
    check(st["launches"] == 0,
          f"{tag}: the kernel was launched {st['launches']} times")
    check(st["twin_launches"] > 0, f"{tag}: the torch twin never ran")
    check(st["twin_launches"] == st["twin_calls"],
          f"{tag}: twin_launches {st['twin_launches']} but the twin was "
          f"called {st['twin_calls']} times")


def kernel_entry(name, replaces, launches, r, **extra):
    """One entry of the ``kernels`` line."""
    return {"name": name, "route": "cuda",
            "source": "epa_ng_tpu_torch/csrc/blo_newton.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, **extra}


def rest_of_cli(paths, n_queries, true_edges, lap) -> dict:
    """Phase 7: ``--opt-model`` (the JAX bench's opt_model cell, cut to
    OPT_CELL's 64 taxa, then 2048 reads placed on the optimized model
    through the kernel), ``--dump-binary`` and ``-b`` (the headline),
    ``--raxml-blo`` (the headline), binary and genotype models (the
    headline's shape), and the small-reference gates of all five against
    the port's f64 CPU run; ``lap(name)`` ends each part's seconds."""
    from epa_ng_tpu_torch.utils.synth import synth_dataset
    res = {}
    # 7a: --opt-model at OPT_CELL, then 2048 random reads
    t0 = time.perf_counter()
    n_taxa, sites = OPT_CELL
    tree, ref, qry = synth_dataset(n_taxa=n_taxa, sites=sites,
                                   n_queries=2048, seed=37)
    opaths = write_data(tree, ref, qry, os.path.join(OUT, "data_opt"))
    print(f"opt-model data: {n_taxa} taxa x {sites} sites, 2048 random "
          f"queries in {time.perf_counter() - t0:.2f} s", flush=True)
    st = main_path(opaths, 2048, None, "cuda", model=OPT_MODEL,
                   name="main_opt", extra=("--opt-model",))
    print("--opt-model main path: " + json.dumps(st), flush=True)
    check_main("--opt-model main path", st, "k4_launches")
    res["opt_model"] = st
    lap("7a")

    # 7b: --dump-binary, then -b: the headline's store and reads
    outdir = os.path.join(OUT, "dump")
    dst, dump_wall = run_cli((paths[0], paths[1], None), outdir, "cuda",
                             chunk=1024, extra=("--dump-binary",))
    store = os.path.join(outdir, "epa_binary_file.npz")
    st = main_path((None, None, paths[2]), n_queries, true_edges, "cuda",
                   name="main_b", binary=store)
    st.update(dump_s=dump_wall, dump_build_s=dst["build_s"],
              load_s=st["build_s"], store_mb=os.path.getsize(store) / 1e6)
    print("-b main path: " + json.dumps(st), flush=True)
    check_main("-b main path", st, "k4_launches")
    res["binary"] = st
    lap("7b")

    # 7c: --raxml-blo on the headline
    st = main_path(paths, n_queries, true_edges, "cuda", name="main_raxml",
                   extra=("--raxml-blo",))
    print("--raxml-blo main path: " + json.dumps(st), flush=True)
    check_twin("--raxml-blo main path", st)
    res["raxml_blo"] = st
    lap("7c")

    # 7d-7e: binary and genotype models at the headline's shape
    for key, model, alphabet in (("bin", BIN_MODEL, BIN),
                                 ("genotype", GT_MODEL, GT)):
        t0 = time.perf_counter()
        kdata, kpaths = make_data(512, 512, n_queries, 0,
                                  os.path.join(OUT, f"data_{key}"),
                                  model=model, alphabet=alphabet)
        print(f"{key} data: 512 taxa x 512 sites, {n_queries} queries in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        st = main_path(kpaths, n_queries, kdata[3], "cuda", model=model,
                       name=f"main_{key}")
        print(f"{model} main path: " + json.dumps(st), flush=True)
        check_twin(f"{model} main path", st)
        res[key] = st
    lap("7d-7e")

    # 7f: the small-reference gates
    small = {
        "binary": small_reference("cuda", name="small_b", binary=True),
        "raxml_blo": small_reference("cuda", name="small_raxml",
                                     extra=("--raxml-blo",)),
        "bin": small_reference("cuda", model=BIN_MODEL, name="small_bin",
                               alphabet=BIN, data_model=BIN_MODEL),
        "genotype": small_reference("cuda", model=GT_MODEL, name="small_gt",
                                    alphabet=GT, data_model=GT_MODEL),
    }
    for key, sm in small.items():
        print(f"small reference {key}: " + json.dumps(sm), flush=True)
    check(small["binary"]["launches"]["launches"] > 0,
          "-b small reference: the kernel never ran")
    for key in ("raxml_blo", "bin", "genotype"):
        check(small[key]["launches"]["launches"] == 0
              and small[key]["twin_launches"] > 0,
              f"{key} small reference: kernel launches "
              f"{small[key]['launches']['launches']}, twin launches "
              f"{small[key]['twin_launches']}")
    lap("7f")
    small["opt_model"] = small_opt_model("cuda")
    print("small reference --opt-model: " + json.dumps(small["opt_model"]),
          flush=True)
    res["small"] = small
    lap("7f --opt-model")

    # 7g: where the device time of the --opt-model run goes, over a
    # window of its L-BFGS steps (a whole run holds millions of profiler
    # events, and did not finish under the profiler in the time limit);
    # the run stops after the window, since 7a ran the whole of it
    res["opt_profile"] = profile_opt_window(opaths, "cuda")
    print("--opt-model profile: " + json.dumps(res["opt_profile"]),
          flush=True)
    lap("7g")
    return res



def memsave_run(paths, n_queries, name, budget=None, model=MODEL,
                resident=None, family="k4_launches", pinv=None,
                past8=False, cluster=False) -> dict:
    """Phase 8: one CLI run of a memsave cell (:func:`main_path`'s counts
    and checks: only the ``family`` instantiation, with +I iff ``pinv``,
    by default iff ``model`` is PINV_MODEL, past 8 rates iff ``past8``,
    on clusters iff ``cluster``), with ``--memsave --memsave-budget
    <budget>`` unless ``budget`` is None (the resident engine), and the
    device memory it held: ``rest_mb`` with the engine built and idle,
    ``peak_mb`` at most while it placed (the CLI's ``device_mb_at_place``
    and ``device_peak_mb``, less what the process held before the run). A
    --memsave run holds its cache at rest and no more (the store off the
    device stays off it); while it places it adds at most the
    ``resident`` run's temporaries (where given) plus its staging rings,
    which stay within depth x their largest request."""
    import gc

    import torch
    flags = MEMSAVE_KEEP if budget is None else (
        "--memsave", "--memsave-budget", repr(budget), *MEMSAVE_KEEP)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 1e6
    st = main_path(paths, n_queries, None, "cuda", model=model, name=name,
                   chunk=MEMSAVE_CHUNK, extra=flags)
    st.update(budget_gb=budget, rest_mb=st["device_mb_at_place"] - base,
              peak_mb=st["device_peak_mb"] - base)
    st["temp_mb"] = st["peak_mb"] - st["rest_mb"]
    if st.get("per_pair_launches"):
        # the streamed pairs' per-pair launches: slabs of at most
        # SLAB_BYTES, then the redo pass's few pairs
        st["streamed_pairs_per_launch"] = (st["memsave_streamed_pairs"]
                                           / st["per_pair_launches"])
    print(f"memsave {name}: " + json.dumps(st), flush=True)
    check_main(name, st, family, pinv=(model == PINV_MODEL if pinv is None
                                       else pinv),
               past8=past8, cluster=cluster)
    if budget is None:
        return st
    check(st["memsave_ring_mb"] <= st["memsave_ring_bound_mb"],
          f"{name}: staging rings hold {st['memsave_ring_mb']} MB, above "
          f"depth x their largest request {st['memsave_ring_bound_mb']} MB")
    check(st["rest_mb"] <= st["memsave_cached_mb"] + MEMSAVE_REST_SLACK_MB,
          f"{name}: the built engine holds {st['rest_mb']:.3f} MB on the "
          f"device, above its cache {st['memsave_cached_mb']:.3f} MB + "
          f"{MEMSAVE_REST_SLACK_MB} MB")
    if resident is None:
        return st
    allowed = resident["temp_mb"] + st["memsave_ring_mb"]
    check(st["temp_mb"] <= allowed + MEMSAVE_PEAK_SLACK_MB,
          f"{name}: placing added {st['temp_mb']:.1f} MB on the device, "
          f"above the resident run's {resident['temp_mb']:.1f} MB + the "
          f"rings' {st['memsave_ring_mb']:.1f} MB + "
          f"{MEMSAVE_PEAK_SLACK_MB} MB")
    return st


def memsave_gates(pl, pairs, every, tol=MEMSAVE_LOGL_ABS):
    """Phase 8's agreement of jplace runs ``pl`` by name, for each (name,
    other) of ``pairs``: the top edge up to ties on >= 99% of the queries
    and the best logl within ``tol`` (MEMSAVE_LOGL_ABS, or a cell's own
    f32_steps) wherever both runs share the top edge, both at that
    absolute tolerance; and on every query the best logl within ``every``
    (a relative tolerance, for runs whose heuristic cut may keep another
    candidate set on a query), within ``tol`` if ``every`` is "abs", not
    held if it is None. A run that keeps every tied edge (MEMSAVE_KEEP)
    goes second, where the first run's top edge is looked up."""
    gates = {}
    for name, other in pairs:
        ag = agreement(pl[name], pl[other], tol, absolute=True)
        ag["tol"] = tol
        gates[f"{name}_vs_{other}"] = ag
        all_ok = (every is None
                  or (ag["max_abs_best_logl"] <= tol
                      if every == "abs" else
                      ag["max_rel_best_logl"] <= every))
        check(ag["top_edge_up_to_ties"] >= 0.99
              and ag["max_abs_best_logl_same_top"] <= tol
              and all_ok,
              f"memsave {name} against {other}: {ag} (tolerance "
              f"{tol} absolute, on every query {every})")
    return gates


def memsave_control(paths, n_queries, sound, model=MODEL, name="",
                    tol=MEMSAVE_LOGL_ABS) -> dict:
    """Phase 8's negative control: the budget-0 run again with each
    streamed pair's site mask one site late (its last site dropped), a
    fault that the logl gates (at ``tol``) must refuse against the sound
    run ``sound`` (a jplace); under ``model`` (phase 8b: LG+G4, K =
    20)."""
    import torch

    from epa_ng_tpu_torch.ops import blo_kernel
    per_pair = blo_kernel.blo_optimize_batch_kernel

    def late(consts, tU, tV, tQ, ls, site_mask, *a, **k):
        mask = torch.zeros_like(site_mask)
        mask[:, 1:] = site_mask[:, :-1]
        return per_pair(consts, tU, tV, tQ, ls, mask, *a, **k)

    outdir = os.path.join(OUT, f"memsave_control{name}")
    blo_kernel.blo_optimize_batch_kernel = late
    try:
        run_cli(paths, outdir, "cuda", chunk=MEMSAVE_CHUNK, model=model,
                extra=("--memsave", "--memsave-budget", "0.0",
                       *MEMSAVE_KEEP))
    finally:
        blo_kernel.blo_optimize_batch_kernel = per_pair
    pl = read_jplace(os.path.join(outdir, "epa_result.jplace"))
    check(len(pl) == n_queries, "memsave control lost queries")
    ag = agreement(pl, sound, tol, absolute=True)
    ag["tol"] = tol
    print(f"memsave control{name}: " + json.dumps(ag), flush=True)
    check(ag["top_edge_up_to_ties"] < 0.99
          or ag["max_abs_best_logl_same_top"] > tol,
          f"memsave control{name}: a mask one site late passed the gates: "
          f"{ag}")
    return ag


def memsave_phase() -> dict:
    """Phase 8: ``--memsave`` on the JAX bench's memsave cell at three
    budgets against the resident run, the cell with invariant columns
    under +I at budget 0 against its resident run, then the small
    references."""
    from epa_ng_tpu_torch.utils.synth import synth_dataset
    n_taxa, sites, n, seed = MEMSAVE_CELL
    t0 = time.perf_counter()
    tree, ref, qry = synth_dataset(n_taxa=n_taxa, sites=sites, n_queries=n,
                                   seed=seed)
    paths = write_data(tree, ref, qry, os.path.join(OUT, "data_memsave"))
    ref_i, qry_i, _ = with_invariant_sites(ref, qry, FREQS, INVARIANT_SHARE,
                                           seed)
    paths_i = write_data(tree, ref_i, qry_i,
                         os.path.join(OUT, "data_memsave_pinv"))
    print(f"memsave data: {n_taxa} taxa x {sites} sites, {n} random "
          f"queries in {time.perf_counter() - t0:.2f} s", flush=True)
    res = {"resident": memsave_run(paths, n, "memsave_resident")}
    run = lambda key, gb: memsave_run(paths, n, f"memsave_{key}", gb,
                                      resident=res["resident"])
    tiers = {"stream": run("stream", 0.0)}
    half = tiers["stream"]["memsave_host_mb"] / 2 / 1e3
    tiers["half"] = run("half", half)
    tiers["cached"] = run("cached", 1000.0)
    res["pinv_resident"] = memsave_run(paths_i, n, "memsave_pinv_resident",
                                       model=PINV_MODEL)
    tiers["pinv_stream"] = memsave_run(paths_i, n, "memsave_pinv_stream",
                                       0.0, model=PINV_MODEL,
                                       resident=res["pinv_resident"])
    res["tiers"] = tiers
    E = 2 * n_taxa - 3  # the edges of an unrooted binary tree
    st, hf, cv = tiers["stream"], tiers["half"], tiers["cached"]
    check(st["memsave_cached_edges"] == 0 and st["memsave_cached_mb"] == 0,
          f"budget 0 cached {st['memsave_cached_edges']} edges")
    check(0 < hf["memsave_cached_edges"] < E,
          f"half budget cached {hf['memsave_cached_edges']} of {E} edges")
    check(cv["memsave_cached_edges"] == E and cv["memsave_ring_mb"] == 0,
          "budget 1000 did not cover the store")
    for key, tier in tiers.items():
        if key != "cached":
            check(tier["per_pair_launches"] > 0,
                  f"{key}: no per-pair-shape launch")
    check(st["blocked_launches"] == 0 and hf["blocked_launches"] > 0
          and cv["blocked_launches"] > 0 and cv["per_pair_launches"] == 0
          and tiers["pinv_stream"]["blocked_launches"] == 0,
          "blocked and per-pair launches: " + json.dumps(
              {k: (t["blocked_launches"], t["per_pair_launches"])
               for k, t in tiers.items()}))
    check(st["h2d_mb"] > hf["h2d_mb"] > 0 and cv["h2d_mb"] == 0,
          f"bytes streamed {st['h2d_mb']}, {hf['h2d_mb']}, {cv['h2d_mb']}")
    pl = {k: read_jplace(os.path.join(OUT, k, "epa_result.jplace"))
          for k in ("memsave_resident", "memsave_stream", "memsave_half",
                    "memsave_cached", "memsave_pinv_resident",
                    "memsave_pinv_stream")}
    pl = {k[len("memsave_"):]: v for k, v in pl.items()}
    # the tiers share one host build: the exact-path tiers (0 and half)
    # differ only by route (blocked against per-pair), within
    # MEMSAVE_LOGL_ABS on every query. The resident runs are their own f32
    # builds on the card, and the covering tier takes the fused step, whose
    # one GEMM over every edge rounds the preplacement scores otherwise than
    # 512-edge blocks: their heuristic cut may keep another candidate set
    # on a query, so the budget tiers are held on every query to the small
    # references' 1e-5 relative, and the +I tier (where one read's
    # candidate sets differed: PERF.md, phase 8) to the tie test alone
    gates = memsave_gates(pl, [("half", "stream")], "abs")
    gates.update(memsave_gates(pl, [
        ("stream", "resident"), ("half", "resident"), ("cached", "resident"),
        ("cached", "stream"), ("cached", "half")], 1e-5))
    gates.update(memsave_gates(pl, [("pinv_stream", "pinv_resident")],
                               None))
    res["agreement"] = gates
    print("memsave agreement: " + json.dumps(gates), flush=True)
    res["control"] = memsave_control(paths, n, pl["stream"])

    # the small references against the f64 CPU run: budget 0 and a
    # quarter of the card's store, without and with +I, and -b --memsave
    flags = lambda gb: ("--memsave", "--memsave-budget", repr(gb))
    small = {"stream": small_reference("cuda", name="small_ms",
                                       extra=flags(0.0))}
    quarter = small["stream"]["memsave_host_mb"] / 4 / 1e3
    small["quarter"] = small_reference("cuda", name="small_ms_q",
                                       extra=flags(quarter))
    for key, gb in (("pinv_stream", 0.0), ("pinv_quarter", quarter)):
        small[key] = small_reference(
            "cuda", model=PINV_MODEL, invariant_share=INVARIANT_SHARE,
            name=f"small_ms_{key}", extra=flags(gb))
    small["binary"] = small_reference("cuda", name="small_ms_b",
                                      binary=True, extra=flags(0.0))
    for key, sm in small.items():
        print(f"small reference --memsave {key}: " + json.dumps(sm),
              flush=True)
        la = sm["launches"]
        check(la["per_pair_launches"] > 0 and sm["twin_launches"] == 0,
              f"--memsave {key} small reference: {la['per_pair_launches']} "
              f"per-pair launches, {sm['twin_launches']} twin launches")
        check(la["pinv_launches"] == (la["launches"] if "pinv" in key
                                      else 0),
              f"--memsave {key} small reference: launches {la}")
        check((la["blocked_launches"] > 0) == ("quarter" in key),
              f"--memsave {key} small reference: launches {la}")
    small["quarter_gb"] = quarter
    res["small"] = small
    return res


def memsave_wide_phase(cells) -> dict:
    """Phase 8b: ``--memsave`` past DNA G4 on phase 4's data, each cell
    (``cells``: key -> dict of ``paths``, ``n`` reads, ``model``, the
    kernel ``family``, ``pinv``, ``past8``, ``cluster``, ``resident`` (the
    name of phase 4's run of the cell, or None to run it here with every
    tied edge kept), ``qry`` (the reads, cut to MEMSAVE_WIDE_READS where
    there are more), ``half`` and ``host_ref``) at budget 0 (every pair
    streamed through the per-pair shape) and, with ``half``, at half the
    host store (the cached prefix through the blocked shape), each
    launching only its own instantiation, never the twin. Every run meets
    phase 8's gates against the cell's resident run at the cell's own
    tolerance (f32_steps of the resident run); then the negative control
    on the LG+G4 cell.

    A --memsave run places on a state built on the host, which rounds
    otherwise than the resident run's card build. Under the mixtures on
    random reads the two builds' placements lie up to 10 f32 steps apart,
    and any two runs of the host build (budget 0, the covering budget,
    ``--mesh``, the CPU in f32) within 3 (PERF.md §6). A ``host_ref``
    cell therefore also runs the covering budget (1000 GB: the fused path
    on the host build, blocked shape) and is held to it at f32_steps,
    and to the resident run by the top edge up to ties and the best logl
    within 1e-5 relative where the top edge is shared (the small
    references' rule)."""
    from epa_ng_tpu_torch.utils.synth import write_fasta
    res = {}
    for key, c in cells.items():
        paths, n = c["paths"], c["n"]
        if n > MEMSAVE_WIDE_READS:
            n = MEMSAVE_WIDE_READS
            d = os.path.join(OUT, f"data_ms_{key}")
            os.makedirs(d, exist_ok=True)
            paths = (paths[0], paths[1], os.path.join(d, "query.fasta"))
            write_fasta(_head(c["qry"], n), paths[2])
        kind = dict(model=c["model"], family=c["family"], pinv=c["pinv"],
                    past8=c["past8"], cluster=c["cluster"])
        r = {"reads": n}
        base = c["resident"]
        if base is None:
            base = f"ms_{key}_resident"
            r["resident"] = memsave_run(paths, n, base, None, **kind)
        r["stream"] = memsave_run(paths, n, f"ms_{key}_stream", 0.0, **kind)
        tiers = ["stream"]
        if c["half"]:
            half = r["stream"]["memsave_host_mb"] / 2 / 1e3
            r["half"] = memsave_run(paths, n, f"ms_{key}_half", half, **kind)
            r["half_gb"] = half
            tiers.append("half")
        if c["host_ref"]:
            r["cover"] = cv = memsave_run(paths, n, f"ms_{key}_cover",
                                          1000.0, **kind)
            check(cv["per_pair_launches"] == 0 and cv["h2d_mb"] == 0,
                  f"memsave {key} covering budget: "
                  f"{cv['per_pair_launches']} per-pair launches, "
                  f"{cv['h2d_mb']} MB streamed")
        st = r["stream"]
        check(st["memsave_cached_edges"] == 0 and st["blocked_launches"] == 0
              and st["per_pair_launches"] > 0,
              f"memsave {key} budget 0: cached {st['memsave_cached_edges']} "
              f"edges, {st['blocked_launches']} blocked and "
              f"{st['per_pair_launches']} per-pair launches")
        if c["half"]:
            hf = r["half"]
            # some edges cached, and the rest streamed (less than at 0)
            check(hf["memsave_cached_edges"] > 0
                  and hf["blocked_launches"] > 0
                  and hf["per_pair_launches"] > 0
                  and 0 < hf["h2d_mb"] < st["h2d_mb"],
                  f"memsave {key} half budget: cached "
                  f"{hf['memsave_cached_edges']} edges, "
                  f"{hf['blocked_launches']} blocked and "
                  f"{hf['per_pair_launches']} per-pair launches, "
                  f"{hf['h2d_mb']} MB streamed ({st['h2d_mb']} at 0)")
        names = [f"ms_{key}_{t}" for t in tiers]
        ref = f"ms_{key}_cover" if c["host_ref"] else base
        pl = {k: read_jplace(os.path.join(OUT, k, "epa_result.jplace"))
              for k in {base, ref, *names}}
        check(all(len(p) == n for p in pl.values()),
              f"memsave {key}: a run lost queries")
        r["tol"] = tol = f32_steps(pl[base])
        r["agreement"] = memsave_gates(pl, [(ref, x) for x in names], None,
                                       tol)
        if c["host_ref"]:
            for x in names + [ref]:
                r["agreement"][f"{base}_vs_{x}"] = ag = agreement(
                    pl[base], pl[x], 1e-5)
                check(ag["top_edge_up_to_ties"] >= 0.99
                      and ag["max_rel_best_logl_same_top"] <= 1e-5,
                      f"memsave {x} against the card build {base}: {ag}")
        print(f"memsave {key} agreement: " + json.dumps(r["agreement"]),
              flush=True)
        res[key] = r
    c = cells["aa"]
    res["control_aa"] = memsave_control(
        c["paths"], c["n"],
        read_jplace(os.path.join(OUT, "ms_aa_stream", "epa_result.jplace")),
        model=c["model"], name="_aa", tol=res["aa"]["tol"])
    return res


def place_msa(eng, qry, chunk):
    """Phase 9b: place ``qry`` with ``eng`` through the CLI's pipeline
    functions (encode, collapse duplicates, ``place_encoded_async``, then
    ``finalize_chunk``; every chunk dispatched before the first is
    finalized); returns (placements by name as in :func:`read_jplace`,
    LWR-sorted rows, and the placing wall seconds)."""
    from epa_ng_tpu_torch.core import chunk as chunk_mod
    from epa_ng_tpu_torch.core.lwr import ChunkPlacements
    from epa_ng_tpu_torch.io.fasta import MSA
    t0 = time.perf_counter()
    seqs = list(qry)
    handles = []
    for start in range(0, len(seqs), chunk):
        sub = MSA()
        for s in seqs[start:start + chunk]:
            sub.append(s.header, s.sequence)
        ec = chunk_mod.collapse(eng.encode_msa(sub))
        handles.append(eng.place_encoded_async(ec, seq_id_offset=start))
    out = {}
    for h in handles:
        res = eng.finalize_chunk(h)
        pqs = res.to_pqueries() if isinstance(res, ChunkPlacements) else res
        for pq in pqs:
            order = sorted(range(len(pq.edge_nums)),
                           key=lambda i: -pq.lwrs[i])
            rows = [{"edge_num": int(pq.edge_nums[i]),
                     "likelihood": float(pq.logls[i]),
                     "like_weight_ratio": float(pq.lwrs[i])}
                    for i in order]
            for name in pq.headers:
                out[name] = rows
    return out, time.perf_counter() - t0


def bit_for_bit(a, b) -> float:
    """The share of queries whose placement rows are identical in runs
    ``a`` and ``b``."""
    return sum(a[q] == b[q] for q in a) / len(a)


def mesh_gates(pl, name, other, tol=MEMSAVE_LOGL_ABS):
    """Phase 9's agreement of two runs by name: top edge up to ties on >=
    99% of the queries and the best logl within ``tol`` (MEMSAVE_LOGL_ABS,
    or a cell's f32_steps) where they share the top edge (phase 8's gates:
    a mesh run's state is built on the CPU, so it rounds otherwise than a
    card-built one), with the largest absolute best-logl difference and
    the share of queries that are bit for bit."""
    ag = memsave_gates(pl, [(name, other)], None,
                       tol)[f"{name}_vs_{other}"]
    ag["bit_for_bit"] = bit_for_bit(pl[name], pl[other])
    return ag


def check_mesh_main(tag, st, mesh):
    check(st["mesh"] == mesh, f"{tag}: ran on mesh {st['mesh']}")
    check(st["blocked_launches"] > 0 and st["twin_launches"] == 0,
          f"{tag}: {st['blocked_launches']} blocked launches, "
          f"{st['twin_launches']} twin launches")


def mesh_cli_phase(paths, ppaths, n_queries, data, pdata, plain,
                   device="cuda", wide=()) -> dict:
    """Phase 9a: ``--mesh 1x1`` through the CLI on the headline data (the
    JAX bench's mesh1x1 cell: the sharded step with the blocked kernel on
    its one shard), and on the +I data, against phase 4's and 4b's
    resident runs; q/s and its ratio to the resident run's ``plain``.
    Then the ``wide`` cells past DNA G4 (key, paths, reads, model, the
    resident run's name, family, pinv, past8, cluster, and the name of a
    run of the host build or None): protein, LG+I+G4, the mixture and
    LG+G16 at chunk 512, every tied edge kept, each against its resident
    run at f32_steps of that run; a cell with a host-build run (the
    mixture: phase 8b's covering --memsave run; a --mesh state is built on
    the host too) is held to that one at f32_steps, and to the resident
    run as phase 8b holds it (:func:`memsave_wide_phase`)."""
    res = {}
    cells = [(key, p, n_queries, d[3], model, base, "k4_launches", pinv,
              False, False, 1024, (), MEMSAVE_LOGL_ABS, None)
             for key, p, d, model, base, pinv in (
                 ("mesh1x1", paths, data, MODEL, "main", False),
                 ("pinv_mesh1x1", ppaths, pdata, PINV_MODEL, "main_pinv",
                  True))]
    for (key, p, n, model, base, family, pinv, past8, cluster,
         host) in wide:
        tol = f32_steps(read_jplace(os.path.join(OUT, base,
                                                 "epa_result.jplace")))
        cells.append((key, p, n, None, model, base, family, pinv, past8,
                      cluster, MEMSAVE_CHUNK, MEMSAVE_KEEP, tol, host))
    for (key, p, n, true_edges, model, base, family, pinv, past8, cluster,
         chunk, keep, tol, host) in cells:
        st = main_path(p, n, true_edges, device, model=model,
                       name=f"main_{key}", chunk=chunk,
                       extra=("--mesh", "1x1", *keep))
        check_main(key, st, family, pinv=pinv, past8=past8, cluster=cluster)
        check_mesh_main(key, st, "1x1")
        pl = {k: read_jplace(os.path.join(OUT, k, "epa_result.jplace"))
              for k in (f"main_{key}", base, host) if k}
        pl[key] = pl.pop(f"main_{key}")
        # a run that keeps every tied edge goes second (memsave_gates)
        st["agreement"] = (mesh_gates(pl, host or base, key, tol) if keep
                           else mesh_gates(pl, key, base, tol))
        if host:
            st["agreement_card_build"] = ag = agreement(pl[base], pl[key],
                                                        1e-5)
            check(ag["top_edge_up_to_ties"] >= 0.99
                  and ag["max_rel_best_logl_same_top"] <= 1e-5,
                  f"--mesh 1x1 {key} against the card build {base}: {ag}")
        st["ratio_vs_plain"] = st["qps"] / plain[base]["qps"]
        print(f"--mesh 1x1 {key}: " + json.dumps(st), flush=True)
        res[key] = st
    return res


def mesh_library_phase(device="cuda", data=None, model=MODEL,
                       meshes=((1, 4), (2, 2)), chunk=BIGTREE_CHUNK,
                       tag="bigtree") -> dict:
    """Phase 9b: ep > 1 on the one card through the library, on the JAX
    bench's bigtree evolved data (or ``data`` under ``model``: the LG+G16
    cell, the K = 20 cluster on every shard): the engine built on the CPU
    (as the CLI builds it under --mesh) with each of ``meshes`` (dp, ep)
    over ``[cuda:0] * 4`` attached, placing through the CLI's pipeline
    functions, against the resident engine on the card; then one forced
    exact redo on a few pairs through the mesh engine's ``_thorough``
    (the per-pair kernel shape on windows of the host store) against the
    resident engine's. The bigtree's runs are held to MEMSAVE_LOGL_ABS,
    another cell's to f32_steps of its resident run."""
    import numpy as np
    import torch

    from epa_ng_tpu_torch.core.engine import PlacementEngine
    from epa_ng_tpu_torch.models import Model
    from epa_ng_tpu_torch.ops.blo_kernel import blo_newton
    from epa_ng_tpu_torch.parallel.mesh import make_mesh
    from epa_ng_tpu_torch.utils.options import Options
    if data is None:
        n_taxa, sites, n, seed = BIGTREE_CELL
        t0 = time.perf_counter()
        (tree, ref, qry, _), _ = make_data(n_taxa, sites, n, seed,
                                           os.path.join(OUT, "data_bigtree"))
        print(f"bigtree data: {n_taxa} taxa x {sites} sites, {n} evolved "
              f"queries in {time.perf_counter() - t0:.2f} s", flush=True)
    else:
        tree, ref, qry, _ = data
        n = len(list(qry))
    make = lambda dev: PlacementEngine(tree, ref, Model.from_string(model),
                                       Options(compute_dtype="f32"),
                                       device=dev)
    card = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    resident = make(card)
    pl = {}
    pl["resident"], wall = place_msa(resident, qry, chunk)
    tol = MEMSAVE_LOGL_ABS if data is None else f32_steps(pl["resident"])
    res = {"resident": dict(qps=n / wall, placing_s=wall), "tol": tol}
    print(f"{tag} resident (one card): " + json.dumps(res["resident"]),
          flush=True)
    chunks = -(-n // chunk)
    engines = {}
    for dp, ep in meshes:
        key = f"{dp}x{ep}"
        t0 = time.perf_counter()
        eng = make("cpu")
        build_s = time.perf_counter() - t0
        eng.attach_mesh(make_mesh(dp, ep, [card] * 4))
        blo_newton.reset_counts()
        pl[key], wall = place_msa(eng, qry, chunk)
        counts = blo_newton.counts()
        st = dict(qps=n / wall, placing_s=wall, build_s=build_s,
                  pad_edges=eng._sharded.pad,
                  shard_bytes=eng._sharded.shard_nbytes(), **counts,
                  **eng.newton_work.totals())
        check(st["pad_edges"] == (-resident.num_edges) % ep,
              f"{tag} mesh {key}: {st['pad_edges']} pad edges")
        check(st["blocked_launches"] >= ep * chunks
              and st["twin_launches"] == 0,
              f"{tag} mesh {key}: {st['blocked_launches']} blocked launches "
              f"for {ep} shards x {chunks} chunks, {st['twin_launches']} "
              "twin launches")
        st["agreement"] = mesh_gates(pl, key, "resident", tol)
        print(f"{tag} mesh {key} (one card): " + json.dumps(st), flush=True)
        res[key] = st
        engines[key] = eng
    # the forced exact redo: 64 queries x their 4 best preplacement
    # candidates through the mesh engine's _thorough (host windows, the
    # per-pair kernel shape) and the resident engine's (blocked shape)
    eng = engines["1x4"]
    ec = resident.encode_msa(_head(qry, 64))
    top = np.argsort(-resident.preplace(ec.codes, ec.ranges), axis=1,
                     kind="stable")[:, :4]
    pair_q = np.repeat(np.arange(len(ec)), 4).astype(np.int32)
    pair_e = top.reshape(-1).astype(np.int32)
    blo_newton.reset_counts()
    got = eng._thorough(pair_e, pair_q, ec.codes, ec.ranges)
    counts = blo_newton.counts()
    want = resident._thorough(pair_e, pair_q, ec.codes, ec.ranges)
    diff = float(np.max(np.abs(got[0] - want[0])))
    res["exact_redo"] = dict(pairs=len(pair_e), max_abs_logl=diff,
                             per_pair_launches=counts["per_pair_launches"],
                             blocked_launches=counts["blocked_launches"],
                             cluster_launches=counts["cluster_launches"])
    print(f"{tag} mesh 1x4 exact redo: " + json.dumps(res["exact_redo"]),
          flush=True)
    check(counts["per_pair_launches"] > 0 and counts["blocked_launches"] == 0,
          f"{tag} mesh exact redo launches {counts}")
    check(diff <= tol, f"{tag} mesh exact redo: pair logl {diff} off the "
          f"resident engine's (> {tol})")
    return res


def jplace_names(path) -> list:
    with open(path) as f:
        return [n for p in json.load(f)["placements"] for n in p["n"]]


def two_ranks(paths, name, extra=(), device="cuda") -> dict:
    """Phase 9c: ``python3 -m epa_ng_tpu_torch.cli ... --distributed
    127.0.0.1:PORT,2,RANK`` as two processes on the one card (a gloo group
    over localhost), each under a time limit; the merged jplace's names,
    each rank's log and the pair's wall time."""
    import socket
    outdir = os.path.join(OUT, name)
    os.makedirs(outdir, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("EPA_NG_TPU_")}
    env["PYTHONPATH"] = HERE
    argv = ["--tree", paths[0], "--ref-msa", paths[1], "--query", paths[2],
            "--model", MODEL, "--outdir", outdir, "--redo", "--chunk-size",
            "1024", "--device", device, *extra]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "epa_ng_tpu_torch.cli", *argv,
         "--distributed", f"127.0.0.1:{port},2,{rank}"],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0].decode())
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"{name}: a rank ran past {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{name}: rank {rank} exited "
              f"{p.returncode}: {out[-2000:]}")
    logs = []
    for rank in (0, 1):
        with open(os.path.join(outdir, f"{rank}.epa_info.log")) as f:
            logs.append(f.read())
    left = [f for f in os.listdir(outdir) if ".shard" in f]
    check(not left, f"{name}: left {left}")
    return dict(wall_s=wall, logs=logs, names=jplace_names(
        os.path.join(outdir, "epa_result.jplace")))


def rank_launches(log) -> tuple:
    """(blocked, per-pair, twin) from a rank's "Newton: ..." log line."""
    line = [x for x in log.splitlines() if x.startswith("Newton: ")][-1]
    words = line.split()
    return int(words[1]), int(words[4]), int(words[8])


def distributed_phase(paths, n_queries, device="cuda") -> dict:
    """Phase 9c: two processes on the one card, even and then with
    ``--adaptive-split`` (rates measured and gathered over the group);
    the merged jplace holds every name once, in input order, with no
    shard or sidecar left, and meets 9a's gates against phase 4's run;
    every rank placed through the kernel, never the twin."""
    main_pl = read_jplace(os.path.join(OUT, "main", "epa_result.jplace"))
    want = [f"Q{i}" for i in range(n_queries)]
    res = {}
    for key, extra in (("even", ()), ("adaptive", ("--adaptive-split",))):
        r = two_ranks(paths, f"dist_{key}", extra, device)
        check(r["names"] == want, f"distributed {key}: the merged jplace "
              f"holds {len(r['names'])} names, not the {n_queries} in "
              "input order")
        launches = [rank_launches(log) for log in r["logs"]]
        check(all(b > 0 and t == 0 for b, _, t in launches),
              f"distributed {key}: (blocked, per-pair, twin) per rank "
              f"{launches}")
        pl = {key: read_jplace(os.path.join(OUT, f"dist_{key}",
                                            "epa_result.jplace")),
              "main": main_pl}
        st = dict(wall_s=r["wall_s"], launches=launches,
                  agreement=mesh_gates(pl, key, "main"))
        if extra:
            shares = [[x.split("this rank: ")[1] for x in log.splitlines()
                       if "this rank: " in x] for log in r["logs"]]
            check(all(len(x) == 1 for x in shares),
                  f"adaptive split: rank logs name {shares}")
            got = [tuple(int(w) for w in x[0].replace(",", "").split()
                         if w.isdigit()) for x in shares]
            check(got[0][0] == 0 and got[1][0] == got[0][1]
                  and got[0][1] + got[1][1] == n_queries,
                  f"adaptive split: shards {got} do not cover "
                  f"{n_queries} queries once")
            st["shards"] = got
        print(f"distributed {key}: " + json.dumps(st), flush=True)
        res[key] = st
    return res


def refusals(paths) -> dict:
    """Phase 9d: what the JAX CLI refuses, the port refuses, nonzero and
    with its message: a mesh of more cards than the machine has, a dp
    that is not a power of two, --mesh with --memsave, and a bad
    --distributed spec."""
    import torch

    from epa_ng_tpu_torch import cli
    n = torch.cuda.device_count()
    big = "2x1" if n == 1 else f"1x{n + 1}"
    cases = [(("--mesh", big), f"needs {2 if n == 1 else n + 1} local "
              f"devices, have {n}"),
             (("--mesh", "3x1"), "dp must be a power of two"),
             (("--mesh", "1x1", "--memsave"),
              "--mesh and --memsave are mutually exclusive"),
             (("--distributed", "127.0.0.1:1,two,0"),
              "bad --distributed spec")]
    out = {}
    for i, (flags, message) in enumerate(cases):
        outdir = os.path.join(OUT, f"refuse{i}")
        argv = ["--tree", paths[0], "--ref-msa", paths[1], "--query",
                paths[2], "--model", MODEL, "--outdir", outdir, "--redo",
                *flags]
        try:
            rc = cli.main(argv)
            with open(os.path.join(outdir, "epa_info.log")) as f:
                said = f.read()
        except SystemExit as e:
            rc, said = 1, str(e)
        check(rc != 0 and message in said,
              f"{' '.join(flags)}: exit {rc}, not refused with "
              f"{message!r}: {said[-300:]}")
        out[" ".join(flags)] = rc
    print("refusals: " + json.dumps(out), flush=True)
    return out


def main(argv=()) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAILED: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from epa_ng_tpu_torch.ops.blo_kernel import blo_newton
    except ImportError as e:
        print(f"chip_smoke: FAILED: the port is not beside this script "
              f"({e})", file=sys.stderr)
        return 1
    try:
        t_start = time.perf_counter()
        phase_s, lap = {}, [t_start]

        def done(phase):
            """Print and keep the seconds since the last phase ended."""
            now = time.perf_counter()
            phase_s[phase] = now - lap[0]
            lap[0] = now
            print(f"phase {phase}: {phase_s[phase]:.1f} s", flush=True)

        # phase 1: the card
        smi = card_line()
        name = torch.cuda.get_device_name(0)
        check(name.split()[-1] in smi or name in smi,
              f"nvidia-smi ({smi}) and torch ({name}) disagree")
        print(f"card: {smi} | torch: {name} | torch {torch.__version__} "
              f"cuda {torch.version.cuda}", flush=True)
        done("1")

        if "--fmad-ab" in argv:
            data, _ = make_data(512, 512, 8192, 0, os.path.join(OUT, "data"))
            adata, _ = make_data(256, 256, 2048, 0,
                                 os.path.join(OUT, "data_aa"),
                                 model=AA_MODEL, alphabet=AA)
            res = fmad_ab({"dna": (data, MODEL, 16384),
                           "protein": (adata, AA_MODEL, 4096)})
            print("fmad a/b: " + json.dumps(res), flush=True)
            print(smi)
            return 0

        # phase 2: build every library side by side, one nvcc each
        t0 = time.perf_counter()
        try:
            blo_newton.build_all()
        except RuntimeError as e:
            raise SmokeFailure(str(e)) from e
        build_s = time.perf_counter() - t0
        ptxas = [s for log in blo_newton.build_logs.values()
                 for s in ptxas_summary(log)]
        print(f"build: {build_s:.2f} s (every library); ptxas: "
              f"{json.dumps(ptxas)}", flush=True)
        # the cluster's instantiations free of spills: home x {single,
        # mixture} without +I, home x single with it, two in each K = 20
        # library (one loaded from an earlier build prints no ptxas lines)
        cluster = [p for p in ptxas if " cluster:" in p]
        built = [key for key, log in blo_newton.build_logs.items() if log]
        check(len(cluster) == 2 * sum(part != "dna" for _, part in built)
              and all(p.endswith(" 0 B spill") for p in cluster),
              f"the cluster instantiations spill or are missing: {cluster}")
        # the K = 4 runtime-R instantiations in the shared home (past 8
        # rates) free of spills within 168 registers, 3 CTAs an SM
        r0 = [p for p in ptxas if p.startswith("R0 shared")]
        check(len(r0) == sum(part == "dna" for _, part in built)
              and all(p.endswith(" 0 B spill")
                      and int(p.split(": ")[1].split()[0]) <= 168
                      for p in r0),
              f"the K = 4 runtime-R instantiations spill or pass 168 "
              f"registers: {r0}")
        done("2")

        # data (set-up)
        t0 = time.perf_counter()
        n_queries = 8192
        data, paths = make_data(512, 512, n_queries, 0,
                                os.path.join(OUT, "data"))
        pdata, ppaths = make_pinv_data(data, 0,
                                       os.path.join(OUT, "data_pinv"))
        print(f"data: 512 taxa x 512 sites, {n_queries} queries, and the "
              f"+I copy with {INVARIANT_SHARE:.0%} invariant columns in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        n_aa, n_mix = 2048, 1024
        adata, apaths = make_data(256, 256, n_aa, 0,
                                  os.path.join(OUT, "data_aa"),
                                  model=AA_MODEL, alphabet=AA)
        apdata, appaths = make_pinv_data(adata, 0,
                                         os.path.join(OUT, "data_aa_pinv"),
                                         lg_freqs(), AA)
        register_mixture()
        register_mixture(16, MIXTURE16)
        register_mixture(32, MIXTURE32)
        mdata, mpaths = make_random_data(128, 256, n_mix, 13,
                                         os.path.join(OUT, "data_mix"))
        print(f"protein data: 256 taxa x 256 sites, {n_aa} evolved LG "
              f"queries and the +I copy; mixture 128 x 256, {n_mix} random "
              f"queries; in {time.perf_counter() - t0:.2f} s", flush=True)
        done("data")

        # phases 3-3e: each instantiation vs its plain version, counters
        par = parity_phase("parity", data, MODEL)
        ppar = parity_phase("+I parity", pdata, PINV_MODEL)
        apar = parity_phase("K=20 parity", adata, AA_MODEL)
        mpar = parity_phase("mixture parity", mdata, MIX_MODEL)
        appar = parity_phase("K=20 +I parity", apdata, AA_PINV_MODEL)
        # phases 3f-3h: 16 rate categories (the K = 4 runtime-R
        # instantiation without and with +I, the K = 20 rate walk)
        gpar = parity_phase("R=16 parity", data, G16_MODEL)
        gppar = parity_phase("R=16 +I parity", pdata, G16_PINV_MODEL)
        # the runtime-R instantiation's site-blocked loops keep every pair
        # on the f64 plain version's optimum
        for tag, p in (("R=16", gpar), ("R=16 +I", gppar)):
            off = {k: r["pairs_off_f64"] for k, r in p.items()
                   if "pairs_off_f64" in r}
            check(not any(off.values()),
                  f"{tag}: pairs off the f64 plain version {off}")
        agpar = parity_phase("K=20 R=16 parity", adata, AA_G16_MODEL)
        done("3")
        # phases 3i-3k: the cluster with +I and for mixtures past 8
        # components
        agppar = parity_phase("K=20 R=16 +I parity", apdata,
                              AA_PINV_G16_MODEL, CLUSTER_PAIRS)
        m16par = parity_phase("mixture R=16 parity", mdata, MIX16_MODEL,
                              CLUSTER_PAIRS)
        m32par = parity_phase("mixture R=32 parity", mdata, MIX32_MODEL,
                              CLUSTER_PAIRS)
        done("3i")

        # phases 4-4d: the main paths, each with its counts reset
        stats = main_path(paths, n_queries, data[3], "cuda")
        print("main path: " + json.dumps(stats), flush=True)
        check_main("main path", stats, "k4_launches")
        pstats = main_path(ppaths, n_queries, pdata[3], "cuda",
                           model=PINV_MODEL, name="main_pinv")
        print("+I main path: " + json.dumps(pstats), flush=True)
        check_main("+I main path", pstats, "k4_launches", pinv=True)
        astats = main_path(apaths, n_aa, adata[3], "cuda", model=AA_MODEL,
                           name="main_aa", chunk=512)
        print("protein main path: " + json.dumps(astats), flush=True)
        check_main("protein main path", astats, "k20_launches")
        mstats = main_path(mpaths, n_mix, None, "cuda", model=MIX_MODEL,
                           name="main_mix", chunk=512)
        print("mixture main path: " + json.dumps(mstats), flush=True)
        check_main("mixture main path", mstats, "mixture_launches")
        gstats = main_path(paths, n_queries, data[3], "cuda",
                           model=G16_MODEL, name="main_g16")
        print("G16 main path: " + json.dumps(gstats), flush=True)
        check_main("G16 main path", gstats, "k4_launches", past8=True)
        agstats = main_path(apaths, n_aa, adata[3], "cuda",
                            model=AA_G16_MODEL, name="main_aa_g16",
                            chunk=512)
        print("LG+G16 main path: " + json.dumps(agstats), flush=True)
        check_main("LG+G16 main path", agstats, "k20_launches", past8=True,
                   cluster=True)
        done("4")
        # phases 4g-4h: the cluster with +I and for a 16-component mixture
        agpstats = main_path(appaths, n_aa, adata[3], "cuda",
                             model=AA_PINV_G16_MODEL,
                             name="main_aa_pinv_g16", chunk=512)
        print("LG+I+G16 main path: " + json.dumps(agpstats), flush=True)
        check_main("LG+I+G16 main path", agpstats, "k20_launches",
                   pinv=True, past8=True, cluster=True)
        m16stats = main_path(mpaths, n_mix, None, "cuda", model=MIX16_MODEL,
                             name="main_mix16", chunk=512)
        print("16-component mixture main path: " + json.dumps(m16stats),
              flush=True)
        check_main("16-component mixture main path", m16stats,
                   "mixture_launches", past8=True, cluster=True)
        done("4g")

        # phase 5: small-input references
        small = small_reference("cuda")
        print("small reference: " + json.dumps(small), flush=True)
        done("5 GTR+G4")
        small_ic = small_reference("cuda", model=IC_MODEL,
                                   invariant_share=INVARIANT_SHARE,
                                   name="small_ic")
        print("small reference +IC: " + json.dumps(small_ic), flush=True)
        done("5 +IC")
        small_aa = small_reference("cuda", model=AA_MODEL, name="small_aa",
                                   alphabet=AA, size=AA_SMALL)
        print("small reference LG+G4: " + json.dumps(small_aa), flush=True)
        done("5 LG+G4")
        small_mix = small_reference("cuda", model=MIX_MODEL,
                                    name="small_mix", random_data=True,
                                    size=MIX_SMALL)
        print("small reference mixture: " + json.dumps(small_mix),
              flush=True)
        done("5 mixture")
        small_aa_ic = small_reference("cuda", model=AA_IC_MODEL,
                                      invariant_share=INVARIANT_SHARE,
                                      name="small_aa_ic", alphabet=AA,
                                      freqs=lg_freqs(), size=AA_SMALL)
        print("small reference LG+IC+G4: " + json.dumps(small_aa_ic),
              flush=True)
        done("5 LG+IC+G4")
        aa_ic = small_aa_ic["launches"]
        check(aa_ic["pinv_launches"] > 0
              and aa_ic["pinv_launches"] == aa_ic["k20_launches"]
              == aa_ic["launches"],
              f"LG+IC+G4 small reference: K=20 +I launches {aa_ic}")
        small_r10 = small_reference("cuda", model=R10_MODEL,
                                    invariant_share=INVARIANT_SHARE,
                                    name="small_r10")
        print("small reference +I+R10: " + json.dumps(small_r10),
              flush=True)
        done("5 +I+R10")
        r10 = small_r10["launches"]
        check(r10["pinv_launches"] > 0
              and r10["pinv_launches"] == r10["past8_launches"]
              == r10["k4_launches"] == r10["launches"],
              f"+I+R10 small reference: K=4 +I launches {r10}")
        small_aa_g16 = small_reference("cuda", model=AA_G16_MODEL,
                                       name="small_aa_g16", alphabet=AA,
                                       size=AA_G16_SMALL)
        print("small reference LG+G16: " + json.dumps(small_aa_g16),
              flush=True)
        ag16 = small_aa_g16["launches"]
        check(ag16["past8_launches"] > 0
              and ag16["past8_launches"] == ag16["k20_launches"]
              == ag16["launches"],
              f"LG+G16 small reference: K=20 launches {ag16}")
        done("5 LG+G16")
        small_mix32 = small_reference("cuda", model=MIX32_MODEL,
                                      name="small_mix32", random_data=True,
                                      size=MIX32_SMALL)
        print("small reference 32-component mixture: "
              + json.dumps(small_mix32), flush=True)
        m32 = small_mix32["launches"]
        check(m32["cluster_launches"] > 0
              and m32["cluster_launches"] == m32["mixture_launches"]
              == m32["launches"],
              f"32-component mixture small reference: launches {m32}")
        done("5 mixture R=32")
        budgets = exact_budgets("cuda")
        print("exact budgets GTR+G16: " + json.dumps(budgets), flush=True)
        done("5 exact budgets")
        budgets_wide = exact_budgets_wide("cuda")
        print("exact budgets GTR+G4, LG+G4, mixture: "
              + json.dumps(budgets_wide), flush=True)
        done("5 exact budgets wide")
        # phase 5b: the flags no earlier phase runs on the card
        flags = flags_phase("cuda", {
            "main": (paths, n_queries, data[3], MODEL, "k4_launches", 1024),
            "main_aa": (apaths, n_aa, adata[3], AA_MODEL, "k20_launches",
                        512)})
        print("flags: " + json.dumps(flags), flush=True)
        done("5b")

        # phase 6: where the device time goes
        prof = profile_main(paths, "cuda")
        print("profile: " + json.dumps(prof), flush=True)
        pprof = profile_main(ppaths, "cuda", model=PINV_MODEL,
                             name="profiled_pinv")
        print("+I profile: " + json.dumps(pprof), flush=True)
        aprof = profile_main(apaths, "cuda", model=AA_MODEL,
                             name="profiled_aa", chunk=512)
        print("protein profile: " + json.dumps(aprof), flush=True)
        mprof = profile_main(mpaths, "cuda", model=MIX_MODEL,
                             name="profiled_mix", chunk=512)
        print("mixture profile: " + json.dumps(mprof), flush=True)
        gprof = profile_main(paths, "cuda", model=G16_MODEL,
                             name="profiled_g16")
        print("G16 profile: " + json.dumps(gprof), flush=True)
        agprof = profile_main(apaths, "cuda", model=AA_G16_MODEL,
                              name="profiled_aa_g16", chunk=512)
        print("LG+G16 profile: " + json.dumps(agprof), flush=True)
        done("6")

        # phase 7: the rest of the one-card CLI, each path with its counts
        # reset just before and read just after
        rest = rest_of_cli(paths, n_queries, data[3], done)

        # phase 8: --memsave, each tier with its counts reset just before
        # and read just after
        ms = memsave_phase()
        done("8")
        # phase 8b: --memsave past DNA G4 on phase 4's cells
        cell = lambda paths, n, model, family, resident, pinv=False, \
            past8=False, half=False, qry=None: dict(
                paths=paths, n=n, model=model, family=family,
                resident=resident, pinv=pinv, past8=past8,
                cluster=past8 and family != "k4_launches", half=half,
                qry=qry, host_ref=family == "mixture_launches")
        ms_wide = memsave_wide_phase({
            "aa": cell(apaths, n_aa, AA_MODEL, "k20_launches", "main_aa",
                       half=True),
            "aa_pinv": cell(appaths, n_aa, AA_PINV_MODEL, "k20_launches",
                            None, pinv=True),
            "mix": cell(mpaths, n_mix, MIX_MODEL, "mixture_launches",
                        "main_mix"),
            "aa_g16": cell(apaths, n_aa, AA_G16_MODEL, "k20_launches",
                           "main_aa_g16", past8=True, half=True),
            "aa_pinv_g16": cell(appaths, n_aa, AA_PINV_G16_MODEL,
                                "k20_launches", "main_aa_pinv_g16",
                                pinv=True, past8=True),
            "mix16": cell(mpaths, n_mix, MIX16_MODEL, "mixture_launches",
                          "main_mix16", past8=True),
            "g16": cell(paths, n_queries, G16_MODEL, "k4_launches", None,
                        past8=True, qry=data[2]),
            "g16_pinv": cell(ppaths, n_queries, G16_PINV_MODEL,
                             "k4_launches", None, pinv=True, past8=True,
                             qry=pdata[2])})
        done("8b")

        # phase 9: --mesh, a mesh of ep shards on the one card, two
        # processes on the one card (--distributed, --adaptive-split), and
        # the refusals; each path with its counts reset just before it
        mesh_cli = mesh_cli_phase(
            paths, ppaths, n_queries, data, pdata,
            {"main": stats, "main_pinv": pstats, "main_aa": astats,
             "ms_aa_pinv_resident": ms_wide["aa_pinv"]["resident"],
             "main_mix": mstats, "main_aa_g16": agstats},
            wide=[("aa_mesh1x1", apaths, n_aa, AA_MODEL, "main_aa",
                   "k20_launches", False, False, False, None),
                  ("aa_pinv_mesh1x1", appaths, n_aa, AA_PINV_MODEL,
                   "ms_aa_pinv_resident", "k20_launches", True, False,
                   False, None),
                  ("mix_mesh1x1", mpaths, n_mix, MIX_MODEL, "main_mix",
                   "mixture_launches", False, False, False, "ms_mix_cover"),
                  ("aa_g16_mesh1x1", apaths, n_aa, AA_G16_MODEL,
                   "main_aa_g16", "k20_launches", False, True, True,
                   None)])
        done("9a")
        mesh_lib = mesh_library_phase()
        mesh_aa_g16 = mesh_library_phase(data=adata, model=AA_G16_MODEL,
                                         meshes=((1, 4),),
                                         chunk=MEMSAVE_CHUNK, tag="LG+G16")
        done("9b")
        mesh_dist = distributed_phase(paths, n_queries)
        done("9c")
        refusals(paths)
        done("9d")
        mesh_blocked = {
            "mesh1x1": mesh_cli["mesh1x1"]["blocked_launches"],
            **{f"bigtree_{k}": mesh_lib[k]["blocked_launches"]
               for k in ("1x4", "2x2")}}
        mesh_pp = {
            "bigtree_exact_redo":
                mesh_lib["exact_redo"]["per_pair_launches"],
            **{k: mesh_cli[k]["per_pair_launches"]
               for k in ("mesh1x1", "pinv_mesh1x1")},
            **{f"bigtree_{k}": mesh_lib[k]["per_pair_launches"]
               for k in ("1x4", "2x2")}}
        ms_tiers, ms_small = ms["tiers"], ms["small"]
        ms_launches = lambda shape, keys: {k: ms_tiers[k][shape]
                                           for k in keys}
        ms_small_pp = lambda keys: {
            k: ms_small[k]["launches"]["per_pair_launches"] for k in keys}
        ms_pp = ms_launches("per_pair_launches",
                            ("stream", "half", "cached"))


        def wide_ms(key):
            """Phase 8b's launches of a cell: per-pair at budget 0,
            per-pair and blocked at half the store, blocked at the
            covering budget."""
            r = ms_wide[key]
            out = {f"{key}_stream_per_pair": r["stream"]["per_pair_launches"]}
            if "half" in r:
                out[f"{key}_half_per_pair"] = r["half"]["per_pair_launches"]
                out[f"{key}_half_blocked"] = r["half"]["blocked_launches"]
            if "cover" in r:
                out[f"{key}_cover_blocked"] = r["cover"]["blocked_launches"]
            return out

        def wide_mesh(*keys, **more):
            """Phase 9's shard launches of cells past DNA G4 (blocked on
            each shard; ``more``: other counts by name) and their sum."""
            out = {k: mesh_cli[k]["blocked_launches"] for k in keys}
            out.update(more)
            return dict(launches_mesh=out, mesh_launches=sum(out.values()))

        tol = {"logl_abs_tol": LOGL_ABS_TOL, "length_q90_tol": LEN_Q90_TOL}
        shapes = lambda p, keys=("blocked", "blocked_widest_shared",
                                 "blocked_device_memory", "per_pair",
                                 "pv"): {k: p[k] for k in keys if k in p}

        def team(p):
            """A row's pairs off the f64 plain version and its launch
            geometry at the main path's width, as the library read it from
            the runtime: the CTAs a pair runs on and the clusters of them
            the card holds at once (their CTAs against the card's SMs)."""
            g = p["geometry"]
            return dict(pairs_off_f64=p["blocked"]["pairs_off_f64"],
                        threads_per_cta=g["threads"],
                        ctas_per_pair=g["cluster"],
                        active_clusters=g["active_clusters"],
                        ctas_held=g["active_clusters"] * g["cluster"],
                        ctas_per_sm=g["ctas_per_sm"], t_shared=g["t_shared"],
                        shared_bytes=g["shared_bytes"], regs=g["regs"])
        kernels = [
            kernel_entry(
                "blo_newton", "epa_ng_tpu/ops/pallas_blo.py:117",
                stats["launches"], par["blocked"],
                launches_rest_of_cli={
                    k: rest[k]["launches"] for k in ("opt_model", "binary")},
                launches_memsave=ms_launches(
                    "blocked_launches", ("stream", "half", "cached")),
                mesh_launches=sum(mesh_blocked.values()),
                launches_mesh=mesh_blocked,
                instantiation="GTR+G4: K = 4, R = 4", **team(par),
                parity={**shapes(par, ("blocked", "blocked_widest_shared",
                                       "blocked_device_memory",
                                       "per_pair")), **tol}),
            kernel_entry(
                "blo_newton_pinv (blocked)",
                "epa_ng_tpu/ops/pallas_blo.py:174",
                pstats["pinv_launches"], ppar["blocked"],
                mesh_launches=mesh_cli["pinv_mesh1x1"]["pinv_launches"],
                launches_note="mesh_launches: the +I headline under "
                "--mesh 1x1 (phase 9a)",
                instantiation="GTR+I{0.2}+G4: K = 4 with +I, R = 4",
                **team(ppar),
                parity={**shapes(ppar, ("blocked", "blocked_widest_shared",
                                        "blocked_device_memory", "pv")),
                        **tol}),
            kernel_entry(
                "blo_newton (per-pair)", "epa_ng_tpu/ops/pallas_blo.py:65",
                sum(ms_pp.values()), par["per_pair"],
                launches_memsave=ms_pp,
                mesh_launches=sum(mesh_pp.values()),
                launches_mesh=mesh_pp,
                launches_small_reference=ms_small_pp(
                    ("stream", "quarter", "binary")),
                launches_note="per-pair-shape launches over the GTR+G4 "
                "--memsave tiers of phase 8 (streamed misses)",
                instantiation="GTR+G4: K = 4, R = 4", **team(par),
                parity={"per_pair": par["per_pair"], **tol}),
            kernel_entry(
                "blo_newton_pinv (per-pair)",
                "epa_ng_tpu/ops/pallas_blo.py:104",
                ms_tiers["pinv_stream"]["per_pair_launches"],
                ppar["per_pair"],
                launches_memsave=ms_launches("per_pair_launches",
                                             ("pinv_stream",)),
                launches_small_reference=ms_small_pp(
                    ("pinv_stream", "pinv_quarter")),
                launches_note="per-pair-shape launches of the +I "
                "--memsave tier of phase 8 (the cell with invariant "
                "columns under GTR+I{0.2}+G4, budget 0)", **team(ppar),
                parity={"per_pair": ppar["per_pair"], **tol}),
            kernel_entry(
                "blo_newton_counted", "epa_ng_tpu/ops/pallas_blo.py:86",
                stats["counted_launches"] + pstats["counted_launches"],
                par["counted"],
                launches_note="counted launches over both DNA main paths; "
                "launches_memsave: every --memsave run of phase 8b, each "
                "launch with its counters",
                launches_memsave=sum(
                    r[t]["counted_launches"] for k, r in ms_wide.items()
                    if k != "control_aa"
                    for t in ("stream", "half", "cover") if t in r),
                **team(par), parity={"counted": par["counted"], **tol}),
            kernel_entry(
                "blo_newton K=20", "epa_ng_tpu/ops/pallas_blo.py:117",
                astats["k20_launches"], apar["blocked"],
                also_replaces="epa_ng_tpu/ops/pallas_blo.py:65",
                launches_memsave=wide_ms("aa"), **wide_mesh("aa_mesh1x1"),
                instantiation="LG+G4{0.8}: K = 20, one matrix, R = 4",
                **team(apar), parity={**shapes(apar), **tol}),
            kernel_entry(
                "blo_newton mixture", "epa_ng_tpu/ops/pallas_blo.py:117",
                mstats["mixture_launches"], mpar["blocked"],
                also_replaces="epa_ng_tpu/ops/pallas_blo.py:65",
                launches_memsave=wide_ms("mix"),
                **wide_mesh("mix_mesh1x1"),
                instantiation=f"{MIX_MODEL}: K = 20, per-rate tables and "
                "tip, R = 4", **team(mpar),
                parity={**shapes(mpar), **tol}),
            kernel_entry(
                "blo_newton_pinv K=20", "epa_ng_tpu/ops/pallas_blo.py:174",
                aa_ic["pinv_launches"], appar["blocked"],
                also_replaces="epa_ng_tpu/ops/pallas_blo.py:104",
                launches_memsave=wide_ms("aa_pinv"),
                **wide_mesh("aa_pinv_mesh1x1"),
                instantiation="LG+I{0.2}+G4{0.8}: K = 20 with +I, R = 4",
                launches_note="launches of the card's LG+IC+G4 small "
                "reference run (phase 5): protein +I has no main path of "
                "its own", **team(appar),
                parity={**shapes(appar), **tol}),
            kernel_entry(
                "blo_newton R=16", "epa_ng_tpu/ops/pallas_blo.py:117",
                gstats["past8_launches"], gpar["blocked"],
                also_replaces="epa_ng_tpu/ops/pallas_blo.py:65",
                launches_memsave=wide_ms("g16"),
                launches_exact_budgets={k: v["launches"]
                                        for k, v in budgets.items()},
                instantiation="GTR+G16: K = 4, the runtime-R instantiation, "
                "R = 16", **team(gpar), parity={**shapes(gpar), **tol}),
            kernel_entry(
                "blo_newton_pinv R=16", "epa_ng_tpu/ops/pallas_blo.py:174",
                r10["past8_launches"], gppar["blocked"],
                also_replaces="epa_ng_tpu/ops/pallas_blo.py:104",
                launches_memsave=wide_ms("g16_pinv"),
                instantiation="GTR+I{0.2}+G16: K = 4 with +I, the runtime-R "
                "instantiation, R = 16",
                launches_note="launches of the card's +I+R10 small "
                "reference run (phase 5): K = 4 +I past 8 rates has no "
                "main path of its own", **team(gppar),
                parity={**shapes(gppar), **tol}),
            kernel_entry(
                "blo_newton K=20 R=16", "epa_ng_tpu/ops/pallas_blo.py:117",
                agstats["cluster_launches"], agpar["blocked"],
                also_replaces="epa_ng_tpu/ops/pallas_blo.py:65",
                launches_memsave=wide_ms("aa_g16"),
                **wide_mesh("aa_g16_mesh1x1", **{
                    "aa_g16_1x4": mesh_aa_g16["1x4"]["blocked_launches"],
                    "aa_g16_1x4_exact_redo":
                        mesh_aa_g16["exact_redo"]["per_pair_launches"]}),
                instantiation="LG+G16{0.8}: K = 20, a cluster of 2 CTAs a "
                "pair, 8 rates each, R = 16", **team(agpar),
                parity={**shapes(agpar), **tol}),
            kernel_entry(
                "blo_newton_pinv K=20 R=16",
                "epa_ng_tpu/ops/pallas_blo.py:174",
                agpstats["cluster_launches"], agppar["blocked"],
                also_replaces="epa_ng_tpu/ops/pallas_blo.py:104",
                launches_memsave=wide_ms("aa_pinv_g16"),
                instantiation="LG+I{0.2}+G16{0.8}: K = 20 with +I, a "
                "cluster of 2 CTAs a pair, R = 16", **team(agppar),
                parity={**shapes(agppar), **tol}),
            kernel_entry(
                "blo_newton mixture R=16", "epa_ng_tpu/ops/pallas_blo.py:117",
                m16stats["cluster_launches"], m16par["blocked"],
                also_replaces="epa_ng_tpu/ops/pallas_blo.py:65",
                launches_memsave=wide_ms("mix16"),
                instantiation=f"{MIX16_MODEL}: K = 20, per-rate tables and "
                "tip, a cluster of 2 CTAs a pair, R = 16", **team(m16par),
                parity={**shapes(m16par), **tol}),
            kernel_entry(
                "blo_newton mixture R=32", "epa_ng_tpu/ops/pallas_blo.py:117",
                m32["cluster_launches"], m32par["blocked"],
                also_replaces="epa_ng_tpu/ops/pallas_blo.py:65",
                instantiation=f"{MIX32_MODEL}: K = 20, per-rate tables and "
                "tip, a cluster of 4 CTAs a pair, R = 32",
                launches_note="launches of the card's 32-component mixture "
                "small reference run (phase 5): it has no main path of its "
                "own", **team(m32par), parity={**shapes(m32par), **tol}),
        ]
        for root, _, files in os.walk(OUT):
            for f in files:
                if f.endswith(".fasta"):
                    os.remove(os.path.join(root, f))
        print(f"total: {time.perf_counter() - t_start:.1f} s; by phase: "
              f"{json.dumps({k: round(v, 1) for k, v in phase_s.items()})}",
              flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
