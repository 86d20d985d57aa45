"""Command-line entry point of the PyTorch/CUDA port, with epa-ng-tpu's flags.

Flags, groups and mutual exclusions are the JAX package's (which mirror the
reference's CLI11 app, src/main.cpp:96-556), plus ``--device`` (the card by
default, ``cpu`` for the plain paths). ``--pallas auto|on|off`` keeps its
name and selects the CUDA Newton kernel. ``--mesh DPxEP`` shards this
process' placement over its local cards (``--device cpu``: every shard on
the CPU); ``--distributed`` joins a ``torch.distributed`` process group
(gloo) in which each process places a contiguous shard of the query file
and rank 0 merges the jplace fragments; ``--adaptive-split`` sizes those
shards by each process' measured placement rate.

Run as ``python -m epa_ng_tpu_torch.cli ...``.
"""

from __future__ import annotations

import argparse
import logging
import os
import shlex
import sys
import time
from typing import Optional

from epa_ng_tpu_torch import __version__
from epa_ng_tpu_torch.utils.options import NumericalScaling, Options

log = logging.getLogger("epa_ng_tpu_torch")

# machine-readable stats of the last completed placement run (float
# seconds; the logged "Time spent placing" mirrors the reference's
# integer-seconds format, src/main.cpp:545). Read by chip_smoke.py.
LAST_RUN_STATS: dict = {}
# the pipeline's stages in the end-of-run stage line (utils/timer.py)
STAGES = ("read", "read.scan", "dispatch", "write", "finalize",
          "finalize.sync", "emit")

BANNER = r"""
    ______ ____   ___  ______ ____   __  __      ______ ____   __  __
   / ____// __ \ /   |/_  __// __ \ / / / /     /_  __// __ \ / / / /
  / __/  / /_/ // /| | / /  / /_/ // / / /______ / /  / /_/ // / / /
 / /___ / ____// ___ |/ /  / _, _// /_/ //_____// /  / ____// /_/ /
/_____//_/    /_/  |_/_/  /_/ |_| \____/       /_/  /_/     \____/
"""


def _nonneg_float(s: str) -> float:
    v = float(s)
    if v < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {s}")
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="epa-ng-tpu-torch",
        description="Massively-Parallel Evolutionary Placement "
                    "(PyTorch/CUDA port of epa-ng-tpu)")
    p.add_argument("-v", "--version", action="store_true",
                   help="Display version.")
    p.add_argument("--verbose", action="store_true",
                   help="Display debug output.")

    conv = p.add_argument_group("Convert")
    conv.add_argument("-c", "--bfast", metavar="FILE",
                      help="Convert the given fasta file to bfast format.")
    conv.add_argument("-B", "--dump-binary", action="store_true",
                      help="Binary dump mode: write ref. tree CLV store in "
                           "binary format then exit. NOTE: not compatible "
                           "with premasking!")
    conv.add_argument("--split", nargs="+", metavar="MSA",
                      help="Takes a reference MSA and combined ref+query "
                           "MSA(s); outputs query.fasta and reference.fasta. "
                           "Usage: --split ref_alignment query_alignments+")

    inp = p.add_argument_group("Input")
    inp.add_argument("-t", "--tree", help="Path to Reference Tree file.")
    inp.add_argument("-s", "--ref-msa", "--msa", dest="ref_msa",
                     help="Path to Reference MSA file.")
    inp.add_argument("-b", "--binary",
                     help="Path to binary reference file, as created using "
                          "--dump-binary.")
    inp.add_argument("-q", "--query", help="Path to Query MSA file.")
    inp.add_argument("-m", "--model", default=None,
                     help="Description string of the model to be used, or a "
                          "RAxML_info / raxml-ng .bestModel / IQ-TREE file.")

    out = p.add_argument_group("Output")
    out.add_argument("-w", "--outdir", "--out-dir", dest="outdir",
                     default="./", help="Path to output directory.")
    out.add_argument("--tmp", default="", help="Path to temporary directory.")
    out.add_argument("--filter-acc-lwr", type=float, default=None,
                     help="Accumulated likelihood weight after which further "
                          "placements are discarded.")
    out.add_argument("--filter-min-lwr", type=float, default=None,
                     help="Minimum likelihood weight below which a placement "
                          "is discarded.")
    out.add_argument("--filter-min", type=int, default=None,
                     help="Minimum number of placements per sequence.")
    out.add_argument("--filter-max", type=int, default=None,
                     help="Maximum number of placements per sequence.")
    out.add_argument("--precision", type=int, default=None,
                     help="Output decimal point precision.")
    out.add_argument("--redo", action="store_true",
                     help="Overwrite existing files.")
    out.add_argument("--preserve-rooting", choices=["on", "off"],
                     default="on",
                     help="Preserve the rooting of rooted trees.")
    out.add_argument("--out-file", default="epa_result.jplace",
                     help="Name of the jplace output file.")

    comp = p.add_argument_group("Compute")
    comp.add_argument("-g", "--dyn-heur", type=float, default=None,
                      metavar="X",
                      help="Two-phase heuristic, candidate edges by "
                           "accumulative LWR threshold (default 0.99999).")
    comp.add_argument("-G", "--fix-heur", type=float, default=None,
                      metavar="X",
                      help="Two-phase heuristic, candidate edges by "
                           "percentage of total edges.")
    comp.add_argument("--baseball-heur", action="store_true",
                      help="Baseball heuristic as known from pplacer. "
                           "strike_box=3, max_strikes=6, max_pitches=40.")
    comp.add_argument("--no-heur", action="store_true",
                      help="Disables heuristic preplacement completely.")
    comp.add_argument("--chunk-size", type=int, default=None,
                      help="Number of query sequences to read at a time.")
    comp.add_argument("--raxml-blo", action="store_true",
                      help="Old-style independent branch length optimization "
                           "instead of the sliding approach.")
    comp.add_argument("--opt-model", action="store_true",
                      help="ML-evaluate free model parameters and reference "
                           "tree branch lengths before placement.")
    comp.add_argument("--no-pre-mask", action="store_true",
                      help="Do NOT pre-mask sequences.")
    comp.add_argument("--rate-scalers", choices=["on", "off", "auto"],
                      default="auto",
                      help="Accepted for CLI parity; the port always uses "
                           "per-(rate, site) log-scale accumulators.")
    comp.add_argument("-T", "--threads", type=int, default=0,
                      help="Accepted for CLI parity; ignored.")
    comp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                      help="Where to place: the GPU (default) or the CPU.")
    comp.add_argument("--compute-dtype", choices=["f32", "f64"],
                      default=None,
                      help="Device compute precision (default f32 on "
                           "cuda, f64 on cpu).")
    comp.add_argument("--blo-block", type=int, default=None,
                      help="Batch size for the thorough-placement Newton "
                           "stage.")
    comp.add_argument("--memsave", action="store_true",
                      help="Out-of-core mode for trees whose tensors "
                           "exceed device memory: the reference state "
                           "stays in host RAM and streams to the device "
                           "per chunk (the analog of the reference's -b "
                           "CLV paging).")
    comp.add_argument("--memsave-budget", type=_nonneg_float, default=None,
                      metavar="GB",
                      help="--memsave device-cache budget in GB: a prefix "
                           "of the reference-state tensors stays "
                           "device-resident and only the rest streams "
                           "(default: auto from device memory; 0 = pure "
                           "streaming).")
    comp.add_argument("--lookup-dtype", choices=["auto", "bf16"],
                      default=None,
                      help="Preplacement lookup-table storage: bf16 halves "
                           "its device footprint on huge trees "
                           "(ranking-only precision impact).")
    comp.add_argument("--fused-topk", type=int, default=None,
                      help="Static candidate budget of the fused placement "
                           "step under the dynamic heuristic (saturated "
                           "queries re-run wider).")
    comp.add_argument("--pallas", choices=["auto", "on", "off"],
                      default=None,
                      help="Newton-kernel dispatch (name kept from "
                           "epa-ng-tpu; selects the CUDA kernel): auto "
                           "(default; used whenever supported), on (error "
                           "if unsupported), off (always the torch "
                           "Newton).")
    comp.add_argument("--adaptive-split", action="store_true",
                      help="Multi-process runs: shard the query file "
                           "proportionally to each process' measured "
                           "placement rate (a short synthetic "
                           "calibration) instead of evenly — the "
                           "runtime consumer of the reference's "
                           "difficulty-proportional scheduler.")
    comp.add_argument("--mesh", default=None, metavar="DPxEP",
                      help="Shard this process' placement over a local "
                           "device mesh, e.g. 4x2: queries data-parallel "
                           "over DP cards, lookup/BLO tensors edge-"
                           "sharded over EP cards (big-tree memory "
                           "scaling; DP a power of two, DPxEP distinct "
                           "local cards; with --device cpu every shard "
                           "on the CPU).")
    comp.add_argument("--distributed", nargs="?", const="auto", default=None,
                      metavar="COORD,N,IDX",
                      help="Join a torch.distributed process group (gloo) "
                           "for a multi-process run: no value = from the "
                           "environment (torchrun's, or SLURM's or "
                           "OpenMPI's rank and size with MASTER_ADDR and "
                           "MASTER_PORT), or 'coordinator:port,num_procs,"
                           "process_id' explicitly. Alternatively set "
                           "EPA_NG_TPU_DISTRIBUTED. (The analog of the "
                           "reference's MPI_Init, src/main.cpp:53.)")
    return p


def _parse_mesh_spec(spec: str) -> tuple:
    """'DPxEP' -> (dp, ep), both >= 1."""
    try:
        dp_s, ep_s = spec.lower().split("x", 1)
        dp, ep = int(dp_s), int(ep_s)
    except ValueError:
        raise ValueError("want DPxEP, e.g. 4x2") from None
    if dp < 1 or ep < 1:
        raise ValueError("dp and ep must be >= 1")
    return dp, ep


# (rank, size) variables of the launchers that --distributed auto reads
# besides torchrun's RANK / WORLD_SIZE
_LAUNCHER_RANKS = (("SLURM_PROCID", "SLURM_NTASKS"),
                   ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"))


def maybe_init_distributed(spec: Optional[str]) -> bool:
    """``torch.distributed.init_process_group("gloo", ...)`` from
    --distributed or EPA_NG_TPU_DISTRIBUTED; returns whether it
    initialized a group. Must run before logging (per-rank log files)."""
    spec = spec or os.environ.get("EPA_NG_TPU_DISTRIBUTED") or None
    if spec is None:
        return False
    import torch.distributed as dist
    env = os.environ
    if spec in ("auto", "1", "true"):
        if "RANK" in env and "WORLD_SIZE" in env:   # torchrun
            dist.init_process_group("gloo", init_method="env://")
            return True
        found = [(r, n) for r, n in _LAUNCHER_RANKS if r in env and n in env]
        if not found or not ("MASTER_ADDR" in env and "MASTER_PORT" in env):
            raise SystemExit(
                "Error: --distributed auto found no torchrun environment "
                "(RANK, WORLD_SIZE), nor SLURM's or OpenMPI's rank and size "
                "with MASTER_ADDR and MASTER_PORT")
        rank, size = found[0]
        dist.init_process_group(
            "gloo", init_method=f"tcp://{env['MASTER_ADDR']}:"
                                f"{env['MASTER_PORT']}",
            rank=int(env[rank]), world_size=int(env[size]))
        return True
    try:
        coord, num, idx = spec.rsplit(",", 2)
        num, idx = int(num), int(idx)
        if not (coord and num >= 1 and 0 <= idx < num):
            raise ValueError(spec)
        dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                                world_size=num, rank=idx)
    except ValueError as e:
        raise SystemExit(
            f"Error: bad --distributed spec {spec!r} "
            "(want coordinator:port,num_procs,process_id)") from e
    return True


def options_from_args(args) -> Options:
    o = Options()
    excl = [bool(args.dyn_heur is not None), bool(args.fix_heur is not None),
            args.baseball_heur, args.no_heur]
    if sum(excl) > 1:
        raise SystemExit("Error: --dyn-heur, --fix-heur, --baseball-heur and "
                         "--no-heur are mutually exclusive")
    if args.filter_acc_lwr is not None and args.filter_min_lwr is not None:
        raise SystemExit("Error: --filter-acc-lwr and --filter-min-lwr are "
                         "mutually exclusive")
    if args.binary and (args.tree or args.ref_msa):
        raise SystemExit("Error: --binary excludes --tree/--ref-msa")

    if args.filter_acc_lwr is not None:
        o.acc_threshold = True
        o.support_threshold = args.filter_acc_lwr
    if args.filter_min_lwr is not None:
        o.acc_threshold = False
        o.support_threshold = args.filter_min_lwr
    if args.filter_min is not None:
        o.filter_min = args.filter_min
    if args.filter_max is not None:
        o.filter_max = args.filter_max
    if o.filter_min > o.filter_max:
        raise SystemExit("Error: filter-min must not exceed filter-max!")
    if args.precision is not None:
        o.precision = args.precision
    if args.dyn_heur is not None:
        o.prescoring = True
        o.prescoring_by_percentage = False
        o.prescoring_threshold = args.dyn_heur
    if args.fix_heur is not None:
        o.prescoring = True
        o.prescoring_by_percentage = True
        o.prescoring_threshold = args.fix_heur
    if args.baseball_heur:
        o.baseball = True
    if args.no_heur:
        o.prescoring = False
    if args.chunk_size is not None:
        o.chunk_size = args.chunk_size
    if args.raxml_blo:
        o.sliding_blo = False
    if args.opt_model:
        o.opt_model = True
    if args.no_pre_mask:
        o.premasking = False
        o.repeats = True
    o.scaling = NumericalScaling(args.rate_scalers)
    o.preserve_rooting = args.preserve_rooting == "on"
    o.tmp_dir = args.tmp
    o.dump_binary_mode = args.dump_binary
    o.load_binary_mode = bool(args.binary)
    o.num_threads = args.threads
    if args.compute_dtype is not None:
        o.compute_dtype = args.compute_dtype
    if args.blo_block is not None:
        o.blo_block = args.blo_block
    if args.lookup_dtype is not None:
        o.lookup_dtype = args.lookup_dtype
    if args.fused_topk is not None:
        o.fused_topk = args.fused_topk
    if args.pallas is not None:
        o.pallas = args.pallas
    o.memsave = args.memsave
    if args.memsave_budget is not None:
        o.memsave_budget_gb = args.memsave_budget
    return o


def _default_dtype(device: str) -> str:
    """f32 on the card, f64 on the CPU."""
    dtype = "f64" if device == "cpu" else "f32"
    log.info("Selected: compute dtype %s (device: %s)", dtype, device)
    return dtype


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    invocation = "epa-ng-tpu-torch " + " ".join(shlex.quote(a) for a in argv)
    start_all = time.time()

    if args.version:
        print(f"epa-ng-tpu-torch v{__version__}")
        return 0
    if not argv:
        build_parser().print_help()
        return 0

    options = options_from_args(args)
    outdir = args.outdir
    os.makedirs(outdir, exist_ok=True)

    # conversion modes need no log file
    if args.bfast:
        from epa_ng_tpu_torch.io.bfast import fasta_to_bfast
        print("Converting given FASTA file to BFAST format...")
        result = fasta_to_bfast(args.bfast, outdir)
        print(f"Resulting bfast file was written to: {result}")
        return 0

    if args.split:
        if len(args.split) < 2:
            print("Incorrect number of inputs! Usage: epa-ng-tpu-torch "
                  "--split ref_alignment query_alignments+", file=sys.stderr)
            return 1
        from epa_ng_tpu_torch.utils.split import split
        ref, queries = args.split[0], args.split[1:]
        print(f"Splitting files based on reference: {ref}")
        split(ref, queries, outdir)
        return 0

    # the multi-process topology must be known before logging (per-rank
    # log files, rank-0-only stdout — reference: src/main.cpp:53-64,308-320)
    owns_group = maybe_init_distributed(args.distributed)
    try:
        return _place(args, options, invocation, start_all)
    finally:
        if owns_group:
            import torch.distributed as dist
            dist.destroy_process_group()


def _place(args, options, invocation, start_all) -> int:
    """The run after the conversion modes: build or load the reference
    state, then place the query file (this process' shard of it)."""
    import torch

    from epa_ng_tpu_torch.parallel.dist import process_info
    outdir = args.outdir
    pidx, pcount = process_info()
    from epa_ng_tpu_torch.utils.logging import setup_logging
    setup_logging(outdir, verbose=args.verbose, redo=args.redo,
                  process_index=pidx, process_count=pcount)
    log.info(BANNER + f"(PyTorch/CUDA port, v{__version__})\n")

    # guard the RESULT file itself, not only the log (reference:
    # src/main.cpp:315-320)
    if args.query and not args.redo:
        result_file = os.path.join(outdir, args.out_file)
        if os.path.exists(result_file):
            log.error("%s already exists! To overwrite existing output "
                      "files, rerun with --redo", result_file)
            return 1

    if args.device == "cuda" and not torch.cuda.is_available():
        log.error("--device cuda: no CUDA device is available (use "
                  "--device cpu)")
        return 1
    device = torch.device(args.device)
    if args.compute_dtype is None:
        options.compute_dtype = _default_dtype(args.device)

    from epa_ng_tpu_torch.core.engine import (PlacementEngine,
                                              _check_device_model)
    from epa_ng_tpu_torch.io import fasta as fio
    from epa_ng_tpu_torch.models import Model

    # under --mesh the reference state is BUILT on the CPU (host RAM) in
    # the run's dtype and only its ep shards reach the cards (attach_mesh):
    # a tree whose tensors exceed one card must not run out of device
    # memory during the build, before sharding could help
    build_device = device
    if args.mesh:
        # every knowable incompatibility is checked BEFORE the (possibly
        # minutes-long) reference-state build, not after it
        try:
            dp, ep = _parse_mesh_spec(args.mesh)
            if dp & (dp - 1):
                raise ValueError("dp must be a power of two")
            if device.type == "cuda":
                n_local = torch.cuda.device_count()
                if dp * ep > n_local:
                    raise ValueError(
                        f"{dp}x{ep} needs {dp * ep} local devices, "
                        f"have {n_local}")
            if options.memsave:
                raise ValueError("--mesh and --memsave are mutually "
                                 "exclusive")
        except ValueError as e:
            log.error("Bad --mesh %r: %s", args.mesh, e)
            return 1
        # distinct local cards, or every shard on the CPU (the analog of
        # XLA's virtual host devices)
        mesh_devices = ([torch.device("cuda", i) for i in range(dp * ep)]
                        if device.type == "cuda" else [device] * (dp * ep))
        build_device = torch.device("cpu")

    if options.memsave:
        # the reference state is built on the CPU and kept in host RAM;
        # placement runs on ``device``
        from epa_ng_tpu_torch.core.memsave import OutOfCoreEngine
        engine_cls = OutOfCoreEngine
        log.info("Selected: out-of-core (--memsave) placement")
    else:
        engine_cls = PlacementEngine

    # --- build or load the reference state
    opt_stats = {}
    if options.load_binary_mode:
        from epa_ng_tpu_torch.io.binary import load_binary
        log.info("Loading from binary: %s", args.binary)
        t_build = time.time()
        try:
            engine = load_binary(args.binary, options, engine_cls=engine_cls,
                                 device=build_device)
            _check_device_model(device, engine.model, options.sliding_blo)
        except NotImplementedError as e:
            log.error("%s", e)
            return 2
        except ValueError as e:
            log.error("%s", e)
            return 1
        build_s = time.time() - t_build
        tree = engine.tree
        qry_info = fio.make_msa_info(args.query) if args.query else None
        if options.premasking:
            log.info("Premasking is limited to per-query ranges in binary "
                     "mode (the CLV store is built unmasked)")
            if qry_info is not None:
                # so the reader keeps the columns that are gaps in every
                # query: the store has them (the JAX package drops them
                # and then refuses the reads' length)
                qry_info.gap_mask[:] = False
    else:
        if not args.tree or not args.ref_msa:
            print("Error: --tree and --ref-msa (or --binary) are required",
                  file=sys.stderr)
            return 1
        if args.model is None:
            log.error(
                "A model has to be explicitly specified! You may specify it "
                "generically (GTR+G), however parameters will not be "
                "optimized. We recommend evaluating parameters with raxml-ng "
                "--evaluate and passing the resulting .bestModel file to "
                "--model.")
            return 1

        model_desc = args.model
        if os.path.isfile(model_desc):
            from epa_ng_tpu_torch.io.model_files import parse_model_file
            log.info("Selected: Specified model file: %s", model_desc)
            model_desc = parse_model_file(model_desc)
        log.info("Selected: Specified model: %s", model_desc)
        model = Model.from_string(model_desc)

        from epa_ng_tpu_torch.tree import Tree
        ref_info = fio.make_msa_info(args.ref_msa)
        qry_info = fio.make_msa_info(args.query) if args.query else None

        premask = options.premasking and not options.dump_binary_mode
        if qry_info is not None and premask:
            if ref_info.sites != qry_info.sites:
                log.error(
                    "The reference and query alignment files do not seem to "
                    "have the same alignment width! (%d vs. %d). Are the "
                    "query sequences not aligned?", ref_info.sites,
                    qry_info.sites)
                return 1
            fio.MSAInfo.or_mask(ref_info, qry_info)

        ref_msa = fio.build_msa_from_file(args.ref_msa, ref_info, premask)
        tree = Tree.from_file(args.tree, options.preserve_rooting)
        if options.opt_model:
            from epa_ng_tpu_torch.core.evaluate import optimize_model
            log.info("Optimizing model parameters and branch lengths")
            t_opt = time.time()
            opt = {}
            optimize_model(tree, ref_msa, model,
                           dtype=(torch.float64
                                  if options.compute_dtype == "f64"
                                  else torch.float32), device=device,
                           stats=opt)
            opt_stats = dict(opt_model_s=time.time() - t_opt,
                             opt_model_alpha=float(model.alpha),
                             **{f"opt_model_{k}": v for k, v in opt.items()})
        t_build = time.time()
        try:
            # a model that the card does not take fails here, before a
            # build on the CPU
            _check_device_model(device, model, options.sliding_blo)
            engine = engine_cls(tree, ref_msa, model, options,
                                device=build_device)
        except NotImplementedError as e:
            log.error("%s", e)
            return 2
        except ValueError as e:
            log.error("%s", e)
            return 1
        build_s = time.time() - t_build

        if options.dump_binary_mode:
            from epa_ng_tpu_torch.io.binary import dump_binary
            log.info("Writing to binary")
            dump_file = os.path.join(outdir, "epa_binary_file")
            with open(args.tree) as f:
                dump_binary(engine, dump_file, f.read())
            log.info("Binary CLV store written to: %s.npz", dump_file)
            LAST_RUN_STATS.clear()
            LAST_RUN_STATS.update(build_s=build_s,
                                  total_s=time.time() - start_all,
                                  **opt_stats)
            return 0

    if not args.query:
        log.error("Must supply query file! Combined MSA files not currently "
                  "supported, please split them and specify using -s and -q.")
        return 1

    if args.mesh:
        # shard this process' placement over a local device mesh
        from epa_ng_tpu_torch.parallel.mesh import make_mesh
        try:
            engine.attach_mesh(make_mesh(dp, ep, mesh_devices))
        except ValueError as e:
            log.error("Bad --mesh %r: %s", args.mesh, e)
            return 1

    # --- placement loop (the analog of simple_mpi, src/core/place.cpp:173)
    from epa_ng_tpu_torch.core import chunk as chunk_mod
    from epa_ng_tpu_torch.core.pipeline import StreamingPipeline
    from epa_ng_tpu_torch.io.jplace import JplaceWriter
    from epa_ng_tpu_torch.ops.blo_kernel import blo_newton
    from epa_ng_tpu_torch.parallel import dist
    from epa_ng_tpu_torch.utils import timer

    # --adaptive-split: rate-proportional query shards (the runtime
    # consumer of the scheduling math, parallel.schedule). Each process
    # measures its own placement rate on a synthetic calibration chunk;
    # the rates are gathered over the process group (or forced via
    # EPA_NG_TPU_CALIBRATION_RATES="r0,r1,..." for tests and clusters of
    # known skew) and every process derives the identical contiguous split
    shard = None
    if args.adaptive_split and pcount > 1:
        from epa_ng_tpu_torch.parallel import schedule as sched
        forced = os.environ.get("EPA_NG_TPU_CALIBRATION_RATES")
        if forced:
            rates = [float(x) for x in forced.split(",")]
            if len(rates) != pcount:
                log.error("EPA_NG_TPU_CALIBRATION_RATES has %d entries "
                          "for %d processes", len(rates), pcount)
                return 1
        else:
            rates = dist.all_gather_floats(engine.calibration_rate())
            if rates is None or len(rates) != pcount:
                # env-topology ranks cannot exchange rates; keep even
                log.warning("--adaptive-split: no torch.distributed "
                            "process group to exchange rates; keeping the "
                            "even split (set EPA_NG_TPU_CALIBRATION_RATES "
                            "to force)")
                rates = [1.0] * pcount
        shares = sched.proportional_shares(qry_info.sequences, rates)
        shard = shares[pidx]
        log.info("Adaptive split: rates %s -> shards %s (this rank: "
                 "offset %d, %d queries)",
                 [round(r, 1) for r in rates], shares, shard[0], shard[1])

    # the device memory that the built engine holds, and the peak while it
    # places (the allocator's counts, for the whole process)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        mem_at_place = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    at_place = blo_newton.counts()
    start_place = time.time()
    reader = fio.make_msa_reader(args.query, qry_info, options.premasking,
                                 split=True, process_index=pidx,
                                 process_count=pcount, shard=shard)
    out_file = args.out_file
    shard_name = out_file if pcount == 1 else f"{out_file}.shard{pidx}"
    # --tmp: host-local files (e.g. node-local SSD) hold the shards
    # (reference: src/main.cpp --tmp semantics)
    shard_dir = options.tmp_dir if (pcount > 1 and options.tmp_dir) else outdir
    log.info("Output file: %s", os.path.join(outdir, out_file))
    tree_string = tree.numbered_newick(options.precision)
    writer = JplaceWriter(shard_dir, shard_name, tree_string, invocation,
                          tree.mapper, precision=options.precision,
                          fragment=(pcount > 1))

    progress = {"done": 0, "reads": 0}

    def read_chunk():
        # matrix-native readers hand back an EncodedChunk straight from the
        # native scanner; MSA readers go through the vectorized encoder
        read_encoded = getattr(reader, "read_next_encoded", None)
        if read_encoded is not None:
            ec = read_encoded(options.chunk_size, engine.model.num_states)
            if ec is None or not len(ec):
                return None
            ec = engine.check_chunk(ec)
        else:
            chunk = reader.read_next(options.chunk_size)
            if not len(chunk):
                return None
            ec = engine.encode_msa(chunk)
        # collapse duplicate reads: place once, report every name
        # (reference: src/set_manipulators.cpp:208-226)
        return chunk_mod.collapse(ec)

    def compute(ec, index):
        # dispatch only: the device crunches this chunk while the writer
        # thread syncs + assembles the previous one (finalize_chunk)
        offset = progress["done"] + reader.local_seq_offset
        handle = engine.place_encoded_async(ec, seq_id_offset=offset)
        progress["done"] += len(ec)
        return handle, ec.num_reads

    def write(item):
        handle, nreads = item
        writer.write(engine.finalize_chunk(handle))
        progress["reads"] += nreads
        log.info("%d Sequences done!", progress["reads"])

    spans_before = timer.RECORDER.totals()
    StreamingPipeline(read_chunk, compute, write).run()
    writer.close()
    stages = timer.since(spans_before, timer.RECORDER.totals())
    wall = lambda k: stages.get(k, (0, 0.0, 0.0))[1]
    memory = {}
    if on_card:
        torch.cuda.synchronize(device)
        memory = dict(device_mb_at_place=mem_at_place / 1e6,
                      device_peak_mb=(torch.cuda.max_memory_allocated(device)
                                      / 1e6))
    log.info("Stage times, wall / CPU: %s; waiting for a chunk %.2fs, for "
             "the writer %.2fs", ", ".join(
                 "%s %.2fs / %.2fs" % (k, *stages.get(k, (0, 0.0, 0.0))[1:])
                 for k in STAGES), wall("wait_chunk"), wall("wait_writer"))

    if pcount > 1:
        dist.barrier()
        if pidx == 0:
            dist.merge_jplace_shards(shard_dir, out_file, pcount,
                                     tree_string, invocation,
                                     final_dir=outdir)

    LAST_RUN_STATS.clear()
    LAST_RUN_STATS.update(
        build_s=build_s,
        # --opt-model: its seconds (opt_model_s, the JAX bench's name),
        # starting and final logl, alpha and work (opt_model_*)
        **opt_stats,
        placing_s=time.time() - start_place,
        total_s=time.time() - start_all,
        reads=progress["reads"],
        sequences=progress["done"],
        # the stages' wall seconds from the span recorder (utils/timer.py):
        # write_s splits into device sync + result assembly (finalize) and
        # jplace text formatting + file write (emit, with the closing)
        read_s=wall("read"),
        compute_s=wall("dispatch"),
        write_s=wall("write"),
        finalize_s=wall("finalize"),
        emit_s=wall("emit"),
        # every span name's (count, wall s, CPU s) over the run
        stages=stages,
        # the CUDA kernel's executed Newton work, from its counters, and
        # the calls of the torch twin (twin_launches)
        **engine.newton_work.totals(),
        # the kernel's launches while placing, by call shape: blocked (the
        # fused step, on every shard of a mesh) and per-pair (--memsave's
        # streamed windows, a mesh's exact redo)
        **{k: blo_newton.counts()[k] - at_place[k]
           for k in ("blocked_launches", "per_pair_launches")},
        **memory,
        # --memsave: the cached prefix, the pairs placed against it and on
        # streamed windows, and the bytes streamed to the device
        **(engine.memsave_stats() if options.memsave else {}),
        # the run's place in a multi-process job and its local mesh
        process_index=pidx, process_count=pcount,
        mesh=f"{dp}x{ep}" if args.mesh else None,
        adaptive_shard=None if shard is None else list(shard))
    st = LAST_RUN_STATS
    log.info("Newton: %d blocked and %d per-pair kernel launches, %d "
             "torch-twin calls", st["blocked_launches"],
             st["per_pair_launches"], st["twin_launches"])
    log.info("Time spent placing: %ds", int(time.time() - start_place))
    log.info("Elapsed Time: %ds", int(time.time() - start_all))
    return 0


if __name__ == "__main__":
    sys.exit(main())
