"""The placement engine: preplace -> heuristic -> thorough place -> LWR ->
filter, per streamed query chunk.

The reference's ``simple_mpi`` loop (src/core/place.cpp:173-251) as two
device stages:

1. one [queries x edges] GEMM against the precomputed lookup tensor
   (preplacement), and
2. one batched Newton over the compacted candidate pairs (thorough
   placement) — the CUDA kernel on the card in f32 (ops.blo_kernel), the
   torch twin elsewhere (ops.newton),

fused into one step per chunk (parallel.mesh.placement_step), with the
ragged candidate sets padded to fixed-size blocks.

On cuda the port runs DNA and protein models, single-matrix with or
without +I, and protein matrix mixtures (LG4M/LG4X), through the kernel
at up to its rate cap (``ops.blo_kernel.MAX_RATES``: 312 categories at
K = 4, 64 at K = 20, a single matrix or a mixture); binary and genotype
models, ``--raxml-blo`` and more rate categories than the cap through the
torch twin, as the JAX package runs them on its XLA twin
(``ops.blo_kernel.twin_route``).
"""

from __future__ import annotations

import contextlib
import logging
import math
from typing import Optional

import numpy as np
import torch

from epa_ng_tpu_torch.core import chunk as chunk_mod, heuristics
from epa_ng_tpu_torch.core.chunk import EncodedChunk
from epa_ng_tpu_torch.core.lwr import (ChunkPlacements, PQuery,
                                       compute_and_set_lwr, filter_pqueries)
from epa_ng_tpu_torch.io.fasta import MSA
from epa_ng_tpu_torch.models import Model
from epa_ng_tpu_torch.models.charmaps import lookup_chars, lookup_tip_clvs
from epa_ng_tpu_torch.models.model import ParamValue
from epa_ng_tpu_torch.ops import blo_kernel
from epa_ng_tpu_torch.ops import clv as clv_ops
from epa_ng_tpu_torch.ops import eigen, likelihood, lookup, newton
from epa_ng_tpu_torch.tree.tree import Tree
from epa_ng_tpu_torch.utils.options import Options
from epa_ng_tpu_torch.utils.timer import span

log = logging.getLogger("epa_ng_tpu_torch")


class PlacementEngine:
    """Holds the reference tree state (edge CLV tensors, lookup tables) on
    one device — or sharded over a mesh of devices (:meth:`attach_mesh`) —
    and places query chunks against it. ``device`` defaults to the card;
    the tests pass ``"cpu"``."""

    def __init__(self, tree: Tree, ref_msa: MSA, model: Model,
                 options: Optional[Options] = None, device="cuda"):
        self.options = options or Options()
        self.tree = tree
        self.model = model
        self.device = torch.device(device)
        self.dtype = (torch.float64 if self.options.compute_dtype == "f64"
                      else torch.float32)

        if model.submodels is not None and (
                model.pinv > 0
                or model.pinv_mode == ParamValue.EMPIRICAL):
            raise ValueError(
                "p-inv is not supported together with matrix-mixture "
                "models (LG4M/LG4X)")
        masks = clv_ops.tip_state_masks(tree, ref_msa, model.num_states)
        if model.empirical_base_freqs:
            model.base_freqs = empirical_frequencies(masks, model.num_states)
            log.info("Using empirical base frequencies: %s", model.base_freqs)

        # invariant-site machinery (only materialized when pinv > 0).
        # Must run BEFORE eigen.decompose: the decomposition snapshots
        # model.pinv (the 1/(1-pinv) time scaling, ops.eigen.pmatrices).
        self._ref_intersection = None
        if model.pinv > 0 or model.pinv_mode == ParamValue.EMPIRICAL:
            inter = masks[0].copy()
            for row in masks[1:]:
                inter &= row
            if model.pinv_mode == ParamValue.EMPIRICAL and model.pinv == 0:
                # +IC outside --opt-model: the empirical proportion of
                # invariant sites (columns whose tip state masks share at
                # least one state; reference grammar:
                # src/core/raxml/Model.cpp:355-376)
                model.pinv = float((inter != 0).mean())
                log.info("Using empirical p-inv: %.6f", model.pinv)
            if model.pinv > 0:
                self._ref_intersection = inter  # [S] uint32
        _check_device_model(self.device, model, self.options.sliding_blo)

        self.eig = eigen.decompose(model)
        self.consts = newton.eig_consts(self.eig, self.dtype, self.device)

        tip_clvs = clv_ops.tip_clv_matrix(tree, ref_msa, model.num_states)
        self.num_sites = ref_msa.num_sites
        self.num_edges = tree.n_edges

        # --- site-pattern compression (the SITE_REPEATS analog,
        # reference: src/io/file_io.cpp:216-220): identical alignment
        # columns yield identical CLV/lookup/BLO columns, so the whole
        # reference-state build runs once per unique (all-tips) column
        # pattern; per-pattern multiplicities weight the ref-tree logl and
        # the derived full-site tensors are gather-expanded where query
        # addressing needs them.
        self._site2pat = None
        self._pat_first_idx = None
        site_weights = None
        if (self.options.pattern_compression
                and not self.options.dump_binary_mode):
            cols = np.ascontiguousarray(masks.T)
            _, first_idx, inverse, counts = np.unique(
                cols, axis=0, return_index=True, return_inverse=True,
                return_counts=True)
            if len(first_idx) < self.num_sites:
                self._site2pat = inverse.reshape(-1).astype(np.int32)
                self._pat_first_idx = first_idx
                tip_clvs = tip_clvs[:, first_idx, :]
                site_weights = counts
                log.info("Site-pattern compression: %d unique of %d "
                         "columns", len(first_idx), self.num_sites)

        inv_logterm = self._inv_logterm_sites()
        if inv_logterm is not None and self._pat_first_idx is not None:
            inv_logterm = inv_logterm[self._index(self._pat_first_idx)]

        self.edges, ref_logl = clv_ops.build_reference_state(
            tree, self.eig, tip_clvs, dtype=self.dtype,
            inv_logterm=inv_logterm, site_weights=site_weights,
            device=self.device)
        self._finish_init(ref_logl)

    @classmethod
    def from_precomputed(cls, tree: Tree, model: Model, options, edges,
                         num_sites: int, ref_intersection=None,
                         device="cuda"):
        """Engine from precomputed edge tensors: ``edges`` has the
        ``EdgeTensors`` fields (U, V [E,R,K,S]; lsU, lsV [E,R,S]; lengths
        [E]) as numpy arrays or tensors — e.g. the JAX engine's, converted
        with ``np.asarray``."""
        self = cls.__new__(cls)
        self.options = options or Options()
        self.tree = tree
        self.model = model
        self.device = torch.device(device)
        self.dtype = (torch.float64 if self.options.compute_dtype == "f64"
                      else torch.float32)
        _check_device_model(self.device, model, self.options.sliding_blo)
        self.eig = eigen.decompose(model)
        self.consts = newton.eig_consts(self.eig, self.dtype, self.device)
        # a copy: the caller's arrays may be read-only views (JAX's)
        as_t = lambda x: torch.tensor(np.asarray(x), dtype=self.dtype,
                                      device=self.device)
        self.edges = clv_ops.EdgeTensors(
            U=as_t(edges.U), V=as_t(edges.V), lsU=as_t(edges.lsU),
            lsV=as_t(edges.lsV), lengths=as_t(edges.lengths))
        self.num_sites = num_sites
        self.num_edges = tree.n_edges
        self._ref_intersection = ref_intersection
        self._site2pat = None        # precomputed stores hold full sites
        self._pat_first_idx = None
        self._finish_init()
        return self

    def attach_mesh(self, mesh):
        """Shard the reference state over a (dp, ep) mesh
        (``parallel.mesh.make_mesh``; CLI: ``--mesh DPxEP``): queries ride
        the ``dp`` axis, the lookup table and BLO store shard over ``ep``,
        so trees whose tensors exceed one card's memory spread across
        cards. The fused dispatch and the wide redo then run the sharded
        step (``parallel.mesh._spmd_step_body``): every shard runs the
        plain engine's functions — on the card the CUDA kernel, where
        :meth:`_use_kernel` says so — on its local rows; the rare
        exact-redo fallback gathers per-pair windows from HOST copies of
        the BLO store (``core.memsave.host_window_thorough``), so no
        full-size device copy survives. The engine then places on the
        mesh's first device. The CLI builds the engine on the CPU under
        --mesh, so only the shards reach the cards."""
        from epa_ng_tpu_torch.core.memsave import (SLAB_PIPELINE_DEPTH,
                                                   _StagingRing)
        from epa_ng_tpu_torch.parallel.mesh import ShardedPlacement
        if self.options.memsave:
            raise ValueError("--mesh and --memsave are mutually exclusive")
        dp = mesh.shape["dp"]
        if dp & (dp - 1):
            raise ValueError("mesh dp axis must be a power of two")
        blo = self.blo
        # --- the mesh host-RAM ceiling, stated and enforced: the process
        # keeps a FULL copy of the BLO store in RAM for the rare exact-redo
        # fallback (the shards on the devices only cover the fused path).
        # ep-sharding divides the device footprint across the mesh but NOT
        # the host footprint: tree size is capped at host RAM per process
        # (the ceiling-breaker is --memsave, exclusive with --mesh).
        # Checked here so the failure is a clear error at attach time, not
        # an OOM kill mid-run.
        need = sum(t.nbytes for t in blo)
        avail = _host_available_bytes()
        if avail is not None and need > 0.6 * avail:
            raise RuntimeError(
                f"--mesh keeps a full host-RAM copy of the reference "
                f"state for the exact-redo fallback: need ~{need / 1e9:.1f}"
                f" GB but only {avail / 1e9:.1f} GB host RAM is available. "
                f"Tree size under --mesh is capped by host RAM per process; "
                f"for larger trees use --memsave (single device).")
        self._tU_h, self._tV_h, self._ls_h, self._lengths_h = (
            t.cpu().contiguous() for t in blo)
        self._sharded = ShardedPlacement(self, mesh)
        # free the unsharded copies; everything on the devices now goes
        # through self._sharded. The small per-chunk state (the constants,
        # the query tips' tables) moves to the mesh's first device.
        self._lookup_table = None
        self._blo = None
        self.device = mesh.grid[0][0]
        self.consts = newton.EigConsts(*(t.to(self.device)
                                         for t in self.consts))
        self._char_clvs = self._char_clvs.to(self.device)
        self.newton_work = blo_kernel.NewtonWork(self.device)
        self._slab_ring = _StagingRing(self.device, SLAB_PIPELINE_DEPTH)
        log.info("Attached %dx%d (dp x ep) device mesh", dp,
                 mesh.shape["ep"])

    def _index(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx), dtype=torch.long,
                               device=self.device)

    def _finish_init(self, ref_logl: Optional[float] = None):
        self._sharded = None
        self._escalations = 0  # chunks rescued by the wide-budget ladder
        # the Newton work the CUDA kernel executed, from its own counters
        # (zero where the torch twin ran instead), and the twin's calls
        self.newton_work = blo_kernel.NewtonWork(self.device)
        # sanity check: finite reference-tree log-likelihood
        # (reference: src/tree/Tree.cpp:49-53)
        self.ref_tree_logl = (float(self._reference_logl())
                              if ref_logl is None else ref_logl)
        if self.model.ascbias_type is not None:
            # reported evaluation logl carries the ASC correction;
            # placement scores do not (raxml/Model.cpp:712-734)
            inv_logls = clv_ops.invariant_pattern_logls(
                self.tree, self.eig, dtype=self.dtype, device=self.device)
            w = (torch.as_tensor(np.asarray(self.model.ascbias_weights),
                                 dtype=self.dtype, device=self.device)
                 if self.model.ascbias_weights is not None else
                 torch.zeros(self.model.num_states, dtype=self.dtype,
                             device=self.device))
            self.ref_tree_logl += float(likelihood.asc_bias_correction(
                inv_logls, self.model.ascbias_type, w, self.num_sites))
        if not np.isfinite(self.ref_tree_logl):
            raise RuntimeError("Tree Log-Likelihood -INF!")
        log.info("Reference tree log-likelihood: %.6f", self.ref_tree_logl)

        self._lookup_table = None
        self._blo = None
        self._char_clvs = torch.as_tensor(
            lookup_tip_clvs(self.model.num_states), dtype=self.dtype,
            device=self.device)
        self._lookup_cols = lookup_chars(self.model.num_states)
        self._col_masks = chunk_mod.col_state_masks(self.model.num_states)

        # placement runs only ever read the lookup table and the
        # eigen-transformed BLO store; the raw edge CLVs (2x the BLO
        # store's footprint) are freed once both are derived
        if not self.options.dump_binary_mode:
            _ = self.lookup_table
            _ = self.blo
            self.edges = None

    # ------------------------------------------------------------------

    def _reference_logl(self) -> float:
        P = eigen.pmatrices(self.eig, self.tree.edge_lengths[:1],
                            dtype=self.dtype, device=self.device)
        as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=self.dtype,
                                         device=self.device)
        et = self.edges
        return float(likelihood.edge_loglikelihood(
            et.U[0], et.lsU[0], et.V[0], et.lsV[0], P[0],
            as_t(self.eig.freqs), as_t(self.eig.weights),
            pinv=self.model.pinv, inv_logterm=self._inv_logterm_sites()))

    def _inv_logterm_sites(self):
        """[S] log(p*pi) for ref-tree invariant sites, or None."""
        if self._ref_intersection is None:
            return None
        state = clv_ops.invariant_states(
            self._ref_intersection[None, :], self.model.num_states)
        return likelihood.make_inv_logterm(state, self.eig.freqs,
                                           self.model.pinv, self.dtype,
                                           self.device)

    def _inv_logfreq_chars(self):
        """[C, S] invariant log-term per (placed char, site); the invariant
        intersection of the extended tree includes the new query tip."""
        S = self.num_sites
        C = len(self._lookup_cols)
        if self._ref_intersection is None:
            return torch.full((C, S), -torch.inf, dtype=self.dtype,
                              device=self.device)
        from epa_ng_tpu_torch.models.charmaps import state_mask_table
        tbl = state_mask_table(self.model.num_states)
        char_masks = np.array([tbl[ord(ch)] for ch in self._lookup_cols],
                              dtype=np.uint32)
        inter = char_masks[:, None] & self._ref_intersection[None, :]
        state = clv_ops.invariant_states(
            inter.reshape(1, -1), self.model.num_states).reshape(C, S)
        out = np.full((C, S), -np.inf)
        ok = state >= 0
        out[ok] = np.log(self.model.pinv * self.eig.freqs[state[ok]])
        return torch.as_tensor(out, dtype=self.dtype, device=self.device)

    def _inv_logfreq_queries(self, qmasks: np.ndarray):
        """[Q, S] invariant log-term per (query, site) for the BLO path."""
        Q, S = qmasks.shape
        if self._ref_intersection is None:
            return np.full((Q, S), -np.inf)
        inter = self._ref_intersection[None, :] & qmasks
        state = clv_ops.invariant_states(
            inter.reshape(1, -1), self.model.num_states).reshape(Q, S)
        out = np.full((Q, S), -np.inf)
        ok = state >= 0
        out[ok] = np.log(self.model.pinv * self.eig.freqs[state[ok]])
        return out

    @property
    def lookup_table(self):
        """[E, C, S] preplacement table (the analog of Lookup_Store, built
        in one shot) — or, with ``lookup_dtype="bf16"``, a (resid bf16,
        mean) split pair."""
        if self._lookup_table is None:
            if self.edges is None:
                raise RuntimeError(
                    "edge tensors were freed; the lookup table must be "
                    "built during engine init")
            et = self.edges
            inv_chars = self._inv_logfreq_chars()
            site_map = None
            if self._site2pat is not None:
                # compressed edge tensors: per-char invariant terms are a
                # function of the column pattern too
                inv_chars = inv_chars[:, self._index(self._pat_first_idx)]
                site_map = self._index(self._site2pat)
            table = lookup.build_lookup_tables(
                self.consts, et.U, et.lsU, et.V, et.lsV, et.lengths,
                self._char_clvs, inv_chars, site_map)
            if self.options.lookup_dtype == "bf16":
                self._lookup_table = lookup.split_table(table, torch.bfloat16)
            else:
                self._lookup_table = table
        return self._lookup_table

    @property
    def blo(self):
        """Eigen-transformed "sumtable store" for the thorough-placement
        path (newton.BloTensors), built on first use."""
        if self._blo is None:
            et = self.edges
            site_map = (None if self._site2pat is None
                        else self._index(self._site2pat))
            self._blo = newton.transform_edges(
                self.consts, et.U, et.lsU, et.V, et.lsV, et.lengths,
                site_map)
        return self._blo

    def _query_tensors_codes(self, codes: np.ndarray):
        """Device tensors for a chunk from its [Q,S] lookup-code matrix:
        eigen-transformed query tips tQ [Q,K,S] (tip CLVs gathered ON
        DEVICE from the per-column CLV rows, chunk.col_state_masks
        exactness argument, so the host transfers one uint8 matrix) and the
        p-inv log term invq [Q,S]."""
        codes_t = torch.as_tensor(np.asarray(codes), device=self.device)
        tQ = _transform_codes(self.consts, self._char_clvs, codes_t)
        if self._ref_intersection is not None and self.model.pinv > 0:
            qmasks = self._col_masks[codes]
            invq = torch.as_tensor(self._inv_logfreq_queries(qmasks),
                                   dtype=self.dtype, device=self.device)
        else:
            invq = torch.full(codes.shape, -torch.inf, dtype=self.dtype,
                              device=self.device)
        return tQ, invq

    def _use_kernel(self) -> bool:
        """Dispatch the Newton stage to the CUDA kernel? On a cuda device
        in f32, unless ``--pallas off`` or the model or mode is one that
        the JAX package runs on its XLA twin (``blo_kernel.twin_route``:
        ``--raxml-blo``, states other than 4 and 20, more rate categories
        than ``blo_kernel.MAX_RATES``), which take the torch twin on the
        card too. What else the kernel does not take
        (``blo_kernel.blo_unsupported``) raises "not yet ported" there
        rather than running the twin. The twin also serves the CPU and
        f64."""
        opt = self.options.pallas
        if opt == "off":
            return False
        if self.device.type != "cuda" or self.dtype != torch.float32:
            if opt == "on":
                raise ValueError(
                    "--pallas on requires a CUDA device and f32")
            return False
        if blo_kernel.twin_route(self.consts, self.options.sliding_blo):
            if opt == "on":
                raise ValueError(
                    "--pallas on requires sliding BLO and a DNA or protein "
                    "model within the kernel's rate cap: the CUDA kernel "
                    "takes no other")
            return False
        why = blo_kernel.blo_unsupported(self.consts,
                                         self.options.sliding_blo)
        if why is not None:
            raise NotImplementedError(
                f"{why}: not yet ported to the CUDA Newton kernel "
                "(--pallas off runs the torch Newton on the card)")
        return True

    # ------------------------------------------------------------------

    def calibration_rate(self, n: int = 256, seed: int = 0) -> float:
        """Measured placement throughput (queries/s) on a synthetic
        read-like chunk — the per-process "difficulty" input of the
        adaptive query sharding (parallel.schedule.proportional_shares;
        the runtime successor of the reference's stage-difficulty
        measurement, src/pipeline/Pipeline.hpp:84-125). Two passes; the
        second is timed, so one-off costs (the kernel's first load, the
        allocator's first requests) stay out of the rate."""
        import time
        log.info("Calibrating placement rate")
        rng = np.random.default_rng(seed)
        S = self.num_sites
        chars = lookup_chars(self.model.num_states)
        # single-state columns only (no gaps/ambiguity): peaked-enough
        # posteriors that the chunk rides the production fused path
        # instead of the saturation fallback
        from epa_ng_tpu_torch.models.charmaps import state_mask_table
        tbl = state_mask_table(self.model.num_states)
        single = [i for i, ch in enumerate(chars)
                  if bin(int(tbl[ord(ch)])).count("1") == 1]
        codes = np.asarray(single, np.uint8)[
            rng.integers(0, len(single), size=(n, S))]
        span = max(8, S // 2)
        begins = rng.integers(0, S - span + 1, size=n).astype(np.int32)
        ranges = np.stack([begins, np.full(n, span, np.int32)], axis=1)
        ec = EncodedChunk(headers=[[f"cal{i}"] for i in range(n)],
                          codes=codes, ranges=ranges)
        self.finalize_chunk(self.place_encoded_async(ec))
        t0 = time.perf_counter()
        self.finalize_chunk(self.place_encoded_async(ec))
        return n / (time.perf_counter() - t0)

    def encode_msa(self, chunk: MSA) -> EncodedChunk:
        if chunk.num_sites and chunk.num_sites != self.num_sites and len(chunk):
            raise ValueError(
                "Query sequence length not same as reference alignment!")
        ec = chunk_mod.from_msa(chunk, self.model.num_states)
        return self.check_chunk(ec)

    def check_chunk(self, ec: EncodedChunk) -> EncodedChunk:
        """Validate widths/ranges and apply the premasking option."""
        if ec.codes.shape[1] != self.num_sites and len(ec):
            raise ValueError(
                "Query sequence length not same as reference alignment!")
        if not self.options.premasking:
            ec.ranges = np.zeros_like(ec.ranges)
            ec.ranges[:, 1] = self.num_sites
        elif len(ec) and (ec.ranges[:, 1] == 0).any():
            q = int(np.argmax(ec.ranges[:, 1] == 0))
            raise ValueError(
                f"Sequence with header '{ec.headers[q][0]}' does not appear "
                "to have any non-gap sites!")
        return ec

    def preplace(self, codes, ranges) -> np.ndarray:
        """[Q, E] preplacement scores."""
        as_i = lambda x: torch.as_tensor(np.asarray(x), device=self.device)
        if self._sharded is not None:
            return self._sharded.preplace(as_i(codes), as_i(ranges[:, 0]),
                                          as_i(ranges[:, 1]))
        scores = lookup.preplace_scores(
            self.lookup_table, as_i(codes), as_i(ranges[:, 0]),
            as_i(ranges[:, 1]))
        return scores.cpu().numpy()

    def place_chunk(self, chunk: MSA, seq_id_offset: int = 0) -> list:
        """Full placement of one chunk; returns filtered PQuery list."""
        result = self.finalize_chunk(self.place_chunk_async(chunk,
                                                            seq_id_offset))
        if isinstance(result, ChunkPlacements):
            return result.to_pqueries()
        return result

    def place_chunk_async(self, chunk: MSA, seq_id_offset: int = 0):
        return self.place_encoded_async(self.encode_msa(chunk),
                                        seq_id_offset)

    def place_encoded_async(self, ec: EncodedChunk, seq_id_offset: int = 0):
        """Dispatch the fused placement step WITHOUT syncing; returns a
        pending handle for finalize_chunk. The streaming pipeline
        dispatches chunk N+1 while chunk N's results transfer and
        assemble (the analog of the reference's __PREFETCH threads)."""
        opts = self.options
        if opts.prescoring:
            mode = heuristics.heuristic_mode(opts)
            topk = self._fused_budget(mode)
            if topk < self.num_edges:
                state = self._dispatch_chunk_fused(ec, seq_id_offset,
                                                   mode, topk)
                return ("fused", state)
        return ("exact", (ec, seq_id_offset))

    def _fused_budget(self, mode: str) -> int:
        """Static top-k candidate budget of the fused step per heuristic.
        fixed/baseball have exact static budgets (top-x% count; the 40-
        pitch cap); dynamic uses the configured budget + wide-redo
        fallback."""
        opts = self.options
        if mode == "fixed":
            return min(int(math.ceil(opts.prescoring_threshold
                                     * self.num_edges)), self.num_edges)
        if mode == "baseball":
            return min(40, self.num_edges)
        topk = opts.fused_topk
        if self.model.num_states >= 20 and topk == type(opts)().fused_topk:
            # 20-state posteriors are far flatter than DNA's: at the DNA
            # default budget many AA queries saturate; applies only when
            # the user left the default
            topk = max(topk, 32)
        return min(topk, self.num_edges)

    def finalize_chunk(self, handle) -> list:
        """Sync + assemble a pending chunk from place_chunk_async."""
        with span("finalize"):
            return self._finalize_chunk(handle)

    def _finalize_chunk(self, handle) -> list:
        kind, state = handle
        if kind == "fused":
            result = self._finalize_chunk_fused(state)
            if result is not None:
                return result
            ec, seq_id_offset = state["ec"], state["seq_id_offset"]
            # >20% of queries saturated the top-k budget or lost pairs to
            # the dynamic budget halving: before surrendering to the
            # host-orchestrated exact pass, re-dispatch the WHOLE chunk
            # fused at an escalating candidate budget (4x, then 256).
            heur_mode = state.get("heur_mode", "dynamic")
            if heur_mode == "dynamic":
                topk = state.get("topk", self.options.fused_topk)
                for k2 in (max(4 * topk, 64), 256):
                    if not (topk < k2 < self.num_edges):
                        continue
                    # memory guard: the whole-chunk pair gather at k2 is
                    # O(Q * k2/2 * (2RK + K) * S) transient bytes; a rung
                    # that would not fit comfortably surrenders to the
                    # exact pass instead (its per-pair windows are
                    # bounded)
                    pairs = len(ec) * k2 // 2
                    RK = int(self.consts.A.shape[-1]
                             * self.consts.rates.shape[0])
                    K = int(self.consts.A.shape[-1])
                    est = pairs * (2 * RK + K) * self.num_sites * (
                        4 if self.dtype == torch.float32 else 8)
                    if est > 2 << 30:
                        break
                    state2 = self._dispatch_chunk_fused(
                        ec, seq_id_offset, heur_mode, topk=k2)
                    result = self._finalize_chunk_fused(state2)
                    if result is not None:
                        self._escalations += 1
                        return result
                    topk = k2
        else:
            ec, seq_id_offset = state
        return self._place_chunk_exact(ec, seq_id_offset)

    def _place_chunk_exact(self, ec: EncodedChunk, seq_id_offset) -> list:
        opts = self.options
        Q = len(ec)
        codes, ranges = ec.codes, ec.ranges
        if opts.prescoring:
            scores = self.preplace(codes, ranges)
            pair_e, pair_q = heuristics.select_work(scores, opts)
        else:
            pair_e, pair_q = heuristics.all_work(Q, self.num_edges)

        logl, pendant, distal = self._thorough(pair_e, pair_q, codes, ranges)

        # assemble per-query placement lists: pair arrays are edge-major,
        # so group by query with one vectorized argsort
        pqueries = []
        order = np.argsort(pair_q, kind="stable")
        qsorted = pair_q[order]
        uq, qstarts = np.unique(qsorted, return_index=True)
        qends = np.append(qstarts[1:], len(qsorted))
        for q, s, e in zip(uq, qstarts, qends):
            idx = order[s:e]
            pqueries.append(PQuery(
                seq_id=seq_id_offset + q,
                headers=list(ec.headers[q]),
                edge_nums=pair_e[idx].astype(np.int64),
                logls=logl[idx],
                pendant_lengths=pendant[idx],
                distal_lengths=distal[idx]))

        compute_and_set_lwr(pqueries)
        filter_pqueries(pqueries, opts)
        return pqueries

    def _dispatch_chunk_fused(self, ec: EncodedChunk, seq_id_offset,
                              heur_mode: str = "dynamic",
                              topk: int | None = None):
        """Fused-step fast path, dispatch half: encode-sort-pad, enqueue
        the placement step, start the result's host copy, return the
        pending state dict."""
        from epa_ng_tpu_torch.parallel.mesh import (chunk_site_width,
                                                    placement_step)
        opts = self.options
        S = self.num_sites
        # sort queries by valid-range begin, so the kernel's pair list
        # walks the alignment in order (the analog of
        # shift_partition_focus, src/core/pll/pll_util.cpp:388-418)
        perm = np.argsort(ec.ranges[:, 0], kind="stable")
        codes, ranges = ec.codes[perm], ec.ranges[perm]
        # pad the query count to a power-of-two bucket (capped at the
        # configured chunk size), as the JAX package does to bound its
        # compile cache; kept so both packages place identical batches
        Qr = len(ec)
        Qp = 64
        while Qp < Qr:
            Qp *= 2
        Qp = max(Qr, min(Qp, opts.chunk_size))
        if self._sharded is not None:
            # dp-sharded queries need a divisible batch dimension
            dp = self._sharded.mesh.shape["dp"]
            Qp = -(-Qp // dp) * dp
        if Qp > Qr:
            pad = Qp - Qr
            codes = np.concatenate([codes, np.repeat(codes[-1:], pad, 0)])
            ranges = np.concatenate([ranges, np.repeat(ranges[-1:], pad, 0)])
        tQ, invq = self._query_tensors_codes(codes)
        topk = self._fused_budget(heur_mode) if topk is None else topk
        W = chunk_site_width(ranges[:, 1], S)
        fcfg = (opts.acc_threshold, max(1, opts.filter_min),
                opts.filter_max)
        use_kernel = self._use_kernel()
        # the kernel's sumtable width covers the widest query span (of
        # every dp slice of the chunk too)
        Wk = blo_kernel.kernel_width(ranges[:, 1]) if use_kernel else None
        as_d = lambda x: torch.as_tensor(np.asarray(x), device=self.device)
        batch = (as_d(codes), as_d(ranges[:, 0]), as_d(ranges[:, 1]), tQ,
                 invq)
        kw = dict(topk=topk, sliding=opts.sliding_blo, site_width=W,
                  use_kernel=use_kernel, block_width=Wk, filter_cfg=fcfg,
                  filter_threshold=opts.support_threshold,
                  heur_mode=heur_mode, has_pinv=self.model.pinv > 0,
                  work=self.newton_work)
        if self._sharded is not None:
            out = self._sharded.fused_step(*batch, **kw)
        else:
            blo = self.blo
            out = placement_step(
                self.consts, self.lookup_table, blo.tU, blo.tV, blo.ls,
                blo.lengths, *batch, opts.prescoring_threshold, packed=True,
                **kw)
        return {
            "ec": ec, "out": _HostCopy(out), "perm": perm, "Qr": Qr,
            "codes": codes, "ranges": ranges,
            "tQ": tQ, "invq": invq, "seq_id_offset": seq_id_offset,
            "heur_mode": heur_mode, "topk": topk,
        }

    def _finalize_chunk_fused(self, state):
        """Fused-step fast path, sync half; returns None when >20% of
        queries saturate the top-k budget (whole chunk falls back).

        The step output arrives LWR-sorted and output-filtered; with no
        stragglers the host work is one boolean gather into the flat
        ChunkPlacements columns."""
        ec, perm, Qr = state["ec"], state["perm"], state["Qr"]
        headers = ec.headers
        codes, ranges = state["codes"], state["ranges"]
        tQ, invq = state["tQ"], state["invq"]
        seq_id_offset = state["seq_id_offset"]
        out = state["out"].numpy(timed=True)  # this chunk's host copy
        edges = out[0].astype(np.int64)
        logl, lwr, pendant, distal = out[1], out[2], out[3], out[4]
        keep = out[5] > 0.5
        flags = np.rint(out[6][:, 0]).astype(np.int32)
        # saturated = every top-k slot selected: the dynamic cut may have
        # wanted more candidates than the static budget (ignore the
        # padded replica rows beyond the real query count)
        saturated = (flags & 1) > 0
        # a live candidate the Newton stage did not optimize (dropped by
        # the dynamic pair-budget halving on a flat-posterior chunk)
        # re-runs below; if redo would touch >20% of the chunk, one exact
        # pass beats a storm of per-query redos
        misfit = (flags & 2) > 0
        if (saturated | misfit)[:Qr].mean() > 0.2:
            return None
        redo = np.nonzero((saturated | misfit)[:Qr])[0].tolist()

        # row q of the outputs is original query perm[q]; map every array
        # back to input order and flat-gather the kept placements
        sortrow = np.empty(Qr, dtype=np.int64)
        sortrow[perm] = np.arange(Qr)
        keep_o = keep[:Qr][sortrow]
        if redo:
            # stragglers get spliced in below; blank their batch rows
            keep_o[perm[redo]] = False
        sel = keep_o.reshape(-1)
        flat = lambda a: a[:Qr][sortrow].reshape(-1)[sel]
        counts = keep_o.sum(axis=1).astype(np.int32)
        cp = ChunkPlacements(
            headers=headers, counts=counts,
            edges=flat(edges), logls=flat(logl), lwrs=flat(lwr),
            pendants=flat(pendant), distals=flat(distal),
            seq_id_offset=seq_id_offset)
        if not redo:
            return cp

        # stragglers whose accumulated-LWR cut wanted more than the fused
        # top-k budget: rerun the SAME fused step with a wide candidate
        # budget (one extra device dispatch)
        sub_pqs = self._redo_wide(redo, codes, ranges, tQ, invq, perm,
                                  headers, seq_id_offset,
                                  state.get("heur_mode", "dynamic"))

        # splice the redo queries' placements into the flat columns at
        # their (currently count-0) offsets, in input order: redo rows are
        # in begin order, and redone queries that are neighbours in the
        # input share one offset, so the rows sort by query first (the JAX
        # package sorts by offset alone and swaps such neighbours)
        offs = cp.offsets
        oqs = [int(perm[q]) for q in redo]
        ins_at = np.concatenate([
            np.repeat(offs[oq], len(pq.edge_nums))
            for oq, pq in zip(oqs, sub_pqs)])
        owner = np.concatenate([
            np.repeat(oq, len(pq.edge_nums))
            for oq, pq in zip(oqs, sub_pqs)])
        order = np.argsort(owner, kind="stable")

        def splice(col, vals):
            return np.insert(col, ins_at[order],
                             np.concatenate(vals)[order])

        cp.edges = splice(cp.edges, [pq.edge_nums for pq in sub_pqs])
        cp.logls = splice(cp.logls, [pq.logls for pq in sub_pqs])
        cp.lwrs = splice(cp.lwrs, [pq.lwrs for pq in sub_pqs])
        cp.pendants = splice(cp.pendants,
                             [pq.pendant_lengths for pq in sub_pqs])
        cp.distals = splice(cp.distals,
                            [pq.distal_lengths for pq in sub_pqs])
        for oq, pq in zip(oqs, sub_pqs):
            cp.counts[oq] = len(pq.edge_nums)
        return cp

    def _redo_wide(self, redo, codes, ranges, tQ, invq, perm, headers,
                   seq_id_offset, heur_mode: str = "dynamic") -> list:
        """Place the budget-saturated / dropped stragglers with ONE
        wide-budget (256 candidates) fused step; returns a filtered PQuery
        per redo row, in redo order. Queries that saturate even the wide
        budget fall back to the exact host-orchestrated path."""
        from epa_ng_tpu_torch.parallel.mesh import (chunk_site_width,
                                                    placement_step)
        opts = self.options
        n_redo = len(redo)
        k2 = (min(256, self.num_edges) if heur_mode == "dynamic"
              else self._fused_budget(heur_mode))
        Qp = 8
        while Qp < n_redo:
            Qp *= 2
        if self._sharded is not None:
            Qp = max(Qp, self._sharded.mesh.shape["dp"])
        idx = np.asarray(redo + [redo[-1]] * (Qp - n_redo))
        sub_r = ranges[idx]
        W2 = chunk_site_width(sub_r[:, 1], self.num_sites)
        idx_t = self._index(idx)
        fcfg = (opts.acc_threshold, max(1, opts.filter_min),
                opts.filter_max)
        use_kernel = self._use_kernel()
        Wk2 = blo_kernel.kernel_width(sub_r[:, 1]) if use_kernel else None
        as_d = lambda x: torch.as_tensor(np.asarray(x), device=self.device)
        batch = (as_d(codes[idx]), as_d(sub_r[:, 0]), as_d(sub_r[:, 1]),
                 tQ[idx_t], invq[idx_t])
        kw = dict(topk=k2, sliding=opts.sliding_blo, site_width=W2,
                  use_kernel=use_kernel, block_width=Wk2,
                  heur_mode=heur_mode, filter_cfg=fcfg,
                  filter_threshold=opts.support_threshold,
                  has_pinv=self.model.pinv > 0, work=self.newton_work)
        if self._sharded is not None:
            out = self._sharded.fused_step(*batch, **kw)
        else:
            blo = self.blo
            out = placement_step(
                self.consts, self.lookup_table, blo.tU, blo.tV, blo.ls,
                blo.lengths, *batch, opts.prescoring_threshold, packed=True,
                **kw)
        return self._redo_wide_finish(out, redo, n_redo, k2, codes, ranges,
                                      tQ, invq, perm, headers,
                                      seq_id_offset)

    def _redo_wide_finish(self, out, redo, n_redo, k2, codes, ranges, tQ,
                          invq, perm, headers, seq_id_offset) -> list:
        """Sync half of the wide redo."""
        out = out.cpu().numpy()
        edges2 = out[0].astype(np.int64)
        keep2 = out[5] > 0.5
        flags2 = np.rint(out[6][:, 0]).astype(np.int32)
        # a row re-enters the exact path when (a) its misfit bit is set
        # (a live candidate was not computed) or (b) it saturated a
        # budget that was still short of every edge
        exact_rows = [i for i in range(n_redo)
                      if (flags2[i] & 2)
                      or ((flags2[i] & 1) and k2 < self.num_edges)]
        exact_pqs = iter(self._redo_exact(
            [redo[i] for i in exact_rows], codes, ranges, tQ, invq, perm,
            headers, seq_id_offset)) if exact_rows else iter(())
        exact_set = set(exact_rows)
        sub_pqs = []
        for i in range(n_redo):
            if i in exact_set:
                sub_pqs.append(next(exact_pqs))
                continue
            k = keep2[i]
            oq = int(perm[redo[i]])
            sub_pqs.append(PQuery(
                seq_id=seq_id_offset + oq, headers=list(headers[oq]),
                edge_nums=edges2[i, k], logls=out[1][i, k],
                pendant_lengths=out[3][i, k], distal_lengths=out[4][i, k],
                lwrs=out[2][i, k]))
        return sub_pqs

    def _redo_exact(self, redo, codes, ranges, tQ, invq, perm, headers,
                    seq_id_offset) -> list:
        """Exact host-orchestrated placement of the given (sorted-space)
        query rows; returns filtered PQueries in redo order."""
        opts = self.options
        n_redo = len(redo)
        padded = 1
        while padded < n_redo:
            padded *= 2
        redo_pad = redo + [redo[-1]] * (padded - n_redo)
        scores = self.preplace(codes[redo_pad], ranges[redo_pad])
        sub_e, sub_q = heuristics.select_work(scores[:n_redo], opts)
        logl2, pend2, dist2 = self._thorough(
            sub_e, np.asarray(redo, np.int32)[sub_q], codes, ranges,
            qt=(tQ, invq))
        order = np.argsort(sub_q, kind="stable")
        qsorted = sub_q[order]
        uq, qstarts = np.unique(qsorted, return_index=True)
        qends = np.append(qstarts[1:], len(qsorted))
        sub_pqs = []
        for qq, s, e in zip(uq, qstarts, qends):
            sel = order[s:e]
            oq = int(perm[redo[qq]])
            sub_pqs.append(PQuery(
                seq_id=seq_id_offset + oq,
                headers=list(headers[oq]),
                edge_nums=sub_e[sel].astype(np.int64),
                logls=logl2[sel],
                pendant_lengths=pend2[sel],
                distal_lengths=dist2[sel]))
        compute_and_set_lwr(sub_pqs)
        filter_pqueries(sub_pqs, opts)
        return sub_pqs

    def _thorough(self, pair_e, pair_q, codes, ranges, qt=None, blo=None):
        """Batched Newton BLO over an explicit pair list, in slabs.

        With the kernel (cuda, f32) every batch runs blocked: pairs sorted
        by their query's range begin, slabs of up to ``blo_block`` pairs,
        each pair reading its own window. The JAX package sends batches
        under 4096 pairs to its XLA Newton because tracing the Pallas
        kernel costs seconds; a CUDA kernel has no such cost, so small
        batches take the kernel too. Otherwise pairs are grouped by their
        query's range width (rounded up to powers of two) and each bucket
        runs the twin on that window width — the analog of the reference's
        premasking payoff on short reads.

        Under a mesh the BLO store lives sharded across devices: the
        pairs' windows are gathered from the host copies instead
        (``core.memsave.host_window_thorough``, shared with --memsave; on
        the card the kernel's per-pair shape)."""
        if self._sharded is not None:
            from epa_ng_tpu_torch.core.memsave import host_window_thorough
            return host_window_thorough(self, pair_e, pair_q, codes, ranges,
                                        qt)
        opts = self.options
        S = self.num_sites
        P = len(pair_e)
        block = opts.blo_block

        # query tip tensors for this chunk (qt: precomputed (tQ, invq))
        tQ, invq = qt if qt is not None else self._query_tensors_codes(codes)

        begins = ranges[:, 0].astype(np.int32)
        spans = ranges[:, 1].astype(np.int32)

        # per-QUERY bucket widths (power-of-two >= span, floor 64, cap S),
        # gathered onto the pair list
        qwidths = np.full(len(spans), 64, dtype=np.int64)
        grow = qwidths < spans
        while grow.any():
            qwidths[grow] *= 2
            grow = qwidths < spans
        qwidths = np.minimum(qwidths, S)
        widths = qwidths[pair_q]

        blo = self.blo if blo is None else blo
        out_logl = np.zeros(P)
        out_pendant = np.zeros(P)
        out_distal = np.zeros(P)
        has_pinv = self.model.pinv > 0
        as_d = lambda x: torch.as_tensor(np.asarray(x), device=self.device)

        def read_back(pending, done_out):
            # dispatch-all-then-read: every slab is enqueued before the
            # first result is waited for
            for sel, n, res in pending:
                logl, pendant, distal_rep, done = (h.numpy() for h in res)
                out_logl[sel] = logl[:n]
                out_pendant[sel] = pendant[:n]
                out_distal[sel] = distal_rep[:n]
                done_out[sel] = done[:n]

        def run_blocked(idx: np.ndarray, cap: int) -> np.ndarray:
            """Kernel path: pairs sorted by their query's range begin,
            slabs of blk pairs."""
            done_out = np.zeros(P, dtype=bool)
            blk = 256
            while blk < min(len(idx), block):
                blk *= 2
            order = idx[np.argsort(begins[pair_q[idx]], kind="stable")]
            pending = []
            for start in range(0, len(order), blk):
                sel = order[start:start + blk]
                n = len(sel)
                pad = np.concatenate([sel, np.repeat(sel[-1:], blk - n)])
                sp = spans[pair_q[pad]]
                res = _blo_blocked(
                    self.consts, blo.tU, blo.tV, blo.ls, blo.lengths,
                    tQ, invq, as_d(pair_e[pad]), as_d(pair_q[pad]),
                    as_d(begins[pair_q[pad]]), as_d(sp),
                    blo_kernel.kernel_width(sp), cap, has_pinv=has_pinv,
                    work=self.newton_work)
                pending.append((sel, n, [_HostCopy(a) for a in res]))
            read_back(pending, done_out)
            return done_out

        def run_bucketed(idx: np.ndarray, cap: int) -> np.ndarray:
            """Width-bucketed per-pair windowed path (the twin)."""
            done_out = np.zeros(P, dtype=bool)
            blk = 256
            while blk < min(len(idx), block):
                blk *= 2
            order = idx[np.argsort(widths[idx], kind="stable")]
            pending = []
            for W in np.unique(widths[idx]):
                widx = order[widths[order] == W]
                for start in range(0, len(widx), blk):
                    sel = widx[start:start + blk]
                    n = len(sel)
                    pad = np.concatenate(
                        [sel, np.repeat(sel[-1:], blk - n)])
                    # clamp window starts so begin + W <= S
                    b_np = np.minimum(begins[pair_q[pad]], S - W)
                    res = _blo_windowed(
                        self.consts, blo.tU, blo.tV, blo.ls,
                        blo.lengths, tQ, invq, as_d(pair_e[pad]),
                        as_d(pair_q[pad]), as_d(b_np),
                        as_d(begins[pair_q[pad]] - b_np),
                        as_d(spans[pair_q[pad]]),
                        int(W), opts.sliding_blo, cap,
                        work=self.newton_work)
                    pending.append((sel, n, [_HostCopy(a) for a in res]))
            read_back(pending, done_out)
            return done_out

        def run(idx: np.ndarray, cap: int) -> np.ndarray:
            """Optimize the given pair subset with a smoothing cap; fills
            outputs, returns the per-pair converged flags."""
            if self._use_kernel():
                return run_blocked(idx, cap)
            return run_bucketed(idx, cap)

        # two-phase convergence compaction: most pairs converge (or roll
        # back) within a couple of smoothings; run everything with a small
        # cap first, then only the unconverged tail with the full budget
        all_idx = np.arange(P)
        phase1 = min(opts.blo_phase1_smoothings, opts.max_blo_iters)
        done = run(all_idx, phase1)
        redo = all_idx[~done]
        if len(redo):
            run(redo, opts.max_blo_iters)

        if not np.isfinite(out_logl).all():
            bad = int(np.nonzero(~np.isfinite(out_logl))[0][0])
            raise RuntimeError(
                f"-INF logl at branch {pair_e[bad]} for query {pair_q[bad]}")
        return out_logl, out_pendant, out_distal


class _HostCopy:
    """A device->host result transfer in flight: a pinned host buffer
    filled by a non-blocking copy, with an event that :meth:`numpy` waits
    on (so the pipeline's writer thread reads only landed bytes). CPU
    tensors pass through. The analog of the JAX package's
    ``copy_to_host_async`` and the reference's jplace_writer future
    (src/io/jplace_writer.hpp:58-69)."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._buf = t

    def numpy(self, timed: bool = False) -> np.ndarray:
        """The landed bytes; ``timed``: the wait is a chunk's result (once
        a chunk), recorded as its ``finalize.sync`` span."""
        with span("finalize.sync") if timed else contextlib.nullcontext():
            if self._event is not None:
                self._event.synchronize()
        return self._buf.numpy()


def _host_available_bytes():
    """Available host RAM (MemAvailable), or None when undeterminable."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def state_from_numpy(consts, blo, table, dtype=None, device="cuda"):
    """The port's reference state from numpy arrays (e.g. the JAX engine's
    ``consts``, ``blo`` and ``lookup_table`` through ``np.asarray``), so
    both packages can run on bit-identical state: returns (EigConsts,
    BloTensors, table), the table either [E,C,S] or a (resid, mean) pair.
    ``dtype`` defaults to each array's own."""
    dev = torch.device(device)
    as_t = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=dev)
    consts_t = newton.EigConsts(*[as_t(x) for x in consts])
    blo_t = newton.BloTensors(*[as_t(x) for x in blo])
    if isinstance(table, tuple):
        table_t = tuple(torch.as_tensor(np.array(x), device=dev)
                        for x in table)
    else:
        table_t = as_t(table)
    return consts_t, blo_t, table_t


def _check_device_model(device: torch.device, model: Model,
                        sliding: bool = True):
    """On the card the port places DNA (4-state) and protein (20-state)
    models with one substitution matrix, with or without +I (``+I{p}``,
    ``+IU{p}``, the empirical ``+IC``), and protein matrix mixtures
    (LG4M/LG4X), through the Newton kernel with up to
    ``blo_kernel.MAX_RATES`` rate categories (312 at K = 4, 64 at K = 20,
    a single matrix or a mixture). Binary and genotype models, non-sliding
    BLO (``sliding=False``) and rate counts past the cap (which the JAX
    package never gives its Pallas kernel, ``blo_kernel.twin_rates``) run
    on the torch twin, as the JAX package runs them on its XLA twin. A
    count past the cap that the JAX package gives Pallas would raise
    rather than run the plain paths there; the caps leave none."""
    if (device.type != "cuda" or not sliding
            or model.num_states not in blo_kernel.K_STATES):
        return
    mixture = model.submodels is not None and model.num_ratecats > 1
    cap = blo_kernel.MAX_RATES[(model.num_states, mixture)]
    if model.num_ratecats > cap and not blo_kernel.twin_rates(
            model.num_states, model.num_ratecats, mixture):
        raise NotImplementedError(
            f"{model.num_ratecats} rate categories are not yet ported to the "
            f"GPU in epa_ng_tpu_torch (the Newton kernel takes 1..{cap} at "
            f"{model.num_states} states{' for a mixture' if mixture else ''}"
            "; run them with --device cpu)")


def _transform_codes(consts, char_clvs, codes):
    """tQ [Q,K|RK,S] from the lookup-code matrix: gather per-column tip-CLV
    rows on device, then eigen-transform (newton.transform_queries)."""
    qclv = char_clvs[codes.long()].permute(0, 2, 1)  # [Q,K,S]
    return newton.transform_queries(consts, qclv)


def _blo_blocked(consts, tU, tV, ls, lengths, tQ, invq, e_ids, q_ids,
                 begins, spans, width: int, max_smoothings: int,
                 has_pinv: bool = False, work=None):
    """Kernel dispatch for an explicit pair list: each pair reads its own
    window of the full stores (ops.blo_kernel.
    blo_optimize_batch_kernel_blocked), +I models their invariant term
    from ``invq`` and ``ls``. ``work`` (``NewtonWork``) accumulates the
    kernel's executed work."""
    S = tU.shape[2]
    dtype = tU.dtype
    site = torch.arange(S, device=tU.device)
    ends = begins + spans
    fullmask = ((site[None, :] >= begins[:, None])
                & (site[None, :] < ends[:, None])).to(dtype)
    e = e_ids.long()
    ls_sum = torch.sum(fullmask * ls[e], dim=1)
    pinv = dict(invq=invq, ls=ls) if has_pinv else {}
    out = blo_kernel.blo_optimize_batch_kernel_blocked(
        consts, tU, tV, tQ, e_ids, q_ids, begins, spans, lengths[e],
        ls_sum, block_width=width, max_smoothings=max_smoothings,
        counters=work is not None, **pinv)
    logl, pendant, distal_rep, _, _, done = out[:6]
    if work is not None:
        work.add(torch.ones_like(done), out[6:])
    return logl, pendant, distal_rep, done


def _blo_windowed(consts, tU, tV, ls, lengths, tQ, invq,
                  e_ids, q_ids, win_begin, local_begin, spans,
                  width: int, sliding: bool,
                  max_smoothings: int = newton.SMOOTHINGS, work=None):
    """Gather per-pair site windows [width] out of the full-S tensors and
    run the twin's Newton batch on the compact windows (the kernel reads
    its windows itself: _blo_blocked). ``work`` (``NewtonWork``) counts
    the call."""
    from epa_ng_tpu_torch.parallel.mesh import pair_windows
    tu, tv, tq, lw, mask, orig, iv = pair_windows(
        tU, tV, ls, lengths, tQ, invq, e_ids, q_ids, win_begin, local_begin,
        spans, width)
    logl, pendant, distal_rep, _, _, done = newton.blo_optimize_batch(
        consts, tu, tv, tq, lw, mask, orig, iv, sliding=sliding,
        max_smoothings=max_smoothings)
    if work is not None:
        work.add_twin()
    return logl, pendant, distal_rep, done


def empirical_frequencies(tip_masks: np.ndarray, num_states: int) -> np.ndarray:
    """Empirical base frequencies from the reference alignment, counting
    ambiguous characters fractionally across their states (the
    pllmod_msa_empirical_frequencies convention)."""
    full = (1 << num_states) - 1
    nongap = tip_masks[tip_masks != full]
    popc = np.zeros_like(nongap)
    tmp = nongap.copy()
    while tmp.any():
        popc += tmp & 1
        tmp >>= 1
    inv = 1.0 / popc  # each char contributes 1/|states| per member state
    counts = np.array([
        (((nongap >> s) & 1) * inv).sum() for s in range(num_states)])
    return counts / counts.sum()
