"""Out-of-core placement (``--memsave``): the reference state in host RAM,
a budget-bounded device cache, and the rest streamed to the card.

Counterpart of ``epa_ng_tpu/core/memsave.py``, with its tiers and rules:

- the engine is built on the CPU, so host RAM is the ceiling, and keeps the
  lookup table split as (resid, mean) and the BLO store (tU, tV, ls,
  lengths) as host tensors;
- a prefix of each store, sized by ``--memsave-budget`` (decimal GB; by
  default AUTO_BUDGET_FRACTION of the card's memory), is uploaded once and
  stays on the device;
- the rest streams to the device for every chunk, at bounded depth:
  preplacement in blocks of EDGE_BLOCK edges (PRE_PIPELINE_DEPTH in
  flight), the thorough stage as per-pair site windows gathered on the
  host into slabs (SLAB_PIPELINE_DEPTH in flight);
- a budget that covers both stores switches the engine to the parent's
  fused device-resident path.

Every placement operation runs on the device. Pairs on cached edges go
through the parent's ``_thorough`` against the cached prefix (on the card:
the kernel's blocked shape). Streamed pairs arrive as pre-sliced windows
and go to the kernel's per-pair shape
(``blo_kernel.blo_optimize_batch_kernel``), where the JAX package sends
them to its XLA Newton: another route to the same result. The query
tensors (tQ, invq) are small and per chunk; they stay on the device and
their windows are gathered there.

Uploads go through :class:`_StagingRing`: a few pinned staging slots and a
copy stream, so that the upload of block b + 1 overlaps the compute on
block b. The stores themselves are never pinned: at the sizes --memsave is
for, pinning would double host RAM for a moment and take seconds.
"""

from __future__ import annotations

import numpy as np
import torch

from epa_ng_tpu_torch.core.engine import (PlacementEngine, _check_device_model,
                                          _HostCopy)
from epa_ng_tpu_torch.ops import blo_kernel, lookup, newton
from epa_ng_tpu_torch.utils.options import Options

EDGE_BLOCK = 512  # edges streamed per preplacement step
PRE_PIPELINE_DEPTH = 2   # streamed preplacement blocks in flight
SLAB_PIPELINE_DEPTH = 4  # thorough window slabs in flight
AUTO_BUDGET_FRACTION = 0.35  # of device memory, when discoverable
AUTO_BUDGET_FALLBACK = 4 << 30
# the largest staged Newton slab: a slab of ``blo_block`` pairs is cut to
# fit, so the staging ring stays bounded at any alignment width, and well
# under the stores that --memsave keeps off the device
SLAB_BYTES = 32 << 20
_ALIGN = 256  # byte alignment of each tensor carved out of a staging slot


def _check_pallas_option(options):
    """Fail a doomed --memsave + ``--pallas on`` combination before the
    host build: with an explicit budget of 0 (pure streaming) the fused
    device path never runs. Budgets that might cover the whole store are
    checked again in ``_init_cache``, where the store's size is known."""
    if (options is not None and options.pallas == "on"
            and options.memsave_budget_gb is not None
            and options.memsave_budget_gb <= 0):
        raise ValueError(
            "pallas=on is incompatible with --memsave-budget 0 (pure "
            "streaming); --pallas on needs the fused device-resident path")


def _device_memory_bytes(device: torch.device):
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return None


def _itemsize(dtype) -> int:
    return torch.empty(0, dtype=dtype).element_size()


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _carve(buf: torch.Tensor, specs):
    """Views of the flat uint8 ``buf`` as tensors of ``specs`` ((shape,
    dtype), ...), each at an _ALIGN-byte offset; returns (views, bytes
    used)."""
    views, off = [], 0
    for shape, dtype in specs:
        n = int(np.prod(shape)) * _itemsize(dtype)
        views.append(buf[off:off + n].view(dtype).view(shape))
        off += _aligned(n)
    return views, off


def _specs_bytes(specs) -> int:
    return sum(_aligned(int(np.prod(s)) * _itemsize(d)) for s, d in specs)


class _StagingRing:
    """``depth`` staging slots for host -> device uploads: a pinned host
    buffer and a device buffer per slot, and one copy stream.

    :meth:`put` fills the next slot's host buffer, queues its upload on the
    copy stream and makes the current (compute) stream wait for it;
    :meth:`release` records that the compute reading the slot is queued. A
    slot's host buffer is refilled only once its last upload has landed,
    and its device buffer is overwritten only once the compute that read it
    has run, so at most ``depth`` uploads are in flight and no
    synchronisation of the whole device is needed. The device buffers live
    as long as the ring, so the caching allocator never hands their memory
    to another tensor while a copy or a kernel still uses it. Slots grow to
    the largest request. On the CPU a slot is one host buffer, and nothing
    is copied. One thread at a time."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self._cuda = device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if self._cuda else None
        self._depth = depth
        self._host = self._dev = []
        self._uploaded = [None] * depth
        self._read = [None] * depth
        self._next = 0
        self.nbytes = 0        # bytes per slot
        self.h2d_bytes = 0     # bytes uploaded so far

    def _grow(self, nbytes: int):
        for ev in self._uploaded + self._read:
            if ev is not None:
                ev.synchronize()
        self._host = self._dev = []  # free the old slots first
        self._host = [torch.empty(nbytes, dtype=torch.uint8,
                                  pin_memory=self._cuda)
                      for _ in range(self._depth)]
        self._dev = ([torch.empty(nbytes, dtype=torch.uint8,
                                  device=self.device)
                      for _ in range(self._depth)] if self._cuda
                     else self._host)
        self._uploaded = [None] * self._depth
        self._read = [None] * self._depth
        self.nbytes = nbytes
        if self._cuda:
            # the new buffers may reuse memory that queued compute-stream
            # work still reads: the copy stream writes them only after it
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    @property
    def device_bytes(self) -> int:
        """The device memory that the slots hold (0 on the CPU)."""
        return self.nbytes * self._depth if self._cuda else 0

    def put(self, specs, fill):
        """Carve the next slot into tensors of ``specs``, let ``fill`` write
        their host views, and upload; returns (slot, device views)."""
        used = _specs_bytes(specs)
        if used > self.nbytes:
            self._grow(used)
        i = self._next
        self._next = (i + 1) % self._depth
        if self._uploaded[i] is not None:
            self._uploaded[i].synchronize()
        host, _ = _carve(self._host[i], specs)
        fill(*host)
        if not self._cuda:
            return i, host
        if self._read[i] is not None:
            self._stream.wait_event(self._read[i])
        with torch.cuda.stream(self._stream):
            self._dev[i][:used].copy_(self._host[i][:used],
                                      non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self._stream)
        self._uploaded[i] = ev
        torch.cuda.current_stream(self.device).wait_event(ev)
        self.h2d_bytes += used
        return i, _carve(self._dev[i], specs)[0]

    def release(self, i: int):
        """The compute stream's reads of slot ``i`` are queued."""
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._read[i] = ev


class OutOfCoreEngine(PlacementEngine):
    """PlacementEngine whose reference-state tensors live in host RAM,
    fronted by a budget-bounded device cache. ``device`` is where it
    places; the state is built on the CPU either way."""

    def __init__(self, tree, ref_msa, model, options=None, device="cuda"):
        options = options or Options()
        _check_pallas_option(options)
        # an unsupported model fails here, not after the host build
        _check_device_model(torch.device(device), model, options.sliding_blo)
        super().__init__(tree, ref_msa, model, options, device="cpu")
        self._offload(device)

    @classmethod
    def from_precomputed(cls, tree, model, options, edges, num_sites,
                         ref_intersection=None, device="cuda"):
        options = options or Options()
        _check_pallas_option(options)
        _check_device_model(torch.device(device), model, options.sliding_blo)
        self = super().from_precomputed(tree, model, options, edges,
                                        num_sites, ref_intersection,
                                        device="cpu")
        self._offload(device)
        return self

    # ------------------------------------------------------------------

    def _offload(self, device):
        """Keep the stores as host tensors, move the per-run constants to
        ``device`` and fill the device cache up to the budget. Under
        --dump-binary the host-built edge tensors are all that is wanted,
        and they stay."""
        if self.options.dump_binary_mode:
            return
        table = self.lookup_table
        self._resid_h, self._mean_h = (
            table if isinstance(table, tuple) else lookup.split_table(table))
        del table
        self._tU_h, self._tV_h, self._ls_h, self._lengths_h = (
            t.contiguous() for t in self.blo)
        self._lookup_table = None
        self._blo = None
        self.device = torch.device(device)
        self.consts = newton.EigConsts(*(t.to(self.device)
                                         for t in self.consts))
        self._char_clvs = self._char_clvs.to(self.device)
        self.newton_work = blo_kernel.NewtonWork(self.device)
        self._pre_ring = _StagingRing(self.device, PRE_PIPELINE_DEPTH)
        self._slab_ring = _StagingRing(self.device, SLAB_PIPELINE_DEPTH)
        self.hit_pairs = 0       # pairs placed against the cached prefix
        self.streamed_pairs = 0  # pairs placed on streamed windows
        self._init_cache()

    def _host_stores(self):
        return (self._resid_h, self._mean_h, self._tU_h, self._tV_h,
                self._ls_h, self._lengths_h)

    def _init_cache(self):
        """Size the device cache (the analog of the reference's -b memory
        pool, src/tree/Tree.cpp:80-117): the budget is split between the
        preplacement table and the BLO store in proportion to their
        sizes, each caching a prefix of whole blocks / edges. Budget unit:
        decimal GB. A budget that covers both stores entirely switches the
        engine to the parent's fused device-resident path. The old tier's
        device tensors are dropped before the new tier is allocated."""
        self._blo_cache = None
        self._pre_cache: dict[int, tuple] = {}
        self._lookup_table = None
        self._blo = None
        gb = self.options.memsave_budget_gb
        if gb is None:
            dev = _device_memory_bytes(self.device)
            budget = (int(dev * AUTO_BUDGET_FRACTION) if dev
                      else AUTO_BUDGET_FALLBACK)
        else:
            budget = max(0, int(gb * 1e9))  # negative degrades to 0
        self._budget_bytes = budget
        E = self.num_edges
        eb = min(EDGE_BLOCK, E)
        self._pre_block = eb
        n_blocks = -(-E // eb)
        resid, mean, tU, tV, ls, lengths = self._host_stores()
        pre_total = resid.nbytes + mean.nbytes
        blo_total = tU.nbytes + tV.nbytes + ls.nbytes + lengths.nbytes
        total = pre_total + blo_total
        up = lambda t: t.to(self.device)
        self._full_cover = budget >= total
        if self._full_cover:
            self._pre_cache_nblocks = n_blocks
            self._blo_cache_edges = E
            self._lookup_table = (up(resid), up(mean))
            self._blo = newton.BloTensors(up(tU), up(tV), up(ls), up(lengths))
            self._blo_cache = self._blo
            return
        if self.options.pallas == "on":
            raise ValueError(
                "pallas=on needs the fused device-resident path; under "
                "--memsave that requires a budget covering the whole "
                f"reference state ({total / 1e9:.2f} GB)")
        pre_budget = budget * pre_total // max(1, total)
        blo_budget = budget - pre_budget
        # the padded size of a block counts against the budget
        pre_block_bytes = (resid[:1].nbytes + mean[:1].nbytes) * eb
        self._pre_cache_nblocks = min(
            n_blocks, int(pre_budget // max(1, pre_block_bytes)))
        # the cache holds all of ``lengths`` ([E]): charge it first
        per_edge = -(-(tU.nbytes + tV.nbytes + ls.nbytes) // E)
        C = min(E, max(0, int((blo_budget - lengths.nbytes)
                              // max(1, per_edge))))
        self._blo_cache_edges = C
        if C > 0:
            self._blo_cache = newton.BloTensors(
                up(tU[:C]), up(tV[:C]), up(ls[:C]), up(lengths))
        for bi in range(self._pre_cache_nblocks):
            e0 = bi * eb
            self._pre_cache[bi] = tuple(
                up(t) for t in self._padded_block(e0, min(e0 + eb, E)))

    def _block_specs(self):
        eb = self._pre_block
        return [((eb,) + tuple(self._resid_h.shape[1:]), self._resid_h.dtype),
                ((eb, self.num_sites), self._mean_h.dtype)]

    def _fill_block(self, e0, e1, r, m):
        """The table's rows e0:e1 into the block views ``r``, ``m``, padded
        with zeros to EDGE_BLOCK rows (every block has one shape)."""
        n = e1 - e0
        r[:n].copy_(self._resid_h[e0:e1])
        m[:n].copy_(self._mean_h[e0:e1])
        r[n:].zero_()
        m[n:].zero_()

    def _padded_block(self, e0, e1):
        r, m = (torch.empty(s, dtype=d) for s, d in self._block_specs())
        self._fill_block(e0, e1, r, m)
        return r, m

    def device_cached_bytes(self) -> int:
        n = 0
        if self._blo_cache is not None:
            n += sum(t.nbytes for t in self._blo_cache)
        if self._full_cover and self._lookup_table is not None:
            n += sum(t.nbytes for t in self._lookup_table)
        for r, m in self._pre_cache.values():
            n += r.nbytes + m.nbytes
        return n

    def host_resident_bytes(self) -> int:
        return sum(t.nbytes for t in self._host_stores())

    def memsave_stats(self) -> dict:
        """The CLI's --memsave counters. The staging rings' bound is each
        ring's depth times its largest request: one padded preplacement
        block, and a slab of at most SLAB_BYTES."""
        rings = (self._pre_ring, self._slab_ring)
        ring_bound = (PRE_PIPELINE_DEPTH * _specs_bytes(self._block_specs())
                      + SLAB_PIPELINE_DEPTH * SLAB_BYTES)
        return dict(
            memsave_budget_mb=self._budget_bytes / 1e6,
            memsave_host_mb=self.host_resident_bytes() / 1e6,
            memsave_cached_edges=self._blo_cache_edges,
            memsave_cached_mb=self.device_cached_bytes() / 1e6,
            memsave_ring_mb=sum(r.device_bytes for r in rings) / 1e6,
            memsave_ring_bound_mb=ring_bound / 1e6,
            memsave_hit_pairs=self.hit_pairs,
            memsave_streamed_pairs=self.streamed_pairs,
            h2d_mb=sum(r.h2d_bytes for r in rings) / 1e6)

    # the fused path needs device-resident stores: with a covering cache it
    # runs unchanged, otherwise every chunk takes the streamed exact path
    def place_encoded_async(self, ec, seq_id_offset: int = 0):
        if self._full_cover:
            return PlacementEngine.place_encoded_async(self, ec,
                                                       seq_id_offset)
        return ("exact", (ec, seq_id_offset))

    # -- streamed preplacement ------------------------------------------

    def preplace(self, codes, ranges) -> np.ndarray:
        if self._full_cover:
            return PlacementEngine.preplace(self, codes, ranges)
        E, eb = self.num_edges, self._pre_block
        as_d = lambda x: torch.as_tensor(np.asarray(x), device=self.device)
        codes_d, begins, spans = (as_d(codes), as_d(ranges[:, 0]),
                                  as_d(ranges[:, 1]))
        # cached blocks are read in place; streamed ones go through the
        # ring, whose depth bounds the uploads in flight. Every block is
        # queued before the first result is waited for.
        pending = []
        for bi, e0 in enumerate(range(0, E, eb)):
            e1 = min(e0 + eb, E)
            if bi < self._pre_cache_nblocks:
                block = lookup.preplace_scores(self._pre_cache[bi], codes_d,
                                               begins, spans)
            else:
                slot, pair = self._pre_ring.put(
                    self._block_specs(),
                    lambda r, m: self._fill_block(e0, e1, r, m))
                block = lookup.preplace_scores(tuple(pair), codes_d, begins,
                                               spans)
                self._pre_ring.release(slot)
            pending.append((e0, e1, _HostCopy(block)))
        scores = np.empty((len(codes), E), dtype=self._mean_h.numpy().dtype)
        for e0, e1, h in pending:
            scores[:, e0:e1] = h.numpy()[:, :e1 - e0]
        return scores

    # -- thorough placement: cached-prefix hits + streamed misses --------

    def _thorough(self, pair_e, pair_q, codes, ranges, qt=None):
        qt = qt if qt is not None else self._query_tensors_codes(codes)
        C = self._blo_cache_edges if self._blo_cache is not None else 0
        hit = pair_e < C
        n_hit = int(hit.sum())
        self.hit_pairs += n_hit
        self.streamed_pairs += len(pair_e) - n_hit
        if n_hit == 0:
            return host_window_thorough(self, pair_e, pair_q, codes, ranges,
                                        qt)
        if n_hit == len(pair_e):
            return PlacementEngine._thorough(self, pair_e, pair_q, codes,
                                             ranges, qt=qt,
                                             blo=self._blo_cache)
        out = [np.zeros(len(pair_e)) for _ in range(3)]
        for sel, res in (
                (hit, PlacementEngine._thorough(
                    self, pair_e[hit], pair_q[hit], codes, ranges, qt=qt,
                    blo=self._blo_cache)),
                (~hit, host_window_thorough(self, pair_e[~hit],
                                            pair_q[~hit], codes, ranges,
                                            qt))):
            for o, r in zip(out, res):
                o[sel] = r
        return tuple(out)


def _slab_pairs(tU_h, W: int, blk: int) -> int:
    """Pairs per staged slab of windows of width W of the host store
    ``tU_h``: ``blk``, or as many as fit SLAB_BYTES (tu, tv, ls, length)."""
    pair_bytes = _itemsize(tU_h.dtype) * (2 * tU_h.shape[1] * W + W + 1)
    return max(1, min(blk, (SLAB_BYTES - 4 * _ALIGN) // pair_bytes))


def _slab_specs(tU_h, n: int, W: int):
    RK, dt = tU_h.shape[1], tU_h.dtype
    return [((n, RK, W), dt), ((n, RK, W), dt), ((n, W), dt), ((n,), dt)]


def _gather_windows(eng, pair_e, win_begin, W, tu, tv, ls, orig_len):
    """Host gathers of per-pair site windows of the host BLO store into the
    staging views ``tu``, ``tv`` [P, RK, W], ``ls`` [P, W] and
    ``orig_len`` [P] (the analog of ``shift_partition_focus``): pair p
    reads edge ``pair_e[p]``'s sites ``win_begin[p]`` to
    ``win_begin[p] + W``."""
    e = torch.as_tensor(pair_e, dtype=torch.long)
    b = torch.as_tensor(win_begin, dtype=torch.long)
    tu.copy_(eng._tU_h.unfold(2, W, 1)[e, :, b])
    tv.copy_(eng._tV_h.unfold(2, W, 1)[e, :, b])
    ls.copy_(eng._ls_h.unfold(1, W, 1)[e, b])
    orig_len.copy_(eng._lengths_h[e])


def host_window_thorough(eng, pair_e, pair_q, codes, ranges, qt=None):
    """Thorough placement against a host-resident BLO store: per-pair site
    windows are gathered on the host into slabs (pairs grouped by their
    query's window width, powers of two from 64), each slab streamed to
    the device through ``eng._slab_ring`` and optimized there, the query
    windows gathered on the device. With the kernel (``eng._use_kernel()``:
    cuda, f32, a kernel model) a slab is one launch of the kernel's
    per-pair shape with its counters; otherwise the torch twin runs.
    Two-phase cap as in ``PlacementEngine._thorough``. ``eng`` carries the
    host store (``_tU_h``, ``_tV_h``, ``_ls_h``, ``_lengths_h``), the
    staging ring ``_slab_ring`` and its device state: an
    :class:`OutOfCoreEngine`'s streamed misses, or the exact redo of an
    engine with a mesh attached (``PlacementEngine.attach_mesh``)."""
    opts = eng.options
    S = eng.num_sites
    P = len(pair_e)
    dev = eng.device
    tQ, invq = qt if qt is not None else eng._query_tensors_codes(codes)
    begins = ranges[:, 0].astype(np.int64)
    spans = ranges[:, 1].astype(np.int64)
    # per-query window widths (power of two >= span, floor 64, cap S)
    qwidths = np.full(len(spans), 64, dtype=np.int64)
    grow = qwidths < spans
    while grow.any():
        qwidths[grow] *= 2
        grow = qwidths < spans
    widths = np.minimum(qwidths, S)[pair_q]
    use_kernel = eng._use_kernel()
    has_pinv = eng.model.pinv > 0
    dt = eng._tU_h.dtype
    as_d = lambda x: torch.as_tensor(np.asarray(x), device=dev)
    ring = eng._slab_ring
    out_logl = np.zeros(P)
    out_pendant = np.zeros(P)
    out_distal = np.zeros(P)

    def slab(sel, W, cap):
        pe, pq = pair_e[sel], pair_q[sel]
        wb = np.minimum(begins[pq], S - W)
        slot, (tu, tv, lw, olen) = ring.put(
            _slab_specs(eng._tU_h, len(sel), W),
            lambda *views: _gather_windows(eng, pe, wb, W, *views))
        q_d, wb_d = as_d(pq).long(), as_d(wb).long()
        tq = tQ.unfold(2, W, 1)[q_d, :, wb_d]
        iv = invq.unfold(1, W, 1)[q_d, wb_d]
        local = as_d(begins[pq] - wb)
        ends = local + as_d(spans[pq])
        w = torch.arange(W, device=dev)
        mask = ((w[None, :] >= local[:, None])
                & (w[None, :] < ends[:, None])).to(dt)
        if use_kernel:
            out = blo_kernel.blo_optimize_batch_kernel(
                eng.consts, tu, tv, tq, lw, mask, olen, inv_logfreq=iv,
                max_smoothings=cap, has_pinv=has_pinv, counters=True)
            eng.newton_work.add(torch.ones_like(out[5]), out[6:])
        else:
            out = newton.blo_optimize_batch(
                eng.consts, tu, tv, tq, lw, mask, olen, iv,
                sliding=opts.sliding_blo, max_smoothings=cap)
            eng.newton_work.add_twin()
        ring.release(slot)
        logl, pendant, distal_rep, _, _, done = out[:6]
        # copies: on the CPU a result could otherwise share memory with
        # the staging slot that the next slab refills
        return [_HostCopy(a if dev.type == "cuda" else a.clone())
                for a in (logl, pendant, distal_rep, done)]

    def run(idx: np.ndarray, cap: int) -> np.ndarray:
        done_out = np.zeros(P, dtype=bool)
        blk = 256
        while blk < min(len(idx), opts.blo_block):
            blk *= 2
        order = idx[np.argsort(widths[idx], kind="stable")]
        pending = []
        for W in np.unique(widths[idx]):
            W = int(W)
            widx = order[widths[order] == W]
            n = _slab_pairs(eng._tU_h, W, blk)
            for start in range(0, len(widx), n):
                sel = widx[start:start + n]
                pending.append((sel, slab(sel, W, cap)))
        for sel, res in pending:
            logl, pendant, distal_rep, done = (h.numpy() for h in res)
            out_logl[sel] = logl
            out_pendant[sel] = pendant
            out_distal[sel] = distal_rep
            done_out[sel] = done
        return done_out

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
