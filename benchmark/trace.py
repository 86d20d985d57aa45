"""The traced run's instruments: the device timeline from ``torch.profiler``
and the Newton kernel's work from its own counters.

``NewtonRecorder`` stands in for the port's kernel entry
(``ops/blo_kernel.py::blo_newton``) while the window runs. It passes every
call through as it came, reads the arguments it needs by the entry's own
parameter names, and for each launch with counters sums over the live
pairs (span, span x smoothings, span x Newton iterations, pairs) and
counts the distinct (row, site) cells their windows of the edge stores
(tU, tV) and of the query store (tQ) cover, on a stream of its own, so its
few small kernels neither wait on the placement's stream nor count among
its device time. After the window each launch's sums give its
operations, bytes (each input byte once a launch) and bound
(``counts.launch_bound``).

``DeviceTimeline`` holds the profiler's device events of the window (the
recorder's stream left out): the union of their intervals (busy time),
time by name, and the idle gaps, labelled by what the harness's own host
spans were doing at each gap's middle.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from benchmark import counts

NEWTON_KERNEL = "blo_newton"
MAX_LAUNCHES = 1 << 20
# what the recorder reads of a launch, by the kernel entry's own names
ARGS = ("tables", "tU", "tQ", "e_ids", "q_ids", "begins", "spans", "skip",
        "counters", "invq")


class NewtonRecorder:
    def __init__(self, kernel, device):
        self._kernel = kernel
        self._sig = inspect.signature(kernel)
        lost = set(ARGS) - set(self._sig.parameters)
        if lost:
            raise TypeError(f"the Newton kernel's entry no longer takes "
                            f"{sorted(lost)}: the recorder cannot count it")
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.on_card else None
        self.sums = torch.zeros((MAX_LAUNCHES, 6), dtype=torch.float64,
                                device=self.device)
        self.keys = []
        self.recording = False

    def __getattr__(self, name):
        return getattr(self._kernel, name)

    def __call__(self, *args, **kwargs):
        out = self._kernel(*args, **kwargs)
        if self.recording:
            a = self._sig.bind(*args, **kwargs)
            a.apply_defaults()
            a = a.arguments
            if a["counters"]:
                # with counters the kernel appends each pair's smoothings
                # and Newton iterations
                self._add(a, out[-2], out[-1])
        return out

    def _add(self, a, sm, it):
        i = len(self.keys)
        if i >= MAX_LAUNCHES:
            raise RuntimeError("more Newton launches than the recorder holds")
        A, tU = a["tables"][2], a["tU"]
        K, RK = int(A.shape[-1]), int(tU.shape[1])
        mixture = A.shape[0] == RK and RK // K > 1
        self.keys.append((K, RK // K, a["invq"] is not None, mixture))
        tensors = [a[k] for k in ARGS if isinstance(a[k], torch.Tensor)
                   and a[k].dim() == 1] + [sm, it]
        if self.on_card:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                self.stream.wait_event(ev)
                for t in tensors:
                    t.record_stream(self.stream)
                self._sum_into(i, a, sm, it)
        else:
            self._sum_into(i, a, sm, it)

    def _sum_into(self, i, a, sm, it):
        live = a["skip"] <= 0
        f = live.to(torch.float64)
        sp = a["spans"].to(torch.float64) * f
        S = int(a["tU"].shape[2])
        windows = lambda ids, rows: _covered(ids, a["begins"], a["spans"],
                                             live, rows, S)
        self.sums[i] = torch.stack([
            sp.sum(), (sp * sm.to(torch.float64)).sum(),
            (sp * it.to(torch.float64)).sum(), f.sum(),
            windows(a["e_ids"], int(a["tU"].shape[0])),
            windows(a["q_ids"], int(a["tQ"].shape[0]))])

    def totals(self) -> dict:
        """Operations, bytes and summed per-launch bound of the recorded
        launches, and the seconds each of the two peaks alone gives."""
        if self.on_card:
            self.stream.synchronize()
        sums = self.sums[:len(self.keys)].cpu().numpy()
        tot = dict.fromkeys(("pairs", "ops", "bytes", "bound_s", "ops_s",
                             "bytes_s"), 0.0)
        for key, row in zip(self.keys, sums):
            K, R, pinv, mixture = key
            o, b, t = counts.launch_bound(
                row, counts.coefficients(K, R, pinv, True, mixture))
            for k, v in (("pairs", row[3]), ("ops", o), ("bytes", b),
                         ("bound_s", t), ("ops_s", o / counts.PEAK_F32_FLOPS),
                         ("bytes_s", b / counts.PEAK_HBM_BYTES)):
                tot[k] += float(v)
        return dict(launches=len(self.keys), **tot)


def _covered(ids, begins, spans, live, rows: int, S: int) -> torch.Tensor:
    """Distinct (row, site) cells that the live pairs' windows
    [begin, begin + span) of rows ``ids`` cover: each input byte counted
    once a launch, however many pairs read it."""
    b = ids.long() * (S + 1) + begins.long().clamp(0, S)
    e = ids.long() * (S + 1) + (begins.long() + spans.long()).clamp(0, S)
    one = live.to(torch.int32)
    diff = torch.zeros(rows * (S + 1), dtype=torch.int32, device=ids.device)
    diff.index_add_(0, b, one)
    diff.index_add_(0, e, -one)
    return (diff.view(rows, S + 1).cumsum(1) > 0).sum().to(torch.float64)


def spin_marker(stream=None):
    """A short kernel (``torch.cuda._sleep``) that marks a stream in the
    trace."""
    if stream is None:
        torch.cuda._sleep(1000)
    else:
        with torch.cuda.stream(stream):
            torch.cuda._sleep(1000)


class Profiler:
    """torch.profiler over the window, device activity only."""

    def __init__(self, side_stream=None):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._side = side_stream

    def start(self):
        self._prof.start()
        # one marker after the other, so the trace orders them
        spin_marker()
        torch.cuda.synchronize()
        if self._side is not None:
            spin_marker(self._side)
            torch.cuda.synchronize()

    def stop(self):
        torch.cuda.synchronize()
        self._prof.stop()

    def events(self) -> list:
        """(name, stream, start_ns, end_ns) of every device event."""
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = e.start_ns()
            out.append((e.name(), e.device_resource_id(), start,
                        start + e.duration_ns()))
        return out


class DeviceTimeline:
    def __init__(self, events: list, t0_ns: int, t1_ns: int):
        """``events`` from :meth:`Profiler.events`; the window [t0, t1] in
        the profiler's clock (``time.time_ns``)."""
        spins = sorted((e for e in events if "spin" in e[0].lower()),
                       key=lambda e: e[2])
        # the markers ran first: the main stream's, then the recorder's
        self.side_stream = None
        if len(spins) >= 2 and spins[0][1] != spins[1][1]:
            self.side_stream = spins[1][1]
        self.t0, self.t1 = t0_ns, t1_ns
        ev = [e for e in events if e[1] != self.side_stream
              and e[3] > t0_ns and e[2] < t1_ns and "spin" not in e[0].lower()]
        self.events = ev
        iv = sorted((max(s, t0_ns), min(t, t1_ns)) for _, _, s, t in ev)
        merged = []
        for s, t in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy = merged

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy) / 1e9

    def time_by_name(self) -> dict:
        out = {}
        for name, _, s, t in self.events:
            out[name] = out.get(name, 0.0) + (t - s) / 1e9
        return out

    def seconds(self, contains: str, invert: bool = False) -> float:
        return sum((t - s) / 1e9 for name, _, s, t in self.events
                   if (contains in name) != invert)

    def gaps(self) -> list:
        """(start_ns, end_ns) of the idle stretches of the window."""
        out, at = [], self.t0
        for s, t in self.busy:
            if s > at:
                out.append((at, s))
            at = max(at, t)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def idle_by_host(self, spans: list) -> list:
        """Idle seconds grouped by the host stages active at each gap's
        middle (``spans``: (stage, start_ns, end_ns)), longest first."""
        starts = np.asarray([s for _, s, _ in spans], dtype=np.int64)
        ends = np.asarray([t for _, _, t in spans], dtype=np.int64)
        names = [n for n, _, _ in spans]
        out = {}
        for s, t in self.gaps():
            mid = (s + t) // 2
            on = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = "+".join(sorted({names[i] for i in on})) or "none"
            out[label] = out.get(label, 0.0) + (t - s) / 1e9
        return sorted(out.items(), key=lambda kv: -kv[1])
