"""jplace v3 output writer.

Text layout mirrors the reference byte-for-byte (src/io/jplace_util.cpp,
src/io/jplace_writer.hpp): fixed-point numbers at a configurable precision
(default 10), incremental per-chunk writes, rooted-tree edge renumbering via
the RtreeMapper, fields [edge_num, likelihood, like_weight_ratio,
distal_length, pendant_length].

The hot path consumes :class:`~epa_ng_tpu_torch.core.lwr.ChunkPlacements` (flat
column arrays straight from the fused device step): the rooted-edge
renumbering is one vectorized gather and row text is printf-batch formatted
— no per-placement python objects.

Under multi-host execution each host writes its own shard through this same
writer; shards are concatenated by parallel.dist.merge_jplace_shards
(replacing the reference's MPI-IO collective shared-file writes).
"""

from __future__ import annotations

import os
from typing import Optional, Union

from epa_ng_tpu_torch.core.lwr import ChunkPlacements, PQuery
from epa_ng_tpu_torch.tree.tree import RtreeMapper
from epa_ng_tpu_torch.utils.timer import span


def esc(s: str) -> str:
    """Escape a string for embedding in a JSON document. Headers (and the
    invocation) may contain quotes/backslashes; the reference interpolates
    them raw (src/io/jplace_util.cpp:29-34) which yields invalid JSON —
    here the document stays parseable."""
    return (s.replace("\\", "\\\\").replace('"', '\\"')
             .replace("\n", "\\n").replace("\r", "\\r")
             .replace("\t", "\\t"))


def _trailer(invocation: str) -> str:
    return ("\n  ],\n"
            f'  "metadata": {{"invocation": "{esc(invocation)}"}},\n'
            '  "version": 3,\n'
            '  "fields": ["edge_num", "likelihood", "like_weight_ratio", '
            '"distal_length", "pendant_length"]\n'
            "}\n")


def write_header(f, tree_string: str):
    f.write("{\n")
    f.write(f'  "tree": "{esc(tree_string)}",\n')
    f.write('  "placements": \n')
    f.write("  [\n")


class JplaceWriter:
    def __init__(self, outdir: str, file_name: str, tree_string: str,
                 invocation: str, mapper: Optional[RtreeMapper] = None,
                 precision: int = 10, fragment: bool = False):
        """``fragment=True`` writes only the raw placements fragments (no
        document header/trailer, no leading separator) — used for per-host
        shard files that merge_jplace_shards later assembles."""
        self.path = os.path.join(outdir, file_name)
        self._f = open(self.path, "w")
        self._tree = tree_string
        self._invocation = invocation
        self._mapper = mapper
        self._precision = precision
        self._fragment = fragment
        self._first = True
        # queries written; fragment mode persists it in a ".count" sidecar
        # so merge_jplace_shards can detect truncated/partial shards
        self.n_queries = 0

    def _fmt(self, v: float) -> str:
        return f"{v:.{self._precision}f}"

    def _placement_str(self, edge: int, logl: float, lwr: float,
                       distal: float, pendant: float) -> str:
        if self._mapper:
            edge, distal = self._mapper.in_rtree(int(edge), float(distal))
        return (f"[{int(edge)}, {self._fmt(logl)}, {self._fmt(lwr)}, "
                f"{self._fmt(distal)}, {self._fmt(pendant)}]")

    def write(self, placements: Union[ChunkPlacements, list]):
        with span("emit"):
            if isinstance(placements, ChunkPlacements):
                return self.write_batch(placements)
            return self.write_pqueries(placements)

    def _begin_chunk(self, out: list):
        if self._first:
            if not self._fragment:
                out.append("{\n")
                out.append(f'  "tree": "{esc(self._tree)}",\n')
                out.append('  "placements": \n')
                out.append("  [\n")
            self._first = False
        else:
            out.append(",\n")

    def _end_chunk(self, out: list):
        # trailing newline between chunks is handled by the leading ",\n"
        text = "".join(out)
        if text.endswith("\n"):
            text = text[:-1]
        self._f.write(text)

    def write_batch(self, cp: ChunkPlacements):
        """Format one chunk from flat columns (the fused-path hot exit)."""
        if not len(cp):
            return
        self.n_queries += len(cp.headers)
        edges, distals = cp.edges, cp.distals
        if self._mapper:
            edges, distals = self._mapper.in_rtree_batch(edges, distals)
        p = self._precision
        rowfmt = f"[%d, %.{p}f, %.{p}f, %.{p}f, %.{p}f]"
        rows = [rowfmt % t for t in zip(
            edges.tolist(), cp.logls.tolist(), cp.lwrs.tolist(),
            distals.tolist(), cp.pendants.tolist())]
        out: list[str] = []
        self._begin_chunk(out)
        offs = cp.offsets
        last = len(cp.headers) - 1
        for q, hs in enumerate(cp.headers):
            out.append('    {"p": [\n      ')
            out.append(",\n      ".join(rows[offs[q]:offs[q + 1]]))
            out.append("\n      ],\n")
            out.append('    "n": [')
            out.append(", ".join(f'"{esc(h)}"' for h in hs))
            out.append("]\n    }")
            if q < last:
                out.append(",")
            out.append("\n")
        self._end_chunk(out)

    def write_pqueries(self, pqueries: list[PQuery]):
        if not pqueries:
            return
        self.n_queries += len(pqueries)
        out: list[str] = []
        self._begin_chunk(out)
        for qi, pq in enumerate(pqueries):
            out.append('    {"p": [\n')
            n = len(pq.edge_nums)
            for i in range(n):
                out.append("      ")
                out.append(self._placement_str(
                    pq.edge_nums[i], pq.logls[i], pq.lwrs[i],
                    pq.distal_lengths[i], pq.pendant_lengths[i]))
                if i + 1 < n:
                    out.append(",")
                out.append("\n")
            out.append("      ],\n")
            out.append('    "n": [')
            out.append(", ".join(f'"{esc(h)}"' for h in pq.headers))
            out.append("]\n")
            out.append("    }")
            if qi + 1 < len(pqueries):
                out.append(",")
            out.append("\n")
        self._end_chunk(out)

    def close(self):
        if self._f is None:
            return
        with span("emit"):
            if self._fragment:
                with open(self.path + ".count", "w") as cf:
                    cf.write(str(self.n_queries))
            else:
                if self._first:
                    # no placements at all: still emit a valid document
                    self._f.write("{\n")
                    self._f.write(f'  "tree": "{esc(self._tree)}",\n')
                    self._f.write('  "placements": \n  [\n')
                self._f.write(_trailer(self._invocation))
            self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
