"""The comparison that decides ``correct``: what the window wrote, parsed
back from the jplace text, against the plain reference.

Numbers compared, each against a limit of its own (``benchmark/limits/
<cell>.json``):

- ``missing``: reads dispatched in the window without exactly one entry in
  the jplace, plus entries for reads never dispatched (exact: 0);
- ``output_bad``: sampled entries that break the output's rules on their
  own numbers: no placement or more than ``filter_max``, one past the
  first at or under the support threshold, LWR not descending, LWRs that
  sum past 1 or are not a softmax of the reported log-likelihoods
  (exact: 0);
- ``logl_err``: the widest gap between a reported log-likelihood and the
  reference's at the reported edge and branch lengths (the arithmetic);
- ``opt_gap``: the widest gap by which a read's best reported
  log-likelihood lies below the reference's best over its candidates (the
  candidate choice and the branch-length optimisation);
- ``rows_off``: the share of the sampled reads with an entry that keeps
  another number of placements than the reference (the candidate set the
  LWRs are taken over, and the output filter: a runner-up edge dropped,
  or only the top row written).
"""

from __future__ import annotations

import json
import re
from collections import defaultdict

import numpy as np

from benchmark.datagen import Dataset

FIELDS = ["edge_num", "likelihood", "like_weight_ratio", "distal_length",
          "pendant_length"]
NUMBERS = ("missing", "output_bad", "logl_err", "opt_gap", "rows_off")
# relative tolerance of the softmax check: f32 LWRs of printed logls
LWR_RTOL = 1e-4


class JplaceError(ValueError):
    pass


_TOKEN = re.compile(r"\(|\)|,|;|[^(),;]+")


def edge_map(tree_string: str, ds: Dataset) -> dict:
    """jplace edge_num -> (node, flipped): the node whose edge it is in the
    generated tree, and whether the jplace's distal end (the subtree side
    of its numbered newick) is the other end of that edge. Edges are
    matched by the taxa they separate; each edge's length is checked."""
    taxon_bit = {f"T{i}": 1 << i for i in range(len(ds.leaf_nodes))}
    full = (1 << len(ds.leaf_nodes)) - 1
    label_re = re.compile(r"^([^:{]*)(?::([^{]*))?(?:\{(\d+)\})?$")
    below = {}
    stack = [[]]
    closed = None   # leaf set of the group a ')' just closed
    for tok in _TOKEN.findall(tree_string.strip()):
        if tok == "(":
            stack.append([])
            closed = None
        elif tok == ")":
            closed = 0
            for k in stack.pop():
                closed |= k
            stack[-1].append(closed)
        elif tok in ",;":
            closed = None
            if tok == ";":
                break
        else:
            m = label_re.match(tok.strip())
            if not m:
                raise JplaceError(f"unreadable tree token {tok!r}")
            name, length, num = m.groups()
            if closed is None:
                if name not in taxon_bit:
                    raise JplaceError(f"unknown taxon {name!r}")
                bits = taxon_bit[name]
                stack[-1].append(bits)
            else:
                bits = closed
            closed = None
            if num is not None:
                below[int(num)] = (bits, float(length))
    out = {}
    node_bits = _node_bits(ds)
    by_bits = {b: n for n, b in node_bits.items()}
    for num, (bits, length) in below.items():
        if bits in by_bits:
            node, flip = by_bits[bits], False
        elif full ^ bits in by_bits:
            node, flip = by_bits[full ^ bits], True
        else:
            raise JplaceError(f"edge {num} splits no edge of the tree")
        if abs(length - ds.length[node]) > 1e-6:
            raise JplaceError(f"edge {num} has length {length}, the tree "
                              f"{ds.length[node]}")
        out[num] = (node, flip)
    if len(out) != int((ds.parent >= 0).sum()):
        raise JplaceError(f"the jplace tree numbers {len(out)} edges, the "
                          f"tree has {int((ds.parent >= 0).sum())}")
    return out


def _node_bits(ds: Dataset) -> dict:
    bits = {}
    taxon = ds.taxon
    order = []
    stack = [ds.root]
    while stack:
        n = stack.pop()
        order.append(n)
        stack.extend(ds.children[n])
    for n in reversed(order):
        if not ds.children[n]:
            bits[n] = 1 << taxon[n]
        else:
            b = 0
            for c in ds.children[n]:
                b |= bits[c]
            bits[n] = b
    bits.pop(ds.root)
    return bits


def read_jplace(path: str, ds: Dataset):
    """(edge map, {read name: [entry rows, ...] in file order})."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("fields") != FIELDS or doc.get("version") != 3:
        raise JplaceError(f"unexpected fields/version: {doc.get('fields')}, "
                          f"{doc.get('version')}")
    emap = edge_map(doc["tree"], ds)
    by_name = defaultdict(list)
    for pq in doc["placements"]:
        rows = pq["p"]
        for name in pq["n"]:
            by_name[name].append(rows)
    return emap, by_name


def count_missing(by_name: dict, ds: Dataset, attempted: int) -> int:
    """Reads dispatched without exactly one entry per pass, plus entries
    of reads never dispatched."""
    Q = ds.num_reads
    want = np.full(Q, attempted // Q)
    want[:attempted % Q] += 1
    bad = 0
    names = {ds.read_name(i): i for i in range(Q)}
    for name, entries in by_name.items():
        i = names.get(name)
        bad += len(entries) if i is None else abs(len(entries) - want[i])
    seen = {names[n] for n in by_name if n in names}
    bad += int(sum(want[i] for i in range(Q) if i not in seen))
    return int(bad)


def output_bad(rows: list, support: float, fmax: int) -> bool:
    """True where the entry breaks the output's rules on its own numbers
    (rows: (edge, logl, lwr, ...))."""
    if not rows or len(rows) > fmax:
        return True
    w = np.asarray([r[2] for r in rows])
    logl = np.asarray([r[1] for r in rows])
    if (np.diff(w) > 1e-9).any() or (w[1:] <= support - 1e-9).any():
        return True
    if w.sum() > 1 + 1e-6:
        return True
    want = w[0] * np.exp(logl - logl[0])
    return bool((np.abs(w - want) > LWR_RTOL * w[0] + 1e-9).any())


def compare(ref, ref_out: dict, port: dict, support: float,
            fmax: int) -> dict:
    """The numbers for the sampled reads.

    ``ref_out``: {read: (best logl, [Placement])} from the reference;
    ``port``: {read: [[(node, logl, lwr, distal_from_node, pendant), ...]
    per entry of that read]}."""
    nodes, reads, pend, dist, logl = [], [], [], [], []
    opt_gap = 0.0
    bad = rows_off = 0
    for q, entries in port.items():
        best, kept = ref_out[q]
        off = False
        for rows in entries:
            if output_bad(rows, support, fmax):
                bad += 1
            off |= len(rows) != len(kept)
            if not rows:
                continue
            opt_gap = max(opt_gap, best - max(r[1] for r in rows))
            for r in rows:
                nodes.append(r[0])
                reads.append(q)
                logl.append(r[1])
                dist.append(r[3])
                pend.append(r[4])
        rows_off += off
    at = ref.logl_at(np.asarray(nodes, np.int64), np.asarray(reads, np.int64),
                     np.asarray(pend), np.asarray(dist))
    logl_err = float(np.abs(np.asarray(logl) - at).max()) if len(at) else 0.0
    return dict(output_bad=bad, logl_err=logl_err, opt_gap=float(opt_gap),
                rows_off=rows_off / max(1, len(port)))


def port_rows(entries: list, emap: dict, ds: Dataset) -> list:
    """jplace rows -> (node, logl, lwr, distal from the node, pendant)."""
    out = []
    for rows in entries:
        conv = []
        for edge, logl, w, distal, pendant in rows:
            node, flip = emap[int(edge)]
            d = ds.length[node] - distal if flip else distal
            conv.append((node, float(logl), float(w), float(d),
                         float(pendant)))
        out.append(conv)
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)
