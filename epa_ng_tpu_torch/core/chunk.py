"""Encoded query chunks: the matrix-native representation of a chunk.

The reference hands `Sequence` objects (header + std::string) through its
whole pipeline; the per-query host work (char normalization, valid-range
trim, duplicate collapse) is scalar C++ (src/seq/Sequence.hpp,
src/util/Range.hpp:33-49, src/set_manipulators.cpp:208-226). At TPU
throughput the Python analog of that per-sequence work dominates the whole
run, so here a chunk is one ``[Q, S] uint8`` matrix of lookup-column codes
plus a ``[Q, 2] int32`` range table, and every transformation is a
vectorized table lookup:

- encode:   codes  = LOOKUP_COL[bytes]        (one fancy-index op)
- tip CLVs: qclv   = char_clvs[codes]         (device-side gather)
- masks:    qmask  = COL_STATE_MASK[codes]    (exact: every accepted char
            maps onto a lookup column with the identical state bitmask)
- collapse: np.unique over the code rows      (duplicate reads share work)

The native fastseq scanner emits (codes, ranges, row hashes) directly from
mmap'd FASTA; the Python fallback builds the byte matrix from strings first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from epa_ng_tpu_torch.models.charmaps import (INVALID_COL, lookup_chars,
                                        lookup_col_table, state_mask_table)
from epa_ng_tpu_torch.utils.timer import RECORDER


@dataclass
class EncodedChunk:
    """One encoded (possibly duplicate-collapsed) query chunk."""
    headers: list  # list[list[str]]: all duplicate headers per row
    codes: np.ndarray   # [Q, S] uint8 lookup-column codes
    ranges: np.ndarray  # [Q, 2] int32 (begin, span) valid ranges
    # [Q] uint64 code_hashes(codes) where the reader computed it
    row_hash: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.headers)

    @property
    def num_reads(self) -> int:
        return sum(len(h) for h in self.headers)


def col_state_masks(num_states: int) -> np.ndarray:
    """[C] uint32 state bitmask of each lookup column. Exactness argument:
    the lookup-column normalization (models.charmaps) only merges characters
    with identical state masks (case folds, U->T, gap variants onto the
    all-states column), so ``COL_STATE_MASK[code]`` equals the original
    character's mask for every character that encodes successfully."""
    tbl = state_mask_table(num_states)
    chars = lookup_chars(num_states)
    return np.array([tbl[ord(c)] for c in chars], dtype=np.uint32)


def rows_from_msa(msa) -> np.ndarray:
    """[Q, S] uint8 byte matrix from an MSA of equal-width sequences."""
    Q = len(msa)
    S = msa.num_sites
    if Q == 0:
        return np.zeros((0, S), dtype=np.uint8)
    blob = "".join(s.sequence for s in msa)
    if len(blob) != Q * S:
        for s in msa:
            if len(s.sequence) != S:
                raise ValueError(
                    "Query sequence length not same as reference alignment!")
    return np.frombuffer(blob.encode("ascii"), dtype=np.uint8).reshape(Q, S)


def ranges_from_rows(rows: np.ndarray) -> np.ndarray:
    """[Q, 2] (begin, span): trim leading/trailing literal '-' characters
    only (reference: src/util/Range.hpp:34-49 checks '-' alone; '?' or '.'
    at the edges do NOT shrink the range)."""
    return ranges_from_nongap(rows != ord("-"))


def ranges_from_nongap(nongap: np.ndarray) -> np.ndarray:
    """[Q, 2] (begin, span) from a boolean [Q, S] non-gap matrix."""
    Q, S = nongap.shape
    out = np.zeros((Q, 2), dtype=np.int32)
    if Q == 0:
        return out
    any_ = nongap.any(axis=1)
    begin = np.argmax(nongap, axis=1).astype(np.int32)
    last = (S - 1 - np.argmax(nongap[:, ::-1], axis=1)).astype(np.int32)
    out[:, 0] = np.where(any_, begin, 0)
    out[:, 1] = np.where(any_, last + 1 - begin, 0)
    return out


def invalid_char(byte: int, name: Optional[str] = None) -> ValueError:
    """The error for an invalid character, naming the sequence if known."""
    who = f" (sequence {name!r})" if name is not None else ""
    return ValueError(f"invalid character {chr(byte)!r} in sequence{who}")


def encode_rows(rows: np.ndarray, num_states: int,
                headers=None) -> tuple[np.ndarray, np.ndarray]:
    """(codes, ranges) from a byte matrix; raises on invalid characters."""
    codes = lookup_col_table(num_states)[rows]
    if (codes == INVALID_COL).any():
        q, s = np.argwhere(codes == INVALID_COL)[0]
        raise invalid_char(int(rows[q, s]),
                           headers[q][0] if headers else None)
    return codes, ranges_from_rows(rows)


def from_msa(msa, num_states: int) -> EncodedChunk:
    rows = rows_from_msa(msa)
    headers = [list(s.headers) for s in msa]
    codes, ranges = encode_rows(rows, num_states, headers)
    return EncodedChunk(headers=headers, codes=codes, ranges=ranges)


_FNV_BASIS = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def code_hashes(codes: np.ndarray) -> np.ndarray:
    """[Q] uint64 FNV-style hash of each codes row, read as little-endian
    8-byte words, the last one zero-padded (native/fastseq.cpp's row_hash
    computes the same in the reader's pass)."""
    Q, S = codes.shape
    pad = (-S) % 8
    if pad:
        codes = np.pad(codes, [(0, 0), (0, pad)])
    words = np.ascontiguousarray(codes).view("<u8")          # [Q, S/8]
    h = np.full(Q, _FNV_BASIS)
    with np.errstate(over="ignore"):
        for j in range(words.shape[1]):
            h = (h * _FNV_PRIME) ^ words[:, j]
    return h


def collapse(ec: EncodedChunk) -> EncodedChunk:
    """Collapse duplicate code rows into one entry holding all headers, in
    first-occurrence order (reference: src/set_manipulators.cpp:208-226).
    Duplicate short reads are the norm in metagenomic data; collapsed rows
    are placed once and reported under every name.

    A 64-bit hash of each codes row (``row_hash`` where the reader
    computed it, else ``code_hashes``) pre-screens: distinct hashes prove
    distinct codes, so distinct rows whatever the ranges (which
    ``check_chunk`` may rewrite), and the exact (byte-wise sort)
    comparison is skipped — on duplicate-free chunks it cost ~4x the whole
    FASTA scan. The recorder counts the chunks that go on to it
    (``collapse.exact``)."""
    Q = len(ec.headers)
    if Q <= 1:
        return ec
    hashes = code_hashes(ec.codes) if ec.row_hash is None else ec.row_hash
    # a set, not np.unique: numpy lets go of the interpreter lock for each
    # of its loops over Q elements, and while the pipeline's other threads
    # are busy, each time costs a wait to take it back
    if len(set(hashes.tolist())) == Q:
        return ec
    RECORDER.count("collapse.exact", 1)
    # key on (codes, ranges): '?' and '-' share the gap lookup column but
    # produce different valid ranges, which changes placement
    rows = np.hstack([
        np.ascontiguousarray(ec.codes),
        ec.ranges.astype("<i4").view(np.uint8).reshape(Q, 8)])
    view = rows.view([("", rows.dtype)] * rows.shape[1]).ravel()
    _, first, inverse = np.unique(view, return_index=True,
                                  return_inverse=True)
    if len(first) == Q:
        return ec
    # re-key groups by first occurrence so output keeps input order
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    group = rank[inverse]  # [Q] -> collapsed row index, first-occurrence order
    headers: list[list[str]] = [[] for _ in range(len(first))]
    for q in range(Q):
        headers[group[q]].extend(ec.headers[q])
    keep = first[order]
    return EncodedChunk(headers=headers, codes=ec.codes[keep],
                        ranges=ec.ranges[keep])
