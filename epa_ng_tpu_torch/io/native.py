"""ctypes bindings for the native fastseq scanner (native/fastseq.cpp).

Builds the shared library on demand with g++, next to the source, under a
name keyed on a hash of the source (``_fastseq-<hash>.so``): a library
built from another version of the source is never loaded. Where that
directory is not writable, or the build fails, the pure-python scanner is
used, with a warning. Set EPA_NG_TPU_NO_NATIVE=1 to force the pure-python
path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
import threading
from typing import NamedTuple

import numpy as np

from epa_ng_tpu_torch.core.chunk import EncodedChunk, invalid_char
from epa_ng_tpu_torch.models.charmaps import INVALID_COL, lookup_col_table
from epa_ng_tpu_torch.utils.timer import RECORDER, span

log = logging.getLogger("epa_ng_tpu_torch")

_lock = threading.Lock()
_lib = None
_tried = False

# bytes a record's label may take in a chunk's label buffer, on average
LABEL_BYTES = 512


def _native_dir() -> str:
    # the C++ source ships INSIDE the package (epa_ng_tpu_torch/native/) so
    # installed wheels carry it and build the scanner on demand
    return os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "native")


def _lib_path(src: str) -> str:
    """The library built from ``src`` as it is now."""
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(os.path.dirname(src), f"_fastseq-{tag}.so")


def _build(src: str, out: str) -> bool:
    # build under a name of this process's own, then rename it into place
    # atomically: concurrent processes never load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", tmp, src],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native fastseq build failed (%s); the python reader "
                    "is used", e)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib():
    """The loaded library, or None when unavailable."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("EPA_NG_TPU_NO_NATIVE"):
            return None
        src = os.path.join(_native_dir(), "fastseq.cpp")
        if not os.path.exists(src):
            return None
        try:
            out = _lib_path(src)
            if not os.path.exists(out) and not _build(src, out):
                return None
            lib = ctypes.CDLL(out)
        except OSError as e:
            log.warning("native fastseq unavailable (%s); the python "
                        "reader is used", e)
            return None
        lib.fs_open.restype = ctypes.c_void_p
        lib.fs_open.argtypes = [ctypes.c_char_p]
        lib.fs_close.argtypes = [ctypes.c_void_p]
        lib.fs_info.restype = ctypes.c_long
        lib.fs_info.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.c_void_p, ctypes.c_int64]
        lib.fs_skip.restype = ctypes.c_long
        lib.fs_skip.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.fs_read_encoded.restype = ctypes.c_long
        lib.fs_read_encoded.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
    return _lib


def native_info(path: str):
    """(n_seqs, n_sites, gap_mask) via the native scanner, or None."""
    lib = get_lib()
    if lib is None:
        return None
    n_seqs = ctypes.c_int64(0)
    n_sites = ctypes.c_int64(0)
    # first pass for sizes (mask needs the width); small files: do 2 passes
    rc = lib.fs_info(path.encode(), ctypes.byref(n_seqs),
                     ctypes.byref(n_sites), None, 0)
    if rc == -3:
        return None  # not fasta: let the python path handle phylip etc.
    if rc == -2:
        raise ValueError(
            f"{path} does not contain equal size sequences!")
    if rc != 0:
        return None
    mask = np.zeros(max(1, n_sites.value), dtype=np.uint8)
    rc = lib.fs_info(path.encode(), ctypes.byref(n_seqs),
                     ctypes.byref(n_sites),
                     mask.ctypes.data_as(ctypes.c_void_p), n_sites.value)
    if rc != 0:
        return None
    return n_seqs.value, n_sites.value, mask[:n_sites.value].astype(bool)


class NativeChunk(NamedTuple):
    """One chunk as the native pass leaves it."""
    labels: list        # list[str]
    codes: np.ndarray   # [n, out_sites] uint8, through the call's code map
    ranges: np.ndarray  # [n, 2] int32 (begin, span), '-' trimmed
    row_hash: np.ndarray  # [n] uint64: core.chunk.code_hashes(codes)


class NativeChunkReader:
    """Chunked FASTA reader over the native lib: each call is one pass over
    the mmap, outside the interpreter lock, that writes a chunk's codes,
    valid ranges, row hashes and labels straight into numpy buffers."""

    def __init__(self, path: str, in_sites: int,
                 mask: np.ndarray | None = None,
                 skip: int = 0, limit: int | None = None):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native fastseq unavailable")
        self._h = self._lib.fs_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")
        if mask is not None and len(mask) != in_sites:
            raise ValueError(f"premask of {len(mask)} columns for "
                             f"{in_sites} sites")
        self._in_sites = in_sites
        self._mask = (np.ascontiguousarray(mask, dtype=np.uint8)
                      if mask is not None and mask.any() else None)
        # the kept input columns, for records the scan gathers
        self._cols = (np.arange(in_sites, dtype=np.int32)
                      if self._mask is None
                      else np.flatnonzero(self._mask == 0).astype(np.int32))
        self._out_sites = len(self._cols)
        self._labels = np.empty(0, dtype=np.uint8)
        self._meta = np.zeros(5, dtype=np.int64)
        if skip:
            self._lib.fs_skip(self._h, skip)
        self._remaining = limit

    @property
    def out_sites(self) -> int:
        return self._out_sites

    def read_chunk(self, max_seqs: int, code_map: np.ndarray):
        """The next NativeChunk of at most ``max_seqs`` records, encoded
        through ``code_map`` (256 uint8 entries, 255 = invalid byte), or
        None at EOF."""
        if self._remaining is not None:
            max_seqs = min(max_seqs, self._remaining)
        if max_seqs <= 0:
            return None
        code_map = np.ascontiguousarray(code_map)
        if code_map.shape != (256,) or code_map.dtype != np.uint8:
            raise ValueError("code_map must be 256 uint8 entries")
        codes = np.empty((max_seqs, self._out_sites), dtype=np.uint8)
        ranges = np.empty((max_seqs, 2), dtype=np.int32)
        hashes = np.empty(max_seqs, dtype=np.uint64)
        if len(self._labels) < max_seqs * LABEL_BYTES:
            self._labels = np.empty(max_seqs * LABEL_BYTES, dtype=np.uint8)
        meta = self._meta
        mask_ptr = self._mask.ctypes.data if self._mask is not None else None
        # the pass itself (ctypes releases the interpreter lock)
        with span("read.scan"):
            n = self._lib.fs_read_encoded(
                self._h, max_seqs, self._in_sites, self._out_sites,
                code_map.ctypes.data, mask_ptr,
                self._cols.ctypes.data, codes.ctypes.data,
                ranges.ctypes.data, hashes.ctypes.data,
                self._labels.ctypes.data, len(self._labels),
                meta.ctypes.data)
        text = self._labels[:meta[0]].tobytes().decode()
        labels = text[:-1].split("\x00") if text else []
        if n == -4:
            raise invalid_char(_shown_byte(int(meta[4])),
                               labels[int(meta[3])])
        if n == -2:
            raise ValueError("sequence width mismatch")
        if n < 0:
            raise RuntimeError(f"native read failed ({n})")
        RECORDER.count("read.rows_gather", int(meta[1]))
        RECORDER.count("read.rows_byteloop", int(meta[2]))
        if n == 0:
            return None
        if self._remaining is not None:
            self._remaining -= n
        return NativeChunk(labels, codes[:n], ranges[:n], hashes[:n])

    def close(self):
        if self._h:
            self._lib.fs_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def passthrough_map() -> np.ndarray:
    """Code map whose "codes" are the uppercased sequence bytes themselves:
    lets NativeChunkReader act as a fast fasta scanner producing plain
    (premask-stripped, uppercased) sequence strings. Permissive — real
    per-datatype validation happens in models.charmaps.encode_states."""
    table = np.full(256, 255, dtype=np.uint8)
    for c in range(ord("A"), ord("Z") + 1):
        table[c] = c
        table[c + 32] = c  # lowercase folds
    for ch in "0123456789-?.*~":
        table[ord(ch)] = ord(ch)
    return table


_PASSTHROUGH = passthrough_map()


def _shown_byte(b: int) -> int:
    """The byte as the python reader reports it: uppercased."""
    return int(_PASSTHROUGH[b]) if _PASSTHROUGH[b] != 255 else b


@functools.lru_cache(maxsize=None)
def encoded_map(num_states: int) -> np.ndarray:
    """Code map from a FASTA byte straight to its lookup column: the
    passthrough map, then ``lookup_col_table(num_states)``. Read-only."""
    table = lookup_col_table(num_states)[_PASSTHROUGH]
    table[_PASSTHROUGH == 255] = INVALID_COL
    table.setflags(write=False)
    return table


class NativeMSAStream:
    """Drop-in replacement for fasta.MSAStream backed by the native scanner:
    mmap + table-driven scan emits uppercased, premask-stripped sequence
    bytes straight into a numpy matrix (no per-line python parsing). Same
    chunking, premasking, and host-shard semantics."""

    def __init__(self, path: str, info, premask: bool = True,
                 split: bool = False, process_index: int = 0,
                 process_count: int = 1, shard: tuple | None = None):
        mask = info.gap_mask if premask and info.gap_count else None
        offset, count = 0, info.sequences
        if shard is not None:
            offset, count = shard
        elif split and process_count > 1:
            total = info.sequences
            base = total // process_count
            rem = total % process_count
            offset = process_index * base + min(process_index, rem)
            count = base + (1 if process_index < rem else 0)
        self._reader = NativeChunkReader(path, info.sites, mask=mask,
                                         skip=offset, limit=count)
        self._local_offset = offset

    @property
    def local_seq_offset(self) -> int:
        return self._local_offset

    def read_next(self, chunk_size: int):
        from epa_ng_tpu_torch.io.fasta import MSA, Sequence
        got = self._reader.read_chunk(chunk_size, _PASSTHROUGH)
        msa = MSA()
        if got is None:
            return msa
        msa.num_sites = got.codes.shape[1]
        seqs = msa.sequences
        for label, row in zip(got.labels, got.codes):
            seqs.append(Sequence([label], row.tobytes().decode("ascii")))
        return msa

    def read_next_encoded(self, chunk_size: int, num_states: int):
        """One chunk as an EncodedChunk, finished by the native pass:
        lookup-column codes, valid ranges and row hashes, with no
        per-sequence python strings but the labels."""
        got = self._reader.read_chunk(chunk_size, encoded_map(num_states))
        if got is None:
            return None
        return EncodedChunk(headers=[[label] for label in got.labels],
                            codes=got.codes, ranges=got.ranges,
                            row_hash=got.row_hash)
