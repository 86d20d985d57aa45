"""ctypes bindings for the native fastseq scanner (native/fastseq.cpp).

Builds the shared library on demand with g++ (cached next to the source;
rebuilt when the source is newer). Where that directory is not writable,
or the build fails, the pure-python scanner is used. Set
EPA_NG_TPU_NO_NATIVE=1 to force the pure-python path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

from epa_ng_tpu_torch.utils.timer import span

log = logging.getLogger("epa_ng_tpu_torch")

_lock = threading.Lock()
_lib = None
_tried = False


def _native_dir() -> str:
    # the C++ source ships INSIDE the package (epa_ng_tpu_torch/native/) so
    # installed wheels carry it and build the scanner on demand
    return os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "native")


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
    except Exception as e:  # no compiler / failure: fall back silently
        log.debug("native fastseq build failed: %s", e)
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
        out = os.path.join(_native_dir(), "_fastseq.so")
        try:
            fresh = (os.path.exists(out)
                     and os.path.getmtime(out) >= os.path.getmtime(src))
            if not fresh and not _build(src, out):
                return None
            lib = ctypes.CDLL(out)
        except OSError:
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
        lib.fs_read_chunk.restype = ctypes.c_long
        lib.fs_read_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64]
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


class NativeChunkReader:
    """Chunked FASTA -> (labels, code-matrix) reader using the native lib.

    Yields lookup-column code matrices directly (skipping the intermediate
    python string entirely) — the format the preplacement scorer consumes.
    """

    def __init__(self, path: str, code_map: np.ndarray, in_sites: int,
                 mask: np.ndarray | None = None,
                 skip: int = 0, limit: int | None = None):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native fastseq unavailable")
        self._h = self._lib.fs_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")
        self._code_map = np.ascontiguousarray(code_map, dtype=np.uint8)
        self._in_sites = in_sites
        self._mask = (np.ascontiguousarray(mask, dtype=np.uint8)
                      if mask is not None and mask.any() else None)
        self._out_sites = (in_sites if self._mask is None
                           else int(in_sites - self._mask.sum()))
        if skip:
            self._lib.fs_skip(self._h, skip)
        self._remaining = limit

    @property
    def out_sites(self) -> int:
        return self._out_sites

    def read_chunk(self, max_seqs: int):
        """(labels, codes[uint8, n x out_sites]) or (None, None) at EOF."""
        if self._remaining is not None:
            max_seqs = min(max_seqs, self._remaining)
        if max_seqs <= 0:
            return None, None
        codes = np.empty((max_seqs, self._out_sites), dtype=np.uint8)
        labels_cap = max_seqs * 512
        labels_buf = ctypes.create_string_buffer(labels_cap)
        mask_ptr = (self._mask.ctypes.data_as(ctypes.c_void_p)
                    if self._mask is not None else None)
        # the scan itself (ctypes releases the interpreter lock)
        with span("read.scan"):
            n = self._lib.fs_read_chunk(
                self._h, max_seqs, self._in_sites, self._out_sites,
                self._code_map.ctypes.data_as(ctypes.c_void_p), mask_ptr,
                codes.ctypes.data_as(ctypes.c_void_p), labels_buf,
                labels_cap)
        if n == -4:
            raise ValueError("invalid character in sequence")
        if n == -2:
            raise ValueError("sequence width mismatch")
        if n < 0:
            raise RuntimeError(f"native read failed ({n})")
        if n == 0:
            return None, None
        labels = labels_buf.raw.split(b"\x00")[:n]
        labels = [l.decode() for l in labels]
        if self._remaining is not None:
            self._remaining -= n
        return labels, codes[:n]

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
        self._reader = NativeChunkReader(path, _PASSTHROUGH, info.sites,
                                         mask=mask, skip=offset, limit=count)
        self._local_offset = offset

    @property
    def local_seq_offset(self) -> int:
        return self._local_offset

    def read_next(self, chunk_size: int):
        from epa_ng_tpu_torch.io.fasta import MSA, Sequence
        labels, rows = self._reader.read_chunk(chunk_size)
        msa = MSA()
        if labels is None:
            return msa
        msa.num_sites = rows.shape[1]
        seqs = msa.sequences
        for i, label in enumerate(labels):
            seqs.append(Sequence([label], rows[i].tobytes().decode("ascii")))
        return msa

    def read_next_encoded(self, chunk_size: int, num_states: int):
        """One chunk as an EncodedChunk: byte rows straight from the mmap
        scan, vectorized-encoded — no per-sequence python strings at all."""
        from epa_ng_tpu_torch.core import chunk as chunk_mod
        labels, rows = self._reader.read_chunk(chunk_size)
        if labels is None:
            return None
        headers = [[label] for label in labels]
        codes, ranges = chunk_mod.encode_rows(rows, num_states, headers)
        return chunk_mod.EncodedChunk(headers=headers, codes=codes,
                                      ranges=ranges)
