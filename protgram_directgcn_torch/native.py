"""ctypes loader for the C++ n-gram ETL (``csrc/ngram_etl.cpp``).

Port of protgram_directgcn_tpu/native.py.  The library is built by g++ at
first use (``ops/_nvcc.compile_host_source``, into the gitignored
``_build/``) and loaded with ctypes; the five entry points take numpy arrays.
Where the build or the load fails, :func:`available` is false and the graph
builder keeps its numpy path (graph/builder.py), as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import numpy as np

from protgram_directgcn_torch.ops import _nvcc
from protgram_directgcn_torch.utils.io import logger

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# The build's {"path", "seconds", "built", "log"}, once built.
BUILD_INFO: Dict[str, object] = {}

_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built on the first call), or None where it does
    not build or load."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            info = _nvcc.compile_host_source("ngram_etl")
            lib = ctypes.CDLL(str(info["path"]))
        except (OSError, RuntimeError) as exc:
            logger.warning("native ETL unavailable (%s); the builder uses numpy", exc)
            return None
        lib.pack_ngrams_batch.restype = ctypes.c_int64
        lib.pack_ngrams_batch.argtypes = [_u8p, _i64p, ctypes.c_int64, ctypes.c_int32, _u64p,
                                          _i64p]
        lib.emit_pairs.restype = ctypes.c_int64
        lib.emit_pairs.argtypes = [_i64p, _i64p, ctypes.c_int64, ctypes.c_uint64, _u64p]
        lib.aggregate_u64.restype = ctypes.c_int64
        lib.aggregate_u64.argtypes = [_u64p, ctypes.c_int64, _u64p, _i64p]
        lib.merge_aggregates.restype = ctypes.c_int64
        lib.merge_aggregates.argtypes = [_u64p, _i64p, ctypes.c_int64, _u64p, _i64p,
                                         ctypes.c_int64, _u64p, _i64p]
        lib.lookup_sorted.restype = None
        lib.lookup_sorted.argtypes = [_u64p, ctypes.c_int64, _u64p, ctypes.c_int64, _i64p]
        BUILD_INFO.update(info)
        _lib = lib
        logger.info("native ETL loaded from %s", info["path"])
        return _lib


def available() -> bool:
    return get_lib() is not None


def pack_ngrams_batch(seq_bytes_list, n: int):
    """The n-gram keys of each byte sequence, concatenated, and the window
    count of each: (keys, counts)."""
    lib = get_lib()
    offsets = np.zeros(len(seq_bytes_list) + 1, dtype=np.int64)
    for i, b in enumerate(seq_bytes_list):
        offsets[i + 1] = offsets[i] + len(b)
    data = (np.concatenate([np.frombuffer(bytes(b), dtype=np.uint8) for b in seq_bytes_list])
            if seq_bytes_list else np.empty(0, np.uint8))
    max_windows = int(sum(max(0, len(b) - n + 1) for b in seq_bytes_list))
    out = np.empty(max_windows, dtype=np.uint64)
    counts = np.empty(len(seq_bytes_list), dtype=np.int64)
    total = lib.pack_ngrams_batch(np.ascontiguousarray(data), offsets, len(seq_bytes_list), n,
                                  out, counts)
    return out[:total], counts


def emit_pairs(ids: np.ndarray, counts: np.ndarray, nn: int) -> np.ndarray:
    """``ids[i] * nn + ids[i + 1]`` for consecutive windows of each sequence."""
    lib = get_lib()
    max_pairs = int(np.maximum(counts - 1, 0).sum())
    out = np.empty(max_pairs, dtype=np.uint64)
    written = lib.emit_pairs(np.ascontiguousarray(ids, np.int64),
                             np.ascontiguousarray(counts, np.int64), len(counts),
                             np.uint64(nn), out)
    return out[:written]


def aggregate_u64(keys: np.ndarray):
    """Sorted unique keys and their counts."""
    lib = get_lib()
    keys = np.ascontiguousarray(keys, np.uint64).copy()
    out_keys = np.empty(len(keys), dtype=np.uint64)
    out_counts = np.empty(len(keys), dtype=np.int64)
    u = lib.aggregate_u64(keys, len(keys), out_keys, out_counts)
    return out_keys[:u].copy(), out_counts[:u].copy()


def merge_aggregates(ka, ca, kb, cb):
    """Two sorted unique (key, count) runs merged, counts of equal keys summed."""
    lib = get_lib()
    out_keys = np.empty(len(ka) + len(kb), dtype=np.uint64)
    out_counts = np.empty(len(ka) + len(kb), dtype=np.int64)
    u = lib.merge_aggregates(
        np.ascontiguousarray(ka, np.uint64), np.ascontiguousarray(ca, np.int64), len(ka),
        np.ascontiguousarray(kb, np.uint64), np.ascontiguousarray(cb, np.int64), len(kb),
        out_keys, out_counts)
    return out_keys[:u].copy(), out_counts[:u].copy()


def lookup_sorted(vocab_keys: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Each key's rank in the sorted vocabulary, -1 where absent."""
    lib = get_lib()
    out = np.empty(len(keys), dtype=np.int64)
    lib.lookup_sorted(np.ascontiguousarray(vocab_keys, np.uint64), len(vocab_keys),
                      np.ascontiguousarray(keys, np.uint64), len(keys), out)
    return out
