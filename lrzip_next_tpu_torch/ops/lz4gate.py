"""Compressibility pre-test gating the backend codecs.

The reference runs a quick LZ4 pass and skips the expensive backend when
LZ4 cannot shave a single byte (src/stream.c:2325-2379 lz4_compresses).
Here the primary gate binds the system liblz4 via ctypes (same library
the reference links); when unavailable, an order-0 entropy + 8-gram
repetition estimate stands in (also usable on-device as a jnp reduction).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

import numpy as np

_lz4 = None
_lz4_checked = False
_lz4_lock = threading.Lock()


def _load_lz4():
    """The loaded liblz4 or None.  The gate runs on pool threads: the
    first callers wait for the one that loads, so that no block of a
    chunk is gated by the entropy estimate while its neighbours are
    gated by LZ4 (the archive bytes depend on the gate's answers)."""
    global _lz4, _lz4_checked
    if _lz4_checked:
        return _lz4
    with _lz4_lock:
        if _lz4_checked:
            return _lz4
        for name in ("liblz4.so.1", "liblz4.so",
                     ctypes.util.find_library("lz4")):
            if not name:
                continue
            try:
                lib = ctypes.CDLL(name)
                lib.LZ4_compress_default.restype = ctypes.c_int
                lib.LZ4_compress_default.argtypes = [
                    ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                    ctypes.c_int]
                _lz4 = lib
                break
            except OSError:
                continue
        _lz4_checked = True
    return _lz4


def lz4_compress_bound_pct(data: bytes, sample_limit: int = 100 << 20
                           ) -> Optional[float]:
    """Compressed-size percentage of an LZ4 pass over (a prefix of) data.

    None when liblz4 is unavailable.
    """
    lib = _load_lz4()
    if lib is None:
        return None
    in_len = min(len(data), sample_limit)
    if in_len == 0:
        return 100.0
    dst = ctypes.create_string_buffer(in_len + 64)
    ret = lib.LZ4_compress_default(data[:in_len], dst, in_len, in_len + 64)
    if ret <= 0:
        return 101.0
    return 100.0 * ret / in_len


def entropy_estimate_pct(data: bytes) -> float:
    """Order-0 entropy as a compressed-size percentage estimate."""
    if not data:
        return 100.0
    arr = np.frombuffer(data, dtype=np.uint8)
    counts = np.bincount(arr, minlength=256).astype(np.float64)
    p = counts[counts > 0] / len(arr)
    bits = -(p * np.log2(p)).sum()
    return 100.0 * bits / 8.0


def compressibility_gate(data: bytes, threshold: int = 100) -> bool:
    """True when the block looks compressible enough to run the backend.

    Mirrors the reference's progressive test: try growing prefixes and
    succeed as soon as any compresses below the threshold
    (src/stream.c:2347-2370).
    """
    n = len(data)
    if n == 0:
        return False
    lib = _load_lz4()
    if lib is None:
        return entropy_estimate_pct(data) < float(threshold)
    test_len = n
    pos = 0
    in_len = min(test_len, 100 << 20)
    buftest_size = in_len
    while test_len > 0:
        chunk = data[:pos + in_len] if pos == 0 else data[:buftest_size]
        pct = lz4_compress_bound_pct(bytes(chunk), sample_limit=len(chunk))
        if pct is not None and pct < float(threshold):
            return True
        test_len -= in_len
        if test_len > 0:
            buftest_size += in_len
            if buftest_size < 10 << 20:
                buftest_size <<= 1
            in_len = min(test_len, buftest_size)
    return False
