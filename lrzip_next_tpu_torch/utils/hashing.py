"""Hash registry: the 13 selectable whole-file hashes + per-chunk CRC32.

Mirrors the reference's libgcrypt-backed registry (src/main.c:64-80) using
hashlib.  Digest byte order matches gcrypt's output (digests are raw byte
strings; the CRC32 digest is serialised MSB-first, which is how gcrypt
returns it and therefore how it lands in the archive via the memcpy at
reference src/rzip.c:745 + put_u32 at src/rzip.c:190-194).
"""

from __future__ import annotations

import collections
import hashlib
import threading
import time
import zlib

from ..format.constants import HASH_LEN, HASH_NAME


class Crc32:
    """Incremental CRC32 with gcrypt-compatible digest serialisation."""

    digest_size = 4

    def __init__(self) -> None:
        self._crc = 0

    def update(self, data) -> None:
        self._crc = zlib.crc32(data, self._crc)

    def digest(self) -> bytes:
        # gcrypt GCRY_MD_CRC32 returns the 4 digest bytes MSB-first.
        return (self._crc & 0xFFFFFFFF).to_bytes(4, "big")

    def intdigest_le_of_storage(self) -> int:
        """The u32 the reference's memcpy-on-LE produces from the digest."""
        return int.from_bytes(self.digest(), "little")


_HASHLIB_BY_CODE = {
    1: ("md5", None),
    2: ("ripemd160", None),
    3: ("sha256", None),
    4: ("sha384", None),
    5: ("sha512", None),
    6: ("sha3_256", None),
    7: ("sha3_512", None),
    8: ("shake_128", 16),
    9: ("shake_128", 32),
    10: ("shake_128", 64),
    11: ("shake_256", 16),
    12: ("shake_256", 32),
    13: ("shake_256", 64),
}


class ArchiveHash:
    """Whole-archive hash selected by magic byte 14."""

    def __init__(self, code: int) -> None:
        self.code = code
        self.name = HASH_NAME[code]
        self.digest_size = HASH_LEN[code]
        if code == 0:
            self._h = Crc32()
            self._xof = False
        else:
            algo, xof_len = _HASHLIB_BY_CODE[code]
            self._h = hashlib.new(algo)
            self._xof = xof_len is not None
            self._xof_len = xof_len

    def update(self, data) -> None:
        self._h.update(data)

    def digest(self) -> bytes:
        if self.code == 0:
            return self._h.digest()
        if self._xof:
            return self._h.digest(self._xof_len)
        return self._h.digest()


# The slice the hash thread hands ``ArchiveHash.update`` at a time where
# it is given a whole input: large enough that hashlib releases the GIL
# over nearly all of it, small enough that a stop request waits for at
# most one slice.
HASH_SLICE = 64 << 20

HASH_THREAD_NAME = "lrzt-archive-hash"


class HashThread:
    """``hasher.update`` over the parts that ``put`` hands it, in order,
    on a thread of its own that starts at construction.  ``data`` (a
    uint8 array), where given, is handed in at once in ``HASH_SLICE``
    slices: the compress side hashes its whole input so, and the decode
    side puts each chunk's bytes as they land.

    ``put(part)`` returns the number of parts handed in so far;
    ``wait_for(n)`` blocks until the first ``n`` parts are hashed;
    ``wait()`` lets the thread hash what it holds and joins it; ``stop()``
    drops what it holds and joins it after the part it is hashing.
    ``put``, ``wait_for`` and ``wait`` re-raise the thread's error.
    ``busy_ms`` is the thread's milliseconds in ``hasher.update``.  The
    thread is a daemon, so that one whose owner never ends it (a decode
    generator left unfinished) does not hold the interpreter at exit."""

    def __init__(self, hasher: ArchiveHash, data=None) -> None:
        self.hasher = hasher
        self.busy_ms = 0.0
        self._parts = collections.deque()
        self._put = self._hashed = 0
        self._closed = self._ended = False
        self._error = None
        self._cond = threading.Condition()
        if data is not None:
            for p in range(0, len(data), HASH_SLICE):
                self.put(data[p:p + HASH_SLICE])
        self._thread = threading.Thread(target=self._run,
                                        name=HASH_THREAD_NAME, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            while True:
                with self._cond:
                    while not self._parts and not self._closed:
                        self._cond.wait()
                    if not self._parts:
                        return
                    part = self._parts.popleft()
                t0 = time.perf_counter()
                self.hasher.update(part)
                self.busy_ms += (time.perf_counter() - t0) * 1e3
                del part    # a part may pin a read-back buffer
                with self._cond:
                    self._hashed += 1
                    self._cond.notify_all()
        except BaseException as e:  # re-raised on the caller's thread
            self._error = e
        finally:
            with self._cond:
                self._parts.clear()
                self._ended = True
                self._cond.notify_all()

    def put(self, part) -> int:
        with self._cond:
            if self._error is not None:
                raise self._error
            self._parts.append(part)
            self._put += 1
            self._cond.notify_all()
            return self._put

    def wait_for(self, n: int) -> None:
        with self._cond:
            while self._hashed < n and not self._ended:
                self._cond.wait()
            if self._error is not None:
                raise self._error

    def wait(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join()
        if self._error is not None:
            raise self._error

    def stop(self) -> None:
        with self._cond:
            self._closed = True
            self._parts.clear()
            self._cond.notify_all()
        self._thread.join()


def crc32_of(data) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


# CRC-32 arithmetic in GF(2) modulo the polynomial, bit-reflected as
# zlib's table is (x^0 in the top bit): what zlib's crc32_combine
# computes, which Python's zlib module does not expose.
_CRC_POLY = 0xEDB88320


def _mult_mod_poly(a: int, b: int) -> int:
    """a(x) * b(x) modulo the CRC polynomial; ``a`` non-zero."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if not a & (m - 1):
                return p
        m >>= 1
        b = (b >> 1) ^ _CRC_POLY if b & 1 else b >> 1


def _x_pow_2k() -> list:
    """x^(2^k) modulo the polynomial, k = 0..31."""
    table, p = [], 1 << 30          # x^1
    for _ in range(32):
        table.append(p)
        p = _mult_mod_poly(p, p)
    return table


_X_POW_2K = _x_pow_2k()


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC-32 of ``A + B`` from ``crc1``, the CRC-32 of ``A`` (or any
    running value, as ``zlib.crc32(B, crc1)`` takes it), ``crc2``, that of
    ``B``, and ``len2``, the bytes of ``B``, without reading ``B``: crc1
    times x^(8 len2), plus crc2, modulo the polynomial."""
    xn, k, n = 1 << 31, 3, len2     # x^0; x^(8 len2) = x^(len2 2^3)
    while n:
        if n & 1:
            xn = _mult_mod_poly(_X_POW_2K[k & 31], xn)
        n >>= 1
        k += 1
    return (_mult_mod_poly(xn, crc1 & 0xFFFFFFFF) ^ crc2) & 0xFFFFFFFF


def stored_crc_int(crc: int) -> int:
    """Convert a CRC32 value to the integer stored in the token stream.

    The reference memcpys gcrypt's MSB-first digest into a u32 on a
    little-endian machine and writes it LE (src/rzip.c:745,760), so the
    on-disk bytes are the digest MSB-first.  Reading those 4 bytes LE
    yields a byte-swapped value; this helper produces that value so both
    sides compare consistently.
    """
    return int.from_bytes(crc.to_bytes(4, "big"), "little")
