"""Hash registry: the 13 selectable whole-file hashes + per-chunk CRC32.

Mirrors the reference's libgcrypt-backed registry (src/main.c:64-80) using
hashlib.  Digest byte order matches gcrypt's output (digests are raw byte
strings; the CRC32 digest is serialised MSB-first, which is how gcrypt
returns it and therefore how it lands in the archive via the memcpy at
reference src/rzip.c:745 + put_u32 at src/rzip.c:190-194).
"""

from __future__ import annotations

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


# The slice the hash thread hands ``ArchiveHash.update`` at a time: large
# enough that hashlib releases the GIL over nearly all of it, small enough
# that a stop request waits for at most one slice.
HASH_SLICE = 64 << 20

HASH_THREAD_NAME = "lrzt-archive-hash"


class HashThread:
    """``hasher.update`` over the whole of ``data`` (a uint8 array), in
    order, in ``HASH_SLICE`` slices, on a thread of its own that starts
    at construction.

    ``wait()`` joins it and re-raises its error; ``stop()`` asks it to
    end after the slice it is hashing and joins it.  ``busy_ms`` is the
    thread's milliseconds from its start to its end."""

    def __init__(self, hasher: ArchiveHash, data) -> None:
        self.hasher = hasher
        self.busy_ms = 0.0
        self._error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(data,),
                                        name=HASH_THREAD_NAME)
        self._thread.start()

    def _run(self, data) -> None:
        t0 = time.perf_counter()
        try:
            for p in range(0, len(data), HASH_SLICE):
                if self._stop.is_set():
                    return
                self.hasher.update(data[p:p + HASH_SLICE])
        except BaseException as e:  # re-raised on the caller's thread
            self._error = e
        finally:
            self.busy_ms = (time.perf_counter() - t0) * 1e3

    def wait(self) -> None:
        self._thread.join()
        if self._error is not None:
            raise self._error

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


def crc32_of(data) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def stored_crc_int(crc: int) -> int:
    """Convert a CRC32 value to the integer stored in the token stream.

    The reference memcpys gcrypt's MSB-first digest into a u32 on a
    little-endian machine and writes it LE (src/rzip.c:745,760), so the
    on-disk bytes are the digest MSB-first.  Reading those 4 bytes LE
    yields a byte-swapped value; this helper produces that value so both
    sides compare consistently.
    """
    return int.from_bytes(crc.to_bytes(4, "big"), "little")
