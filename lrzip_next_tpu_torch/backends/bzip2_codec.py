"""bzip2 backend: BZ2_bzBuffToBuffCompress equivalent with
blockSize100k = compression level (reference src/stream.c:333-382)."""

from __future__ import annotations

import bz2
from typing import Optional

from ..format.constants import CTYPE_BZIP2
from . import BackendConfig, register


def compress(data: bytes, cfg: BackendConfig) -> Optional[bytes]:
    level = min(max(cfg.compression_level, 1), 9)
    return bz2.compress(data, level)


def decompress(payload: bytes, u_len: int, cfg: BackendConfig) -> bytes:
    return bz2.decompress(payload)


register("bzip2", CTYPE_BZIP2, compress, decompress)
