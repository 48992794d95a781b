"""gzip backend: zlib-format streams, same as the reference's compress2()
calls (src/stream.c:384-427 encode, gzip_decompress_buf decode)."""

from __future__ import annotations

import zlib
from typing import Optional

from ..format.constants import CTYPE_GZIP
from . import BackendConfig, register


def compress(data: bytes, cfg: BackendConfig) -> Optional[bytes]:
    level = min(max(cfg.compression_level, 1), 9)
    return zlib.compress(data, level)


def decompress(payload: bytes, u_len: int, cfg: BackendConfig) -> bytes:
    return zlib.decompress(payload, bufsize=max(u_len, 64))


register("gzip", CTYPE_GZIP, compress, decompress)
