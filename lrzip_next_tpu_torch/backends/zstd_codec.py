"""zstd backend: standard zstd frames via ZSTD_compress-equivalent calls
(reference src/stream.c:167-230 encode, 563-600 decode).  Level comes from
the lrzip-next->zstd level map (src/main.c:87-104); the recorded strategy
byte is informational in the reference too (plain ZSTD_compress is used).

The optional ``zstandard`` package is imported where it is used; without
it both directions raise ``ValueError``.
"""

from __future__ import annotations

from typing import Optional

from ..format.constants import CTYPE_ZSTD
from . import BackendConfig, register


def _zstandard():
    try:
        import zstandard
    except ImportError:
        raise ValueError("zstd backend needs the zstandard package")
    return zstandard


def compress(data: bytes, cfg: BackendConfig) -> Optional[bytes]:
    zstandard = _zstandard()
    level = cfg.zstd_level or 3
    try:
        return zstandard.ZstdCompressor(level=level,
                                        write_content_size=True,
                                        write_checksum=False).compress(data)
    except zstandard.ZstdError:
        return None


def decompress(payload: bytes, u_len: int, cfg: BackendConfig) -> bytes:
    return _zstandard().ZstdDecompressor().decompress(payload,
                                                   max_output_size=u_len)


register("zstd", CTYPE_ZSTD, compress, decompress)
