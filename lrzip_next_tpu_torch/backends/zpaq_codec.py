"""zpaq backend (CTYPE 8): from-scratch ZPAQ codec in the native runtime.

The reference vendors libzpaq 7.15 (src/lib/libzpaq/); our equivalent
(runtime/csrc/zpaq.cpp) implements the public-domain ZPAQ spec: decode
runs the ZPAQL VM on any conforming archive (embedded LZ77/BWT/E8E9
postprocessors included), encode emits streams readable by any
conforming decoder - the reference's zpaq_decompress
(libzpaq.h:1624-1634) included.

Level semantics mirror libzpaq's speed dial (method strings built at
reference src/stream.c:304-309, libzpaq.cpp:7545-7731):
  1   LZ77 tokens stored raw + our own ZPAQL PCOMP inverse (~300 MB/s)
  2   LZ77 tokens under an order-1/2 ICM/ISSE model (~35 MB/s)
  3   deeper LZ77 search + order-1/2/3 model (~25 MB/s, near-CM ratio)
  4-5 direct context-mixing "mid" chain, growing model sizes (~1 MB/s)
"""

from __future__ import annotations

from typing import Optional

from ..format.constants import CTYPE_ZPAQ
from . import BackendConfig, register


def _redundancy(data: bytes) -> int:
    """Measured redundancy 0 (hard) .. 255 (easy), the reference's
    `256 - compressibility*2.55` mapping over the lz4 pre-test
    (src/stream.c:302-309; clamped at 25 like the reference).

    The reference's lz4_compresses tests progressively growing
    prefixes of the whole buffer (src/stream.c:2346-2370); sampling
    only the head would mis-type chunks whose first MB is
    unrepresentative (e.g. a binary header before text), so sample up
    to four 256KB windows spread across the block instead."""
    from ..ops.lz4gate import lz4_compress_bound_pct, entropy_estimate_pct
    win = 256 << 10
    if len(data) <= 4 * win:
        sample = data
    else:
        step = (len(data) - win) // 3
        sample = b"".join(data[i * step: i * step + win] for i in range(4))
    pct = lz4_compress_bound_pct(sample)
    if pct is None:
        pct = entropy_estimate_pct(sample)
    r = int(256 - pct * 2.55)
    return max(25, min(255, r))


def compress(data: bytes, cfg: BackendConfig) -> Optional[bytes]:
    from .. import runtime
    if not runtime.available():
        raise NotImplementedError(
            "zpaq backend needs the native runtime (g++ not available)")
    level = min(max(cfg.zpaq_level or 4, 1), 5)
    bs = min(max(cfg.zpaq_bs or 6, 1), 11)
    return runtime.zpaq_encode(data, level, bs,
                               redundancy=_redundancy(data),
                               threads=2 if cfg.bemt else 1)


def decompress(payload: bytes, u_len: int, cfg: BackendConfig) -> bytes:
    from .. import runtime
    if not runtime.available():
        raise NotImplementedError(
            "zpaq backend needs the native runtime (g++ not available)")
    out = runtime.zpaq_decode(payload, u_len,
                              threads=2 if cfg.bemt else 1)
    return out


register("zpaq", CTYPE_ZPAQ, compress, decompress)
