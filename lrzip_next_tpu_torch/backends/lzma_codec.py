"""lzma backend: raw LZMA1 block streams.

The reference calls LzmaCompress/LzmaUncompress (src/stream.c:429-494,
744-781) producing raw LZMA1 data with lc=3 lp=0 pb=2 and a dictionary
size recorded in magic byte 18; no props or size header is stored in the
block itself.

Decode uses our from-scratch native decoder (runtime/csrc/lzma.cpp, the
analog of the SDK's LzmaDec.c + the ASM decoder the reference ships) -
it stops after u_len bytes so marker-less reference streams decode fine.
Encode is native at every level (runtime/csrc/lzma.cpp): levels 1-4 use
the hash-chain + lazy parse (the SDK's algo=0 fast class:
LzmaEncProps_Normalize picks fast below level 5), levels 5-9 the BT4
binary-tree finder + price-table optimal parse (the SDK's GetOptimum
class, within ~0.1% of liblzma BT4 output size).  liblzma remains the
fallback only when the native runtime is unavailable (no compiler).
Our encoder appends an end-of-payload marker (allowed - the reference
decodes with LZMA_FINISH_ANY and a known output size).
"""

from __future__ import annotations

import lzma
from typing import Optional

from ..format.constants import CTYPE_LZMA, LZMA_LC, LZMA_LP, LZMA_PB
from . import BackendConfig, register

_MIN_DICT = 1 << 12
_MAX_DICT = 1 << 30  # liblzma encoder limit is 1.5 GiB; cap at 1 GiB


def _dict_size(cfg: BackendConfig, data_len: int) -> int:
    d = cfg.dict_size or (1 << 24)
    d = max(_MIN_DICT, min(d, _MAX_DICT))
    return d


def _filters(cfg: BackendConfig, data_len: int, for_decode: bool = False):
    base = {
        "id": lzma.FILTER_LZMA1,
        "dict_size": _dict_size(cfg, data_len),
        "lc": LZMA_LC,
        "lp": LZMA_LP,
        "pb": LZMA_PB,
    }
    if not for_decode:
        level = min(max(cfg.compression_level, 1), 9)
        base["mode"] = lzma.MODE_NORMAL if level >= 3 else lzma.MODE_FAST
        base["nice_len"] = 32 if level < 7 else 64  # fb mapping, stream.c:455
        base["mf"] = lzma.MF_BT4 if level >= 5 else lzma.MF_HC4
        base["depth"] = 0
    return [base]


def compress(data: bytes, cfg: BackendConfig) -> Optional[bytes]:
    level = min(max(cfg.compression_level, 1), 9)
    from .. import runtime
    if runtime.available():
        # bemt: pipelined match finder on a second thread (the
        # reference's LzFindMt numThreads=2, src/stream.c:456)
        return runtime.lzma1_encode(
            data, level=level, dict_size=_dict_size(cfg, len(data)),
            lc=LZMA_LC, lp=LZMA_LP, pb=LZMA_PB,
            threads=2 if cfg.bemt else 1,
            mf=getattr(cfg, "lzma_mf", 0))
    comp = lzma.LZMACompressor(format=lzma.FORMAT_RAW,
                               filters=_filters(cfg, len(data)))
    return comp.compress(data) + comp.flush()


def decompress(payload: bytes, u_len: int, cfg: BackendConfig) -> bytes:
    from .. import runtime
    if runtime.available():
        out = runtime.lzma1_decode(payload, u_len, lc=LZMA_LC,
                                   lp=LZMA_LP, pb=LZMA_PB)
        if out is not None:
            return out
    dec = lzma.LZMADecompressor(format=lzma.FORMAT_RAW,
                                filters=_filters(cfg, u_len, for_decode=True))
    out = dec.decompress(payload, max_length=u_len)
    if len(out) < u_len and not dec.eof:
        out += dec.decompress(b"", max_length=u_len - len(out))
    return out


register("lzma", CTYPE_LZMA, compress, decompress)
