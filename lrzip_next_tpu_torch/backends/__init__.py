"""Backend block codecs.

Registry mapping method names / CTYPE codes to encode+decode callables.
The reference dispatches the same way in src/stream.c:1633-1650 (encode)
and src/stream.c:1897-1998 (decode).  Like the reference - which links
system libz/libbz2/libzstd rather than vendoring them - the gzip, bzip2
and zstd paths bind proven host codecs; lzo, zpaq, bzip3 and lzma are
from-scratch native implementations (runtime/csrc/), with liblzma as the
lzma fallback when the native runtime is unavailable.

Every compressor obeys the reference's incompressible-block contract:
return ``None`` when the compressed form would be >= the input, leaving
the block stored as CTYPE_NONE (src/stream.c:217-222 etc.).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from ..format import constants as C

Compressor = Callable[[bytes, "BackendConfig"], Optional[bytes]]
Decompressor = Callable[[bytes, int, "BackendConfig"], bytes]


class BackendConfig:
    """Codec parameters (subset of the reference's rzip_control)."""

    def __init__(self, compression_level: int = 7, dict_size: int = 0,
                 zpaq_level: int = 0, zpaq_bs: int = 0, bzip3_bs: int = 0,
                 zstd_level: int = 0, zstd_strategy: int = 0,
                 threads: int = 1, bemt: bool = True, lzma_mf: int = 0):
        self.compression_level = compression_level
        self.dict_size = dict_size
        self.zpaq_level = zpaq_level
        self.zpaq_bs = zpaq_bs
        self.bzip3_bs = bzip3_bs
        self.zstd_level = zstd_level
        self.zstd_strategy = zstd_strategy
        self.threads = threads
        self.bemt = bemt  # backend-internal MT (--nobemt disables)
        self.lzma_mf = lzma_mf  # 0 = bt4 default, 2..5 = bt2..bt5
        # (--lzma-mf; SDK MatchFinder_CreateVTable numHashBytes dial)


_COMPRESSORS: Dict[int, Compressor] = {}
_DECOMPRESSORS: Dict[int, Decompressor] = {}
_NAME_TO_CTYPE: Dict[str, int] = {}


def register(name: str, ctype: int, comp: Optional[Compressor],
             decomp: Optional[Decompressor]) -> None:
    _NAME_TO_CTYPE[name] = ctype
    if comp is not None:
        _COMPRESSORS[ctype] = comp
    if decomp is not None:
        _DECOMPRESSORS[ctype] = decomp


def compress_block(data: bytes, ctype: int, cfg: BackendConfig
                   ) -> Tuple[int, bytes]:
    """Compress one block; falls back to CTYPE_NONE when incompressible.

    Blocks under 64 bytes are never compressed (reference
    src/stream.c:1633 guard).
    """
    if ctype == C.CTYPE_NONE or len(data) < 64:
        return C.CTYPE_NONE, data
    comp = _COMPRESSORS.get(ctype)
    if comp is None:
        raise NotImplementedError(
            f"no compressor for {C.CTYPE_NAMES.get(ctype, ctype)}")
    out = comp(data, cfg)
    if out is None or len(out) >= len(data):
        return C.CTYPE_NONE, data
    return ctype, out


def decompress_block(payload: bytes, ctype: int, u_len: int,
                     cfg: BackendConfig) -> bytes:
    if ctype == C.CTYPE_NONE:
        return payload
    decomp = _DECOMPRESSORS.get(ctype)
    if decomp is None:
        raise NotImplementedError(
            f"no decompressor for {C.CTYPE_NAMES.get(ctype, ctype)}")
    try:
        out = decomp(payload, u_len, cfg)
    except ValueError:
        raise
    except NotImplementedError:
        raise
    except Exception as e:
        # corrupt payloads must surface as ValueError at the public API,
        # whatever the host codec raises (zstd/lzma/zlib error classes)
        raise ValueError(
            f"corrupt {C.CTYPE_NAMES.get(ctype, ctype)} block: {e}"
        ) from e
    if len(out) != u_len:
        raise ValueError(
            f"decompressed length {len(out)} != header u_len {u_len}")
    return out


def ctype_for_method(name: str) -> int:
    return _NAME_TO_CTYPE[name]


def available_methods() -> Dict[str, bool]:
    """Which methods have both encode and decode available."""
    return {
        name: ct in _COMPRESSORS and ct in _DECOMPRESSORS
        for name, ct in _NAME_TO_CTYPE.items()
    }


# Populate the registry.
from . import gzip_codec  # noqa: E402,F401
from . import bzip2_codec  # noqa: E402,F401
from . import lzma_codec  # noqa: E402,F401
from . import zstd_codec  # noqa: E402,F401
from . import lzo_codec  # noqa: E402,F401
from . import zpaq_codec  # noqa: E402,F401
from . import bzip3_codec  # noqa: E402,F401
from . import rans_codec  # noqa: E402,F401

_NAME_TO_CTYPE.setdefault("none", C.CTYPE_NONE)
