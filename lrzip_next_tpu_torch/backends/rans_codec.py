"""rans backend (CTYPE 11): the interleaved-rANS block codec.

A framework extension with no reference equivalent - the reference's
backends all entropy-code in serial native loops (dispatch roles at
src/stream.c:167-554).  This slot is the codec whose encode and decode
also run on the accelerator (ops/rans.py), giving the device-resident
literal path; this module is the host-side registry adapter over the
native C++ mirror (runtime/csrc/rans.cpp, bitstream-identical) for
host-path blocks.  Without the native runtime it raises, as the rest of
the package does.

Context-model depth follows the compression level: order-0 at level
1-2, 4-bit context at 3-4, 6-bit at 5-7, full order-1 at 8-9.
"""

from __future__ import annotations

from typing import Optional

from ..format.constants import CTYPE_RANS
from . import BackendConfig, register


_NO_RUNTIME = ("the rans backend needs the native host runtime "
               "(lrzip_next_tpu_torch.runtime, built with g++)")


def ctx_bits_for_level(level: int) -> int:
    if level <= 2:
        return 0
    if level <= 4:
        return 4
    if level <= 7:
        return 6
    return 8


def compress(data: bytes, cfg: BackendConfig) -> Optional[bytes]:
    from .. import runtime
    cb = ctx_bits_for_level(cfg.compression_level)
    if not runtime.available():
        raise RuntimeError(_NO_RUNTIME)
    out = runtime.rans_encode(data, cb)
    if out is None or len(out) >= len(data):
        return None
    return out


def decompress(payload: bytes, u_len: int, cfg: BackendConfig) -> bytes:
    from .. import runtime
    if not runtime.available():
        raise RuntimeError(_NO_RUNTIME)
    return runtime.rans_decode(payload, u_len)


register("rans", CTYPE_RANS, compress, decompress)
