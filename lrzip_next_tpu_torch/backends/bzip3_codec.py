"""bzip3 backend slot (CTYPE 9): from-scratch BWT-family block codec.

The reference links an external libbz3 (bz3_new/bz3_encode_block calls
at src/stream.c:231-274, ABI shim at :620-625) with block sizes set by
--bzip3bs (prop coding src/include/lrzip_private.h:248-256, honored
here).  **Compatibility note:** no libbz3 source or test vectors exist
in this build environment, so this backend is a from-scratch codec of
the same family (block sorting + MTF + zero-run coding + adaptive range
coder, runtime/csrc/bwt.cpp) that fills the bzip3 method slot with the
same knobs and strength class.  Archives it writes round-trip through
this framework; they are tagged with a payload magic so foreign libbz3
payloads are detected and rejected with a clear error instead of
producing garbage.

Framing inside each stream block: [b"B3T2"][u32 n_sub] then per
sub-block [u32 c_len][u32 u_len][payload]; sub-blocks are the 2^bs-ish
bzip3 block size from the magic header, each independently coded (the
reference's bzip3 also concatenates independent bz3 blocks).  B3T2 uses
the structured symbol coder (runtime bwt_block_encode2); B3T1 archives
(the flat 9-bit tree generation) still decode.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..format.constants import CTYPE_BZIP3, bzip3_block_size_from_prop
from . import BackendConfig, register

_MAGIC_V1 = b"B3T1"
_MAGIC = b"B3T2"


def compress(data: bytes, cfg: BackendConfig) -> Optional[bytes]:
    from .. import runtime
    if not runtime.available():
        raise RuntimeError(
            "bzip3 backend requires the native runtime (g++ build "
            "failed); choose another method")
    if len(data) == 0:
        return None
    bs = bzip3_block_size_from_prop(cfg.bzip3_bs or 0)
    if cfg.bemt and len(data) > (4 << 20):
        # backend MT (--nobemt disables): split large blocks four ways
        # (2MB floor, requested size stays the ceiling) so the pool
        # below runs the SA-IS fronts in parallel - the backend-MT
        # analog of libbz3's block threading.  The framing is
        # self-describing, so decode is unchanged; --nobemt restores
        # exact single-block coding at the requested block size.
        bs = min(bs, max(2 << 20, -(-len(data) // 4)))
    subs = [data[i:i + bs] for i in range(0, len(data), bs)]
    if len(subs) > 1:
        with ThreadPoolExecutor(max_workers=min(len(subs), 4)) as pool:
            encs = list(pool.map(runtime.bwt_block_encode2, subs))
    else:
        encs = [runtime.bwt_block_encode2(subs[0])]
    out = bytearray(_MAGIC)
    out += struct.pack("<I", len(subs))
    for sub, enc in zip(subs, encs):
        if enc is None:  # expanded: store the sub-block raw
            out += struct.pack("<II", 0xFFFFFFFF, len(sub))
            out += sub
        else:
            out += struct.pack("<II", len(enc), len(sub))
            out += enc
    if len(out) >= len(data):
        return None  # incompressible: stream layer stores raw
    return bytes(out)


def decompress(payload: bytes, u_len: int, cfg: BackendConfig) -> bytes:
    from .. import runtime
    if payload[:4] == _MAGIC:
        decode_block = runtime.bwt_block_decode2
    elif payload[:4] == _MAGIC_V1:
        decode_block = runtime.bwt_block_decode
    else:
        raise ValueError(
            "bzip3 block is not in this framework's B3T1/B3T2 format - "
            "archives made with libbz3-linked lrzip-next are not "
            "decodable here (no libbz3 interop; see backends/"
            "bzip3_codec.py)")
    if not runtime.available():
        raise RuntimeError("bzip3 backend requires the native runtime")
    (n_sub,) = struct.unpack_from("<I", payload, 4)
    p = 8
    parts = []
    total = 0
    for _ in range(n_sub):
        c_len, sub_ulen = struct.unpack_from("<II", payload, p)
        p += 8
        if c_len == 0xFFFFFFFF:  # stored raw
            parts.append(payload[p:p + sub_ulen])
            p += sub_ulen
        else:
            parts.append(decode_block(payload[p:p + c_len], sub_ulen))
            p += c_len
        total += sub_ulen
    if total != u_len:
        raise ValueError(
            f"bzip3 block decoded {total} bytes, expected {u_len}")
    return b"".join(parts)


register("bzip3", CTYPE_BZIP3, compress, decompress)
