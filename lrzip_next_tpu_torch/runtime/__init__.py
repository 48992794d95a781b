"""Native host runtime: C++ serial tails bound via ctypes.

Builds lazily with g++ on first use into the git-ignored build directory
of the checkout (``build/lrzip_next_tpu_torch/liblrzt_hostops.so``, the
directory ``ops/_build.py`` uses for the CUDA kernels), so the library
never lies next to the sources and never shares a file with another
package's build of the same sources.  The compiler writes to a name
unique to the process and the result is moved into place with
``os.replace``: concurrent builds each finish with a complete library.
The port requires the runtime on its paths (``ops/matcher.py`` raises
without it); the entry points still return None when it is absent.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "csrc", "hostops.cpp"),
         os.path.join(_HERE, "csrc", "zpaq.cpp"),
         os.path.join(_HERE, "csrc", "bwt.cpp"),
         os.path.join(_HERE, "csrc", "lzma.cpp"),
         os.path.join(_HERE, "csrc", "rans.cpp")]
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "lrzip_next_tpu_torch")
_SO = os.path.join(_BUILD_DIR, "liblrzt_hostops.so")

_lib = None
_lock = threading.Lock()
_build_failed = False
build_error = ""


def _build() -> None:
    """Compile the sources into ``_SO`` through a per-process temporary."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-std=c++17", "-pthread", *_SRCS, "-o", tmp, "-lz"],
            check=True, capture_output=True, timeout=240)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed, build_error
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.exists(_SO) or any(
                os.path.getmtime(_SO) < os.path.getmtime(s)
                for s in _SRCS):
            try:
                _build()
            except (subprocess.SubprocessError, OSError) as exc:
                _build_failed = True
                build_error = (getattr(exc, "stderr", b"") or b"").decode(
                    errors="replace")[-2000:] or repr(exc)
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as exc:
            _build_failed = True
            build_error = repr(exc)
            return None
        i64 = ctypes.c_int64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.greedy_cover.restype = i64
        lib.greedy_cover.argtypes = [i64p, i64p, i64p, i64, i64, i64,
                                     ctypes.c_void_p, u8p, i64p, i64p,
                                     i64, i64p]
        lib.finalize_tokens.restype = i64
        lib.finalize_tokens.argtypes = [i64p, i64p, i64p, i64, u8p,
                                        i64, i64, u8p, i64p, i64p, i64,
                                        i64p]
        lib.replay_tokens.restype = i64
        lib.replay_tokens.argtypes = [u8p, i64p, i64p, i64, u8p, i64,
                                      u8p, i64, u8p, i64]
        lib.flatten_replay.restype = i64
        lib.flatten_replay.argtypes = [u8p, i64p, i64p, i64, i64p, i64p,
                                       i64]
        lib.lzo1x_encode.restype = i64
        lib.lzo1x_encode.argtypes = [u8p, i64, u8p, i64, i32p]
        lib.lzo1x_decode.restype = i64
        lib.lzo1x_decode.argtypes = [u8p, i64, u8p, i64]
        lib.zpaq_encode.restype = i64
        lib.zpaq_encode.argtypes = [u8p, i64, u8p, i64, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_int]
        lib.flatten_replay_layered.restype = i64
        lib.flatten_replay_layered.argtypes = [
            u8p, i64p, i64p, i64, i64, i64, i64p, i64p, i32p, i64,
            i32p]
        lib.demote_fragmenting_matches.restype = i64
        lib.demote_fragmenting_matches.argtypes = [
            u8p, i64p, i64p, i64, i64, i64, u8p, i64p, i64p, i64p,
            i64p, i64]
        lib.parse_token_stream.restype = i64
        lib.parse_token_stream.argtypes = [u8p, i64, i64, u8p, i64p, i64p,
                                           ctypes.POINTER(ctypes.c_uint32),
                                           ctypes.POINTER(ctypes.c_int64)]
        lib.zpaq_decode.restype = i64
        lib.zpaq_decode.argtypes = [u8p, i64, u8p, i64, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_int]
        lib.bwt_block_encode.restype = i64
        lib.bwt_block_encode.argtypes = [u8p, i64, u8p, i64]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.rzip_encode_host.restype = i64
        lib.rzip_encode_host.argtypes = [u8p, i64, i64, ctypes.c_int,
                                         u32p, u8p, i64p, i64p, i64]
        lib.bwt_block_decode.restype = i64
        lib.bwt_block_decode.argtypes = [u8p, i64, u8p, i64]
        lib.bwt_block_encode2.restype = i64
        lib.bwt_block_encode2.argtypes = [u8p, i64, u8p, i64]
        lib.bwt_block_decode2.restype = i64
        lib.bwt_block_decode2.argtypes = [u8p, i64, u8p, i64]
        ci = ctypes.c_int
        lib.lzma1_encode.restype = i64
        lib.lzma1_encode.argtypes = [u8p, i64, u8p, i64, ci,
                                     ctypes.c_uint32, ci, ci, ci, ci,
                                     ci]
        lib.lzma1_decode.restype = i64
        lib.lzma1_decode.argtypes = [u8p, i64, u8p, i64, ci, ci, ci]
        lib.rans_encode.restype = i64
        lib.rans_encode.argtypes = [u8p, i64, ci, u8p, i64]
        lib.rans_decode.restype = i64
        lib.rans_decode.argtypes = [u8p, i64, u8p, i64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


# Thread-local token scratch: the worst-case cap (2*(n/min_match) +
# 2*nr tokens ~ 70MB of arrays per 64MB chunk) is allocated once per
# thread and reused - the walk usually emits a few thousand tokens, so
# per-call np.empty of the worst case was pure allocator churn.
_scratch = threading.local()


def _token_scratch(cap: int):
    cur = getattr(_scratch, "bufs", None)
    if cur is None or len(cur[0]) < cap:
        cur = (np.empty(cap, dtype=np.uint8),
               np.empty(cap, dtype=np.int64),
               np.empty(cap, dtype=np.int64))
        _scratch.bufs = cur
    return cur


def greedy_cover(run_start: np.ndarray, run_len: np.ndarray,
                 run_src: np.ndarray, n: int, min_match: int,
                 data: Optional[np.ndarray] = None,
                 hole_out: Optional[list] = None
                 ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Native frontier walk (csrc/hostops.cpp greedy_cover).  When
    ``hole_out`` is a list, appends the walk's hole-byte count
    (scanned-but-unmatched bytes inside certified spans - the signal
    the adaptive chain prune uses to refetch the full record set)."""
    lib = _load()
    if lib is None:
        return None
    nr = len(run_start)
    # emitted matches are disjoint >= min_match spans, so tokens are
    # bounded by 2*(n/min_match) + 2*nr + 4 even with gap resync
    cap = 2 * (n // max(min_match, 1)) + 2 * nr + 4
    run_start = np.ascontiguousarray(run_start, dtype=np.int64)
    run_len = np.ascontiguousarray(run_len, dtype=np.int64)
    run_src = np.ascontiguousarray(run_src, dtype=np.int64)
    ok, ol, od = _token_scratch(cap)
    dptr = None
    if data is not None:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        dptr = data.ctypes.data_as(ctypes.c_void_p)
    holes = np.zeros(1, dtype=np.int64)
    t = lib.greedy_cover(_i64p(run_start), _i64p(run_len), _i64p(run_src),
                         nr, n, min_match, dptr, _u8p(ok), _i64p(ol),
                         _i64p(od), cap, _i64p(holes))
    if t < 0:
        return None
    if hole_out is not None:
        hole_out.append(int(holes[0]))
    return ok[:t].copy(), ol[:t].copy(), od[:t].copy()


def finalize_tokens(starts: np.ndarray, lens: np.ndarray,
                    dists: np.ndarray, n: int, data: np.ndarray,
                    min_match: int,
                    hole_out: Optional[list] = None
                    ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                        np.ndarray]]:
    """Byte-verify + extend device-selected pieces into final rzip
    tokens (csrc/hostops.cpp finalize_tokens).  Pieces must be
    disjoint and sorted by start (the device selection's contract).
    ``hole_out`` receives the unverified-byte count inside selected
    spans - the walk-fallback trigger."""
    lib = _load()
    if lib is None:
        return None
    k = len(starts)
    cap = 2 * (n // max(min_match, 1)) + 2 * k + 4
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    dists = np.ascontiguousarray(dists, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    ok, ol, od = _token_scratch(cap)
    holes = np.zeros(1, dtype=np.int64)
    t = lib.finalize_tokens(_i64p(starts), _i64p(lens), _i64p(dists),
                            k, _u8p(data), n, min_match, _u8p(ok),
                            _i64p(ol), _i64p(od), cap, _i64p(holes))
    if t < 0:
        return None
    if hole_out is not None:
        hole_out.append(int(holes[0]))
    return ok[:t].copy(), ol[:t].copy(), od[:t].copy()


def replay_tokens(kinds: np.ndarray, lens: np.ndarray, dists: np.ndarray,
                  literals: np.ndarray, out_len: int,
                  history: Optional[np.ndarray] = None
                  ) -> Optional[np.ndarray]:
    """Native token replay.  ``history`` is a separate read-only prefix
    buffer (fd_hist analog) - pass a memmap of the written output file
    for zero-copy multi-chunk decode."""
    lib = _load()
    if lib is None:
        return None
    if history is None:
        history = np.zeros(0, dtype=np.uint8)
    history = np.ascontiguousarray(history, dtype=np.uint8)
    buf = np.empty(max(out_len, 1), dtype=np.uint8)
    kinds = np.ascontiguousarray(kinds, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    dists = np.ascontiguousarray(dists, dtype=np.int64)
    literals = np.ascontiguousarray(literals, dtype=np.uint8)
    ret = lib.replay_tokens(_u8p(kinds), _i64p(lens), _i64p(dists),
                            len(kinds), _u8p(literals), len(literals),
                            _u8p(history), len(history),
                            _u8p(buf), out_len)
    if ret < 0:
        raise ValueError("corrupt rzip token stream (native replay)")
    return buf[:ret]


def flatten_replay(kinds: np.ndarray, lens: np.ndarray,
                   dists: np.ndarray
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Resolve match chains at token granularity: (piece_lens,
    piece_lit_offsets) where every output byte sources directly from
    the literal stream.  None when the native runtime is unavailable,
    the plan explodes (byte-RLE chains), or a distance reaches before
    the chunk."""
    lib = _load()
    if lib is None:
        return None
    kinds = np.ascontiguousarray(kinds, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    dists = np.ascontiguousarray(dists, dtype=np.int64)
    cap = 6 * max(len(kinds), 1) + 1024
    out_len = np.empty(cap, dtype=np.int64)
    out_lit = np.empty(cap, dtype=np.int64)
    ret = lib.flatten_replay(_u8p(kinds), _i64p(lens), _i64p(dists),
                             len(kinds), _i64p(out_len), _i64p(out_lit),
                             cap)
    if ret < 0:
        return None
    return out_len[:ret].copy(), out_lit[:ret].copy()


def flatten_replay_layered(kinds: np.ndarray, lens: np.ndarray,
                           dists: np.ndarray, frag_num: int = 1,
                           frag_den: int = 4096):
    """Layered replay plan (csrc flatten_replay_layered): returns
    (piece_lens, piece_srcs, piece_layers, n_layers) where layer-0
    pieces source the literal plane and layer-k pieces copy output
    ranges completed by pass k-1.  None on fallback (runtime missing,
    cap overflow, or pathological layer depth)."""
    lib = _load()
    if lib is None:
        return None
    kinds = np.ascontiguousarray(kinds, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    dists = np.ascontiguousarray(dists, dtype=np.int64)
    n = len(kinds)
    total = int(lens.sum())
    # pieces are bounded by the per-match inline budgets (8 + len/den
    # each) plus literals; 6n + total/512 covers that with slack
    cap = 6 * n + total // 512 + 65536
    pl = np.empty(cap, dtype=np.int64)
    ps = np.empty(cap, dtype=np.int64)
    py = np.empty(cap, dtype=np.int32)
    nl = ctypes.c_int32(0)
    t = lib.flatten_replay_layered(
        _u8p(kinds), _i64p(lens), _i64p(dists), n, frag_num, frag_den,
        _i64p(pl), _i64p(ps), py.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)), cap, ctypes.byref(nl))
    if t < 0:
        return None
    return (pl[:t].copy(), ps[:t].copy(), py[:t].copy(), int(nl.value))


def demote_fragmenting(kinds: np.ndarray, lens: np.ndarray,
                       dists: np.ndarray, frag_num: int = 1,
                       frag_den: int = 512
                       ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]]:
    """Fragmentation-aware token rewrite (csrc demote_fragmenting_
    matches): matches whose decode-plan piece expansion exceeds
    1 + len*frag_num/frag_den pieces are demoted to literals, bounding
    the accelerator replay plan near-linearly in output size.  Returns
    the rewritten columns, or None (keep originals) when the runtime is
    unavailable or the piece scratch overflows."""
    lib = _load()
    if lib is None:
        return None
    n = len(kinds)
    if n == 0:
        return kinds, lens, dists
    kinds = np.ascontiguousarray(kinds, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    dists = np.ascontiguousarray(dists, dtype=np.int64)
    total = int(lens.sum())
    pcap = 2 * n + total // max(frag_den, 1) * max(frag_num, 1) + 4096
    ok = np.empty(n + 2, dtype=np.uint8)
    ol = np.empty(n + 2, dtype=np.int64)
    od = np.empty(n + 2, dtype=np.int64)
    pl = np.empty(pcap, dtype=np.int64)
    pi = np.empty(pcap, dtype=np.int64)
    t = lib.demote_fragmenting_matches(
        _u8p(kinds), _i64p(lens), _i64p(dists), n, frag_num, frag_den,
        _u8p(ok), _i64p(ol), _i64p(od), _i64p(pl), _i64p(pi), pcap)
    if t < 0:
        return None
    return ok[:t].copy(), ol[:t].copy(), od[:t].copy()


def lzo1x_encode(data: bytes) -> Optional[bytes]:
    lib = _load()
    if lib is None or len(data) < 16:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) + len(data) // 16 + 128
    out = np.empty(cap, dtype=np.uint8)
    work = np.empty(1 << 17, dtype=np.int32)
    ret = lib.lzo1x_encode(_u8p(src), len(data), _u8p(out), cap,
                           work.ctypes.data_as(
                               ctypes.POINTER(ctypes.c_int32)))
    if ret < 0:
        return None
    return out[:ret].tobytes()


def lzo1x_decode(payload: bytes, u_len: int) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(u_len, dtype=np.uint8)
    ret = lib.lzo1x_decode(_u8p(src), len(payload), _u8p(out), u_len)
    if ret < 0:
        raise ValueError("corrupt LZO block (native decode)")
    if ret != u_len:
        raise ValueError(f"LZO decoded {ret} bytes, expected {u_len}")
    return out.tobytes()


def zpaq_encode(data: bytes, level: int = 4, block_bits: int = 6,
                redundancy: int = -1, texttype: int = -1,
                threads: int = 1) -> Optional[bytes]:
    """redundancy: 0 (hard) .. 255 (easy) from the lz4 gate, -1 neutral;
    texttype: 1 text / 0 binary / -1 infer (reference stream.c:304-309);
    threads >= 2 splits into independent blocks coded in parallel (the
    backend-MT dial; --nobemt forces 1)."""
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) + len(data) // 8 + 4096
    out = np.empty(cap, dtype=np.uint8)
    err = ctypes.create_string_buffer(256)
    ret = lib.zpaq_encode(_u8p(src), len(data), _u8p(out), cap,
                          level, block_bits, redundancy, texttype,
                          err, 256, threads)
    if ret < 0:
        msg = err.value.decode("utf-8", "replace")
        if msg:
            raise ValueError(f"zpaq encode failed: {msg}")
        return None
    return out[:ret].tobytes()


def zpaq_decode(payload: bytes, u_len: int,
                threads: int = 1) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(max(u_len, 1), dtype=np.uint8)
    err = ctypes.create_string_buffer(256)
    ret = lib.zpaq_decode(_u8p(src), len(payload), _u8p(out), u_len,
                          err, 256, threads)
    if ret < 0:
        raise ValueError("corrupt zpaq block: "
                         + err.value.decode("utf-8", "replace"))
    return out[:ret].tobytes()


def rzip_encode_host(data: np.ndarray, min_match: int,
                     hash_bits: int = 0):
    """Native greedy rzip matcher (the host-CPU fast path).  Returns
    (kinds, lens, dists) or None when the runtime is unavailable."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    if not hash_bits:
        hash_bits = max(16, min(24, int(n).bit_length() - 2))
    table = np.zeros(1 << hash_bits, dtype=np.uint32)
    cap = n // 16 + 4
    kinds = np.empty(cap, dtype=np.uint8)
    lens = np.empty(cap, dtype=np.int64)
    dists = np.empty(cap, dtype=np.int64)
    t = lib.rzip_encode_host(
        _u8p(data), n, min_match, hash_bits,
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _u8p(kinds), _i64p(lens), _i64p(dists), cap)
    if t < 0:
        return None  # capacity overflow: caller falls back
    return kinds[:t].copy(), lens[:t].copy(), dists[:t].copy()


def lzma1_encode(data: bytes, level: int = 7, dict_size: int = 1 << 24,
                 lc: int = 3, lp: int = 0, pb: int = 2,
                 threads: int = 1, mf: int = 0) -> Optional[bytes]:
    """From-scratch raw LZMA1 encode (runtime/csrc/lzma.cpp).  Returns
    None when the runtime is unavailable or the stream expands.
    threads >= 2 pipelines the match finder on a worker thread (the
    LzFindMt analog; --nobemt forces 1).  mf 2..5 selects the bt2..bt5
    finder family (--lzma-mf, the SDK's numHashBytes dial); 0 = bt4."""
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) + len(data) // 4 + 4096
    out = np.empty(cap, dtype=np.uint8)
    ret = lib.lzma1_encode(_u8p(src), len(data), _u8p(out), cap, level,
                           dict_size, lc, lp, pb, threads, mf)
    if ret < 0:
        return None
    return out[:ret].tobytes()


def lzma1_decode(payload: bytes, u_len: int, lc: int = 3, lp: int = 0,
                 pb: int = 2) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(max(u_len, 1), dtype=np.uint8)
    ret = lib.lzma1_decode(_u8p(src), len(payload), _u8p(out), u_len,
                           lc, lp, pb)
    if ret != u_len:
        raise ValueError("corrupt LZMA1 block (native decode)")
    return out[:u_len].tobytes()


def bwt_block_encode(data: bytes) -> Optional[bytes]:
    """BWT-family block encode (backends/bzip3_codec.py).  Returns None
    when the runtime is unavailable or the block expands."""
    lib = _load()
    if lib is None or len(data) == 0:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) + len(data) // 8 + 256
    out = np.empty(cap, dtype=np.uint8)
    ret = lib.bwt_block_encode(_u8p(src), len(data), _u8p(out), cap)
    if ret < 0:
        return None
    return out[:ret].tobytes()


def bwt_block_decode(payload: bytes, u_len: int) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(max(u_len, 1), dtype=np.uint8)
    ret = lib.bwt_block_decode(_u8p(src), len(payload), _u8p(out), u_len)
    if ret != u_len:
        raise ValueError("corrupt BWT block (native decode)")
    return out[:u_len].tobytes()


def bwt_block_encode2(data: bytes) -> Optional[bytes]:
    """v2 coding (structured symbol coder, ~2.5x faster entropy stage);
    written as B3T2 payloads by backends/bzip3_codec.py."""
    lib = _load()
    if lib is None or len(data) == 0:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) + len(data) // 8 + 256
    out = np.empty(cap, dtype=np.uint8)
    ret = lib.bwt_block_encode2(_u8p(src), len(data), _u8p(out), cap)
    if ret < 0:
        return None
    return out[:ret].tobytes()


def bwt_block_decode2(payload: bytes, u_len: int) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(max(u_len, 1), dtype=np.uint8)
    ret = lib.bwt_block_decode2(_u8p(src), len(payload), _u8p(out),
                                u_len)
    if ret != u_len:
        raise ValueError("corrupt BWT block (native decode)")
    return out[:u_len].tobytes()


def parse_token_stream(stream0: np.ndarray, chunk_bytes: int):
    """Native token-stream parse; returns (kinds, lens, dists, crc,
    consumed) or None when the runtime is unavailable."""
    lib = _load()
    if lib is None:
        return None
    s = np.ascontiguousarray(stream0, dtype=np.uint8)
    cap = len(s) // 3 + 2
    kinds = np.empty(cap, dtype=np.uint8)
    lens = np.empty(cap, dtype=np.int64)
    dists = np.empty(cap, dtype=np.int64)
    crc = ctypes.c_uint32(0)
    consumed = ctypes.c_int64(0)
    t = lib.parse_token_stream(_u8p(s), len(s), chunk_bytes, _u8p(kinds),
                               _i64p(lens), _i64p(dists),
                               ctypes.byref(crc), ctypes.byref(consumed))
    if t < 0:
        raise ValueError("corrupt rzip token stream (native parse)")
    return (kinds[:t].copy(), lens[:t].copy(), dists[:t].copy(),
            int(crc.value), int(consumed.value))


def rans_encode(data: bytes, ctx_bits: int = 6) -> Optional[bytes]:
    """Native interleaved-rANS block encode (runtime/csrc/rans.cpp),
    bitstream-compatible with the device codec (ops/rans.py)."""
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) + len(data) // 4 + (1 << 17)
    out = np.empty(cap, dtype=np.uint8)
    ret = lib.rans_encode(_u8p(src), len(data), ctx_bits, _u8p(out), cap)
    if ret < 0:
        return None
    return out[:ret].tobytes()


def rans_decode(payload: bytes, u_len: int) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(max(u_len, 1), dtype=np.uint8)
    ret = lib.rans_decode(_u8p(src), len(payload), _u8p(out), u_len)
    if ret < 0:
        raise ValueError("corrupt rans block (native decode)")
    if ret != u_len:
        raise ValueError(f"rans decoded {ret} bytes, expected {u_len}")
    return out[:u_len].tobytes()
