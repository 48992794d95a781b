"""The port's rANS literal decode (lrzip_next_tpu_torch.ops.rans,
ops.rans_kernels and models.device_path.DeviceLitPlane) against the JAX
package on the CPU: K7's plain version against the XLA scan
``rans._decode_scan`` (the Pallas kernel in interpret mode is in
``test_torch_rans_decode_pallas.py``), whole payloads against
``rans.decode_block`` and the native runtime, and the ``ValueError`` of
every malformed payload.  The codec is integer
arithmetic, so every comparison is exact (tolerance 0)."""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrzip_next_tpu import runtime as jruntime
from lrzip_next_tpu.models import device_path as jdp
from lrzip_next_tpu.ops import rans as jrans
from lrzip_next_tpu_torch import runtime as pruntime
from lrzip_next_tpu_torch.models import device_path as DP
from lrzip_next_tpu_torch.ops import rans as R
from lrzip_next_tpu_torch.ops import rans_kernels as RK


def _zipf(n: int, seed: int, hi: int = 256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, hi + 1) ** 1.2
    return rng.choice(hi, n, p=p / p.sum()).astype(np.uint8)


def _encode(block: np.ndarray, n: int, t: int, k: int, ctx_bits: int):
    """The JAX package's encode of a lane-major (k*t,) block with a forced
    lane count: (freqs (C, 256) int32, states (K,) uint32, words (nw,)
    int32), all numpy."""
    s8 = jnp.asarray(block.reshape(k, t).T)
    prev = jnp.concatenate([jnp.zeros((1, k), jnp.uint8), s8[:-1]], axis=0)
    ctxq = (prev >> (8 - ctx_bits)) if ctx_bits else jnp.zeros_like(prev)
    counts = jrans.joint_histogram(s8, ctxq, jnp.int32(n), ctx_bits, 1)
    freqs = jrans.quantize_freqs(counts)
    states, words, flags = jrans._encode_scan(s8, ctxq, jnp.int32(n), freqs,
                                              ctx_bits)
    packed, n_words = jrans._pack_words_xla(words, flags, t * k)
    stream = np.asarray(packed)[:int(n_words)].astype(np.int32)
    return np.asarray(freqs), np.asarray(states), stream


def _port_scan(freqs, states, stream, n, ctx_bits, t):
    plane, xf = RK.decode_scan(
        torch.from_numpy(stream.astype(np.uint16).view(np.int16)),
        torch.from_numpy(states.astype(np.uint32).view(np.int32)),
        torch.from_numpy(freqs.astype(np.int32)), n, ctx_bits, t)
    assert plane.dtype == torch.uint8 and xf.dtype == torch.int32
    return plane.numpy(), xf.numpy().view(np.uint32)


def _xla_scan(freqs, states, stream, n, ctx_bits, t):
    k = states.shape[0]
    pad = max(t * k + k - stream.shape[0], 0)
    syms, xf = jrans._decode_scan(
        jnp.asarray(np.concatenate([stream, np.zeros(pad, np.int32)])),
        jnp.asarray(states), jnp.asarray(freqs), jnp.int32(n), ctx_bits, t)
    return np.asarray(syms).T.reshape(-1), np.asarray(xf)


# n as a function of (t, k): full, one short, a third, a single byte
_N_CASES = {"full": lambda t, k: t * k, "one_short": lambda t, k: t * k - 1,
            "third": lambda t, k: max(t * k // 3, 1), "one": lambda t, k: 1}


@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
@pytest.mark.parametrize("t,k", [(24, 64), (5, 256), (9, 2048)])
@pytest.mark.parametrize("n_case", list(_N_CASES))
def test_k7_plain_equals_xla_scan(ctx_bits, t, k, n_case):
    n = _N_CASES[n_case](t, k)
    block = _zipf(t * k, ctx_bits * 31 + t + k, hi=48)
    block[n:] = 0
    freqs, states, stream = _encode(block, n, t, k, ctx_bits)
    plane, xf = _port_scan(freqs, states, stream, n, ctx_bits, t)
    ref_plane, ref_xf = _xla_scan(freqs, states, stream, n, ctx_bits, t)
    assert np.array_equal(plane, ref_plane)
    assert np.array_equal(xf, ref_xf)
    assert np.array_equal(plane[:n], block[:n])
    assert (xf == 1 << 16).all()


@pytest.mark.parametrize("fault", ["flipped_word", "short_stream",
                                   "empty_stream", "long_stream"])
def test_k7_plain_equals_xla_scan_on_corrupt_streams(fault):
    """A damaged stream decodes to the same (wrong) symbols and final
    states in both packages, and words past the end read as zero."""
    t, k, ctx_bits = 12, 256, 6
    n = t * k - 7
    block = _zipf(t * k, 77, hi=40)
    block[n:] = 0
    freqs, states, stream = _encode(block, n, t, k, ctx_bits)
    assert stream.shape[0] > 8
    if fault == "flipped_word":
        stream = stream.copy()
        stream[3] ^= 0x0100
    elif fault == "short_stream":
        stream = stream[:stream.shape[0] // 2]
    elif fault == "empty_stream":
        stream = stream[:0]
    else:
        stream = np.concatenate([stream, np.full(t * k + 2 * k, 0x1234,
                                                 np.int32)])
    plane, xf = _port_scan(freqs, states, stream, n, ctx_bits, t)
    ref_plane, ref_xf = _xla_scan(freqs, states, stream, n, ctx_bits, t)
    assert np.array_equal(plane, ref_plane)
    assert np.array_equal(xf, ref_xf)
    if fault != "long_stream":
        assert (xf != 1 << 16).any()


def test_k7_wrapper_rejects_bad_arguments():
    words = torch.zeros(10, dtype=torch.int16)
    states = torch.full((64,), 1 << 16, dtype=torch.int32)
    freqs = torch.full((64, 256), 16, dtype=torch.int32)
    RK.decode_scan(words, states, freqs, 64, 6, 1)
    with pytest.raises(ValueError):
        RK.decode_scan(words, states, freqs, 64, 5, 1)
    with pytest.raises(TypeError):
        RK.decode_scan(words.to(torch.int32), states, freqs, 64, 6, 1)
    with pytest.raises(TypeError):
        RK.decode_scan(words, states.to(torch.int64), freqs, 64, 6, 1)
    with pytest.raises(TypeError):
        RK.decode_scan(words, states, freqs[:16], 64, 6, 1)
    with pytest.raises(ValueError):
        RK.decode_scan(words, states[:48], freqs, 48, 6, 1)
    with pytest.raises(ValueError):
        RK.decode_scan(words, states, freqs, 65, 6, 1)
    with pytest.raises(ValueError):
        RK.decode_scan(words[::2], states, freqs, 64, 6, 1)


def test_cum_table_is_the_exclusive_prefix():
    freqs = R.quantize_freqs(torch.from_numpy(
        np.random.default_rng(3).integers(0, 99, (16, 256)).astype(np.int32)))
    cum = RK.cum_table(freqs)
    assert cum.dtype == torch.int16 and tuple(cum.shape) == (16, 257)
    assert (cum[:, 0] == 0).all() and (cum[:, 256] == R.M).all()
    assert torch.equal((cum[:, 1:] - cum[:, :-1]).to(torch.int32), freqs)


# --- whole payloads ---------------------------------------------------------


def _payloads(data: np.ndarray, ctx_bits: int) -> dict:
    """The same block encoded by the JAX package, the port, and the
    native runtimes (the JAX package's where this process has it)."""
    out = {"jax": jrans.encode_block(data, ctx_bits),
           "port": R.encode_block(data, ctx_bits, device="cpu"),
           "port_runtime": pruntime.rans_encode(data.tobytes(), ctx_bits)}
    if jruntime.available():
        out["jax_runtime"] = jruntime.rans_encode(data.tobytes(), ctx_bits)
    assert all(v is not None for v in out.values())
    return out


@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
@pytest.mark.parametrize("n", [1, 333, 70_001])
def test_decode_block_equals_jax_and_runtime(ctx_bits, n):
    data = _zipf(n, ctx_bits * 7 + n)
    for name, payload in _payloads(data, ctx_bits).items():
        got = R.decode_block(payload, device="cpu")
        assert got == data.tobytes(), name
        assert got == jrans.decode_block(payload), name
        if jruntime.available():
            assert got == jruntime.rans_decode(payload, n), name
        assert got == pruntime.rans_decode(payload, n), name


def test_decode_block_2048_lanes():
    """Over 2 MiB: K = 2048 lanes, the JAX package's Pallas threshold."""
    data = _zipf((2 << 20) + 4321, 9, hi=32)
    payload = R.encode_block(data, 6, device="cpu")
    assert payload[2] == 11
    assert R.decode_block(payload, device="cpu") == data.tobytes()
    assert pruntime.rans_decode(payload, len(data)) == data.tobytes()


def test_decode_block_empty():
    empty = R.encode_block(b"", device="cpu")
    assert R.decode_block(empty, device="cpu") == \
        jrans.decode_block(empty) == b""
    plane = DP.DeviceLitPlane(empty, 0, "cpu")
    plane.check()
    assert plane.literals().shape == (0,)


def _good_payload():
    data = _zipf(50_000, 123, hi=50)
    return data, R.encode_block(data, 6, device="cpu")


def _repack(payload: bytes, **changes) -> bytes:
    names = ("magic", "ctx_bits", "klog", "pad", "n", "nw", "tlen", "t_len")
    hdr = dict(zip(names, R._HDR.unpack_from(payload, 0)))
    hdr.update(changes)
    return R._HDR.pack(*(hdr[k] for k in names)) + payload[R._HDR.size:]


def _bad_table(payload: bytes, how: str) -> bytes:
    """Replace the frequency table and fix the header's table length."""
    tlen = R._HDR.unpack_from(payload, 0)[6]
    off = R._HDR.size
    raw = bytearray(zlib.decompress(payload[off:off + tlen]))
    if how == "sum":        # first entry + 1: the row no longer sums to M
        raw[0] = (raw[0] + 1) & 0xFF
        blob = zlib.compress(bytes(raw))
    elif how == "size":
        blob = zlib.compress(bytes(raw[:-3]))
    else:                   # not a zlib stream
        blob = b"\x00" * tlen
    return _repack(payload[:off] + blob + payload[off + tlen:],
                   tlen=len(blob))


_MALFORMED = {
    "truncated_header": lambda p: p[:10],
    "bad_magic": lambda p: _repack(p, magic=9),
    "bad_ctx_bits": lambda p: _repack(p, ctx_bits=5),
    "bad_klog": lambda p: _repack(p, klog=15),
    "span_too_short": lambda p: _repack(p, t_len=1),
    "span_too_long": lambda p: _repack(p, t_len=(1 << 26) + 1),
    "table_sum": lambda p: _bad_table(p, "sum"),
    "table_size": lambda p: _bad_table(p, "size"),
    "table_not_zlib": lambda p: _bad_table(p, "zlib"),
    "truncated_states": lambda p: p[:R._HDR.size + R._HDR.unpack_from(
        p, 0)[6] + 40],
    "truncated_words": lambda p: p[:-2],
    "word_count_too_large": lambda p: _repack(
        p, nw=R._HDR.unpack_from(p, 0)[5] + 1),
    "word_count_cut_short": lambda p: _repack(
        p, nw=R._HDR.unpack_from(p, 0)[5] // 2),
    "flipped_word": lambda p: p[:-100] + bytes([p[-100] ^ 0x40]) + p[-99:],
    "flipped_state": lambda p: (
        p[:R._HDR.size + R._HDR.unpack_from(p, 0)[6] + 5]
        + bytes([p[R._HDR.size + R._HDR.unpack_from(p, 0)[6] + 5] ^ 1])
        + p[R._HDR.size + R._HDR.unpack_from(p, 0)[6] + 6:]),
}


def _message(fn, *args) -> str:
    with pytest.raises(ValueError) as err:
        fn(*args)
    return str(err.value)


@pytest.mark.parametrize("fault", list(_MALFORMED))
def test_decode_block_raises_as_jax(fault):
    data, payload = _good_payload()
    bad = _MALFORMED[fault](payload)
    assert _message(R.decode_block, bad, "cpu") == \
        _message(jrans.decode_block, bad)


def _plane_checked(cls, payload, u_len, *device):
    plane = cls(payload, u_len, *device)
    plane.check()
    return plane


@pytest.mark.parametrize("fault", list(_MALFORMED) + ["length_mismatch"])
def test_device_lit_plane_raises_as_jax(fault):
    """Each of DeviceLitPlane's seven checks, and check(), on the same
    corrupted payloads on which the JAX class raises, in the same words."""
    data, payload = _good_payload()
    u_len = len(data)
    if fault == "length_mismatch":
        bad, u_len = payload, u_len + 1
    else:
        bad = _MALFORMED[fault](payload)
    ours = _message(_plane_checked, DP.DeviceLitPlane, bad, u_len, "cpu")
    theirs = _message(_plane_checked, jdp.DeviceLitPlane, bad, u_len)
    assert ours == theirs


def test_device_lit_plane_messages_cover_every_check():
    """The faults above reach all seven messages of the constructor and
    the final-state message of check()."""
    data, payload = _good_payload()
    seen = set()
    for fault, make in _MALFORMED.items():
        seen.add(_message(_plane_checked, DP.DeviceLitPlane, make(payload),
                          len(data), "cpu").split(":")[0])
    seen.add(_message(DP.DeviceLitPlane, payload, len(data) + 1, "cpu"))
    assert seen >= {
        "rans payload truncated", "bad rans payload header",
        "rans payload length mismatch", "bad rans payload span length",
        "corrupt rans frequency table",
        "rans payload truncated (states)", "rans payload truncated (words)",
        "corrupt rans stream (final state check)"}


@pytest.mark.parametrize("change", [
    {"klog": 5}, {"klog": 0}, {"t_len": 1 << 20}, {"t_len": 1 << 26},
    {"klog": 14, "t_len": 1 << 26}, {"t_len": "one_more"}])
def test_header_cannot_size_the_plane(change):
    """A header's lane count and span length size the decoded plane, which
    the port allocates on the device: fewer than 64 lanes, or a span
    longer than the padded block's, is refused before any allocation."""
    data, payload = _good_payload()
    k, t_len, _ = R.plan(len(data))
    if change.get("t_len") == "one_more":
        change = {"t_len": t_len + 1}
    bad = _repack(payload, **change)
    for fn, args in ((R.parse_payload, (bad,)),
                     (R.decode_block, (bad, "cpu")),
                     (DP.DeviceLitPlane, (bad, len(data), "cpu"))):
        assert _message(fn, *args) == "bad rans payload span length"
    # the longest span an encoder writes, and the native encoder's tight
    # one, both pass
    assert R.parse_payload(_repack(payload, t_len=t_len))[3] == t_len
    native = pruntime.rans_encode(data.tobytes(), 6)
    assert R.parse_payload(native)[3] == -(-len(data) // k)
    assert R.decode_block(native, device="cpu") == data.tobytes()


@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
def test_device_lit_plane_equals_jax(ctx_bits):
    data = _zipf(90_000, ctx_bits + 40, hi=80)
    payload = jrans.encode_block(data, ctx_bits)
    ours = _plane_checked(DP.DeviceLitPlane, payload, len(data), "cpu")
    theirs = _plane_checked(jdp.DeviceLitPlane, payload, len(data))
    assert ours.n == theirs.n == len(data)
    assert np.array_equal(ours.literals(), np.asarray(theirs.plane)[:ours.n])
    assert ours.literals().tobytes() == data.tobytes()


def test_header_layout_is_the_jax_packages():
    assert R._HDR.format == jrans._HDR.format
    assert R._HDR.size == struct.calcsize("<BBBBQIII")
    assert (R.MAGIC, R.M, R.M_BITS) == (jrans.MAGIC, jrans.M, jrans.M_BITS)
    assert RK.L_INIT == int(jrans.L)
