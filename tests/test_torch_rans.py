"""The port's rANS literal coder (lrzip_next_tpu_torch.ops.rans and
ops.rans_kernels) against the JAX package's ops.rans and ops.rans_pallas
on the CPU: K4 and K5's plain versions against the XLA twins and the
Pallas kernels in interpret mode, quantizing, and whole payloads against
rans.encode_block, each decoded by the native runtime.  The codec is
integer arithmetic, so every comparison is exact (tolerance 0)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrzip_next_tpu.ops import rans as jrans
from lrzip_next_tpu.ops import rans_pallas
from lrzip_next_tpu_torch import runtime
from lrzip_next_tpu_torch.ops import rans as R
from lrzip_next_tpu_torch.ops import rans_kernels as RK


def _block(rng, t: int, k: int, skew: bool = False) -> np.ndarray:
    """t*k lane-major bytes; ``skew`` draws few distinct symbols so that
    contexts and argmax ties matter."""
    hi = 24 if skew else 256
    return rng.integers(0, hi, t * k, dtype=np.uint8)


def _jax_planes(block: np.ndarray, t: int, k: int, ctx_bits: int):
    s8 = jnp.asarray(block.reshape(k, t).T)
    prev = jnp.concatenate([jnp.zeros((1, k), jnp.uint8), s8[:-1]], axis=0)
    ctxq = (prev >> (8 - ctx_bits)) if ctx_bits else jnp.zeros_like(prev)
    return s8, ctxq


def _zipf(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.2
    return rng.choice(256, n, p=p / p.sum()).astype(np.uint8)


@pytest.mark.parametrize("n", [0, 1, 131_071, 131_072, 2_097_151,
                               2_097_152, 4_194_305, 40_000_000])
def test_plan_matches_jax(n):
    k = R.pick_lanes(n)
    assert k == jrans.pick_lanes(n)
    assert R._bucket(n, k) == jrans._bucket(n, k)
    k2, t_len, srate = R.plan(n)
    assert k2 == k and k * t_len == R._bucket(n, k)
    assert srate == max(1, (t_len * k) // jrans._SAMPLE_TARGET)


@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
@pytest.mark.parametrize("t,k,srate,cut", [(64, 256, 4, 333), (13, 2048, 2, 5),
                                           (7, 64, 1, 0)])
def test_k4_plain_equals_jax(ctx_bits, t, k, srate, cut):
    rng = np.random.default_rng(ctx_bits * 1000 + t + k)
    block = _block(rng, t, k, skew=ctx_bits == 8)
    n = t * k - cut
    got = RK.joint_histogram(torch.from_numpy(block), n, ctx_bits, srate, k)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (1 << ctx_bits, 256)
    s8, ctxq = _jax_planes(block, t, k, ctx_bits)
    ref = jrans.joint_histogram(s8, ctxq, jnp.int32(n), ctx_bits, srate)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    pal = rans_pallas.joint_histogram_pallas(s8, jnp.int32(n), ctx_bits,
                                             srate, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(pal))


def _counts_cases():
    rng = np.random.default_rng(17)
    ties = np.zeros((4, 256), np.int32)
    ties[0, [3, 9, 200]] = 50           # three-way tie
    ties[1, [0, 255]] = 7               # tie at both ends
    ties[2] = 1                         # all tied
    ties[3, 5] = 1                      # single symbol
    big = 1 << 18
    edge = np.zeros((4, 256), np.int32)
    edge[0, :4] = [big // 4] * 4        # total exactly 2^18: no shift
    edge[1, :4] = [big // 4] * 3 + [big // 4 + 1]   # 2^18 + 1: shifted
    edge[2] = rng.integers(0, 1 << 14, 256)          # ~2^21 total
    edge[3, 17] = 1 << 22                            # one huge count
    zero = np.zeros((1, 256), np.int32)              # empty context
    rand = rng.integers(0, 1000, (64, 256)).astype(np.int32)
    return {"ties": ties, "edge": edge, "zero": zero, "rand": rand}


@pytest.mark.parametrize("case", ["ties", "edge", "zero", "rand"])
def test_quantize_freqs_equals_jax(case):
    counts = _counts_cases()[case]
    got = R.quantize_freqs(torch.from_numpy(counts))
    ref = np.asarray(jrans.quantize_freqs(jnp.asarray(counts)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    assert (got.sum(-1) == R.M).all() and (got >= 1).all()


@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
@pytest.mark.parametrize("t,cut", [(13, 777), (7, 0)])
def test_k5_plain_equals_jax(ctx_bits, t, cut):
    rng = np.random.default_rng(ctx_bits * 100 + t)
    k = 2048
    n = t * k - cut
    block = _block(rng, t, k, skew=True)
    s8, ctxq = _jax_planes(block, t, k, ctx_bits)
    counts = jrans.joint_histogram(s8, ctxq, jnp.int32(n), ctx_bits, 1)
    freqs = jrans.quantize_freqs(counts)
    states, plane = RK.encode_scan(torch.from_numpy(block), n,
                                   torch.from_numpy(np.array(freqs)),
                                   ctx_bits, k)
    assert states.dtype == torch.int32 and plane.dtype == torch.int32
    assert tuple(plane.shape) == (t, k)
    st_x, w_x, f_x = jrans._encode_scan(s8, ctxq, jnp.int32(n), freqs,
                                        ctx_bits)
    assert np.array_equal(states.numpy().view(np.uint32), np.asarray(st_x))
    assert np.array_equal(plane.numpy() & 0xFFFF, np.asarray(w_x))
    assert np.array_equal((plane.numpy() >> 16) == 1, np.asarray(f_x))
    st_p, plane_p = rans_pallas.encode_scan_fused(
        s8, jnp.int32(n), freqs, ctx_bits, interpret=True)
    assert np.array_equal(states.numpy().view(np.uint32), np.asarray(st_p))
    assert np.array_equal(plane.numpy(), np.asarray(plane_p))


def test_k5_rejects_bad_table():
    lit = torch.zeros(128, dtype=torch.uint8)
    with pytest.raises(TypeError):
        RK.encode_scan(lit, 128, torch.ones((4, 256), dtype=torch.int32),
                       6, 64)
    with pytest.raises(ValueError):
        RK.encode_scan(lit, 128, torch.ones((64, 256), dtype=torch.int32),
                       6, 100)


def _payload_roundtrip(data: np.ndarray, ctx_bits: int) -> bytes:
    ours = R.encode_block(data, ctx_bits, device="cpu")
    assert ours == jrans.encode_block(data, ctx_bits)
    assert runtime.rans_decode(ours, len(data)) == data.tobytes()
    return ours


@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
def test_encode_block_equals_jax_few_lanes(ctx_bits):
    data = _zipf(300_001, ctx_bits)
    ours = _payload_roundtrip(data, ctx_bits)
    assert ours[2] == R.pick_lanes(len(data)).bit_length() - 1 < 11


@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
def test_encode_block_equals_jax_2048_lanes(ctx_bits):
    """K = 2048, the JAX package's Pallas threshold (rans.py:390)."""
    data = _zipf((2 << 20) + 12_345, 50 + ctx_bits)
    ours = _payload_roundtrip(data, ctx_bits)
    assert ours[2] == 11
    assert len(ours) < len(data)


def test_encode_block_empty_and_tiny():
    assert R.encode_block(b"", device="cpu") == jrans.encode_block(b"")
    _payload_roundtrip(np.frombuffer(b"a", np.uint8), 6)
    _payload_roundtrip(np.frombuffer(b"abracadabra" * 9, np.uint8), 8)


def test_block_codec_defaults_to_the_card():
    """``encode_block`` and ``decode_block`` run on the card unless the
    caller asks for the CPU, as the port's other entry points do: where
    there is no card they raise rather than run on the CPU."""
    for fn in (R.encode_block, R.decode_block):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    data = _zipf(5_000, 3)
    payload = R.encode_block(data, 6, device="cpu")
    for fn, arg in ((R.encode_block, data), (R.decode_block, payload)):
        with pytest.raises((AssertionError, RuntimeError),
                           match="CUDA|cuda"):
            fn(arg)
