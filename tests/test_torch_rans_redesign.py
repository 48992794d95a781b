"""The arithmetic of the redesigned rANS kernels, K5 (encode) and K7
(decode), pinned down on the CPU against the JAX package.

- K5 divides by a multiply with a reciprocal: its plain version
  (``rans_kernels.divide_by_reciprocal``) equals ``//`` and ``%`` for every
  frequency f in [1, 4096] over the range the encode step can see
  (x < f * 2^20), and the plain encode scan that divides so equals the JAX
  package's Pallas encode kernel (interpret mode).
- K7 spreads its lanes over a cluster of C CTAs: ``_cluster_decode``
  emulates the card kernel's index arithmetic (CTA ranges, the prefixes
  inside a warp and over the warp totals, each CTA's base ``ptr + totals
  of the lower ranks``, lane order inside a thread, its 8-step table
  search) and is held against
  the JAX package's XLA decode scan and its Pallas decode kernel (interpret
  mode) for C in {1, 2, 4, 8, 16} at K = 16384.

The codec is integer arithmetic, so every comparison is exact (tolerance
0)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrzip_next_tpu.ops import rans as jrans
from lrzip_next_tpu.ops import rans_pallas
from lrzip_next_tpu.ops.rans_decode_pallas import decode_scan_fused
from lrzip_next_tpu_torch.ops import rans_kernels as RK

from test_torch_rans import _jax_planes
from test_torch_rans_decode import _encode, _xla_scan, _zipf

_U32 = 0xFFFFFFFF


# --- K5: the reciprocal division --------------------------------------------

_F_RANGES = [(lo, lo + 256) for lo in range(1, 4097, 256)]


@pytest.mark.parametrize("f_lo,f_hi", _F_RANGES)
def test_reciprocal_division_equals_floor_division(f_lo, f_hi):
    """x = 0, f - 1, f, multiples of f and their neighbours, the top of
    the range f * 2^20 - 1, and seeded random x, for every f in range."""
    rcp = RK.reciprocals("cpu")
    assert rcp.dtype == torch.int32 and tuple(rcp.shape) == (4096, 2)
    f = torch.arange(f_lo, f_hi, dtype=torch.int64)[:, None]
    top = f << 20
    mults = torch.tensor([1, 2, 3, 7, 255, 4096, 65_535, (1 << 20) - 1],
                         dtype=torch.int64)
    edges = torch.cat([torch.zeros_like(f), f - 1, f,
                       (f * mults - 1), f * mults, (f * mults + 1), top - 1],
                      1)
    rng = np.random.default_rng(f_lo)
    rand = torch.from_numpy(rng.random((f.shape[0], 512))) * top.double()
    x = torch.cat([edges, rand.to(torch.int64)], 1)
    x = torch.minimum(x.clamp(min=0), top - 1)
    fb = f.expand_as(x)
    q, r = RK.divide_by_reciprocal(x, fb, rcp)
    assert torch.equal(q, x // fb)
    assert torch.equal(r, x % fb)


def test_reciprocal_table_holds_ceil_of_2_to_the_64_over_f():
    rcp = RK.reciprocals("cpu").numpy().view(np.uint32).astype(object)
    for f in (1, 2, 3, 4095, 4096):
        want = -(-(1 << 64) // f)
        assert int(rcp[f - 1, 0]) == want & _U32
        assert int(rcp[f - 1, 1]) == (want >> 32) - 1


@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
def test_k5_plain_with_reciprocal_equals_pallas_interpret(ctx_bits):
    """T = 21 (not a multiple of 16), a partial last lane and whole lanes
    of padding; few symbols, so that large frequencies (f near 4096, the
    top of the division's range) occur."""
    t, k = 21, 256
    n = t * k - 1000
    rng = np.random.default_rng(40 + ctx_bits)
    block = np.where(rng.random(t * k) < 0.9, 7,
                     _zipf(t * k, 40 + ctx_bits, hi=6)).astype(np.uint8)
    s8, ctxq = _jax_planes(block, t, k, ctx_bits)
    freqs = jrans.quantize_freqs(
        jrans.joint_histogram(s8, ctxq, jnp.int32(n), ctx_bits, 1))
    assert int(np.asarray(freqs).max()) > 2048
    states, plane = RK.encode_scan(torch.from_numpy(block), n,
                                   torch.from_numpy(np.array(freqs)),
                                   ctx_bits, k)
    st_p, plane_p = rans_pallas.encode_scan_fused(
        s8, jnp.int32(n), freqs, ctx_bits, interpret=True)
    assert np.array_equal(states.numpy().view(np.uint32), np.asarray(st_p))
    assert np.array_equal(plane.numpy(), np.asarray(plane_p))


# --- K7: the cluster's offset arithmetic ------------------------------------


def _layout(k: int, ctas: int):
    """(threads a CTA, lanes a thread) as ``lrzt_rans_decode`` lays K
    lanes over ``ctas`` CTAs: at most 1024 threads a CTA."""
    threads = min(k // ctas, 1024)
    return threads, k // ctas // threads


def _cluster_decode(words: np.ndarray, states: np.ndarray,
                    freqs: np.ndarray, n: int, ctx_bits: int, t_len: int,
                    ctas: int):
    """K7 as ``csrc/rans_decode.cu`` computes it on a cluster of ``ctas``
    CTAs, step by step in numpy: (the (K*T,) uint8 block, final states)."""
    k = states.shape[0]
    threads, lanes = _layout(k, ctas)
    assert ctas * threads * lanes == k and threads % 32 == 0
    warps = threads // 32
    cum = RK.cum_table(torch.from_numpy(np.array(freqs))).numpy().astype(
        np.int64)
    cum &= 0xFFFF
    nw = words.shape[0]
    w = words.astype(np.int64) & 0xFFFF
    lane = np.arange(k)
    full_lanes, part_t = n // t_len, n % t_len
    x = states.astype(np.int64) & _U32
    prev = np.zeros(k, np.int64)          # the top byte of the lane's pack
    out = np.zeros((k, t_len), np.uint8)
    ptr = 0
    for t in range(t_len):
        real = (lane < full_lanes) | ((lane == full_lanes) & (t < part_t))
        row = cum[(prev >> (8 - ctx_bits)) if ctx_bits else 0 * prev]
        slot = x & 4095
        s = np.zeros(k, np.int64)
        for step in (128, 64, 32, 16, 8, 4, 2, 1):
            s += np.where(row[lane, s + step] <= slot, step, 0)
        c = row[lane, s]
        f = row[lane, s + 1] - c
        x2 = (f * (x >> 12) + slot - c) & _U32
        takes = real & (x2 < (1 << 16))
        # thread counts; warp scan; scan of the warp totals in each CTA
        tk = takes.reshape(ctas, warps, 32, lanes).astype(np.int64)
        count = tk.sum(-1)
        incl = np.cumsum(count, -1)
        wtot = incl[..., 31]
        before = np.cumsum(wtot, -1) - wtot
        cta_total = wtot.sum(-1)
        # the cluster: the totals of the lower ranks, read after the barrier
        lower = np.cumsum(cta_total) - cta_total
        at = (ptr + lower[:, None, None] + before[..., None]
              + (incl - count))[..., None] + np.cumsum(tk, -1) - tk
        at = at.reshape(k)
        word = np.where(at < nw, w[np.minimum(at, max(nw - 1, 0))]
                        if nw else 0, 0)
        x = np.where(real, np.where(takes, ((x2 << 16) | word) & _U32, x2),
                     x)
        sym = np.where(real, s, 0)
        prev = sym
        out[:, t] = sym
        ptr += int(cta_total.sum())
    return out.reshape(-1), x.astype(np.uint32)


_K, _T = 16384, 4


@functools.lru_cache(maxsize=None)
def _stream(ctx_bits: int, fault: str = ""):
    """The JAX package's encode of a 16384-lane block (a partial last lane,
    whole lanes of padding), and the XLA scan's and the Pallas kernel's
    decodes of it (or of its damaged stream)."""
    n = _T * _K - 5001
    block = _zipf(_T * _K, 90 + ctx_bits, hi=64)
    block[n:] = 0
    freqs, states, stream = _encode(block, n, _T, _K, ctx_bits)
    if fault == "flipped_word":
        stream = stream.copy()
        stream[_K // 3] ^= 0x0100
    xla = _xla_scan(freqs, states, stream, n, ctx_bits, _T)
    padded = np.concatenate(
        [stream, np.zeros(_T * _K + _K - stream.shape[0], np.int32)])
    syms, pxf = decode_scan_fused(
        jnp.asarray(padded), jnp.asarray(states), jnp.asarray(freqs),
        jnp.int32(n), ctx_bits, _T, interpret=True)
    pallas = (np.asarray(syms).T.reshape(-1), np.asarray(pxf))
    return block, n, freqs, states, stream, xla, pallas


@pytest.mark.parametrize("ctas", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("ctx_bits", [0, 6, 8])
def test_k7_cluster_offsets_equal_jax(ctx_bits, ctas):
    block, n, freqs, states, stream, xla, pallas = _stream(ctx_bits)
    plane, xf = _cluster_decode(stream, states, freqs, n, ctx_bits, _T,
                                ctas)
    for ref_plane, ref_xf in (xla, pallas):
        assert np.array_equal(plane, ref_plane)
        assert np.array_equal(xf, ref_xf)
    assert np.array_equal(plane[:n], block[:n])
    assert (xf == 1 << 16).all()
    # and the port's plain version agrees with the emulation
    got, gxf = RK.decode_scan(
        torch.from_numpy(stream.astype(np.uint16).view(np.int16)),
        torch.from_numpy(states.astype(np.uint32).view(np.int32)),
        torch.from_numpy(freqs.astype(np.int32)), n, ctx_bits, _T)
    assert np.array_equal(got.numpy(), plane)
    assert np.array_equal(gxf.numpy().view(np.uint32), xf)


@pytest.mark.parametrize("ctas", [1, 2, 4, 8, 16])
def test_k7_cluster_offsets_equal_jax_on_a_flipped_word(ctas):
    """A damaged stream decodes to the same wrong symbols and final states
    as in the JAX package, whatever the cluster size."""
    _, n, freqs, states, stream, xla, pallas = _stream(6, "flipped_word")
    plane, xf = _cluster_decode(stream, states, freqs, n, 6, _T, ctas)
    for ref_plane, ref_xf in (xla, pallas):
        assert np.array_equal(plane, ref_plane)
        assert np.array_equal(xf, ref_xf)
    assert (xf != 1 << 16).any()
