"""K3 and K6 of the port (lrzip_next_tpu_torch.ops.streampack) and the
literal mask, against the JAX package: the XLA twin rans._pack_words_xla
and the Pallas kernels pack_stream_pallas / pack_plane_pallas in
interpret mode.  All comparisons are exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrzip_next_tpu.models import device_path as jdp
from lrzip_next_tpu.ops import rans as jrans
from lrzip_next_tpu.ops.streampack import pack_plane_pallas, \
    pack_stream_pallas
from lrzip_next_tpu_torch.models import device_path as tdp
from lrzip_next_tpu_torch.ops import streampack as SP


def _flags(kind: str, m: int, rng) -> np.ndarray:
    if kind == "none":
        return np.zeros(m, bool)
    if kind == "all":
        return np.ones(m, bool)
    if kind == "last":
        return np.arange(m) == m - 1
    if kind == "runs":
        # literal-mask shape: long runs of set and unset flags
        edges = np.sort(rng.choice(m, size=min(40, m), replace=False))
        return (np.searchsorted(edges, np.arange(m), side="right") % 2) == 1
    return rng.random(m) < 0.3


@pytest.mark.parametrize("m", [1, 5_000, 131_077])
@pytest.mark.parametrize("kind", ["none", "all", "last", "runs", "sparse"])
def test_k3_plain_equals_jax(kind, m):
    rng = np.random.default_rng(m + len(kind))
    vals = rng.integers(0, 256, m, dtype=np.uint8)
    flags = _flags(kind, m, rng)
    cap = m + 77
    got, n = SP.pack_stream(torch.from_numpy(vals), torch.from_numpy(flags),
                            cap)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (cap,)
    assert n.dtype == torch.int32 and int(n) == int(flags.sum())
    ref, ref_n = jrans._pack_words_xla(jnp.asarray(vals), jnp.asarray(flags),
                                       cap)
    assert int(ref_n) == int(n)
    assert np.array_equal(got.numpy(), np.asarray(ref).astype(np.uint8))
    pal, pal_n = pack_stream_pallas(jnp.asarray(vals), jnp.asarray(flags),
                                    cap, interpret=True)
    assert int(pal_n) == int(n)
    assert np.array_equal(got.numpy(), np.asarray(pal).astype(np.uint8))


def test_k3_drops_past_cap_like_xla():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 256, 1000, dtype=np.uint8)
    flags = rng.random(1000) < 0.5
    got, n = SP.pack_stream(torch.from_numpy(vals), torch.from_numpy(flags),
                            100)
    ref, ref_n = jrans._pack_words_xla(jnp.asarray(vals), jnp.asarray(flags),
                                       100)
    assert int(n) == int(ref_n) == int(flags.sum())
    assert np.array_equal(got.numpy(), np.asarray(ref).astype(np.uint8))


@pytest.mark.parametrize("t,k", [(13, 2048), (1, 64), (40, 64)])
@pytest.mark.parametrize("kind", ["none", "all", "sparse"])
def test_k6_plain_equals_jax(kind, t, k):
    rng = np.random.default_rng(t * k + len(kind))
    words = rng.integers(0, 1 << 16, (t, k), dtype=np.int64)
    flags = _flags(kind, t * k, rng).reshape(t, k)
    plane = (np.where(flags, words, 0) | (flags.astype(np.int64) << 16)
             ).astype(np.int32)
    cap = t * k
    got, n = SP.pack_plane(torch.from_numpy(plane), cap)
    assert got.dtype == torch.int16 and tuple(got.shape) == (cap,)
    assert int(n) == int(flags.sum())
    ref, ref_n = jrans._pack_words_xla(
        jnp.asarray((plane & 0xFFFF).astype(np.int32)), jnp.asarray(flags),
        cap)
    assert int(ref_n) == int(n)
    assert np.array_equal(got.numpy().view(np.uint16), np.asarray(ref))
    pal, pal_n = pack_plane_pallas(jnp.asarray(plane), cap, interpret=True)
    assert int(pal_n) == int(n)
    assert np.array_equal(got.numpy().view(np.uint16), np.asarray(pal))


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        SP.pack_stream(torch.zeros(4, dtype=torch.int32),
                       torch.zeros(4, dtype=torch.bool), 4)
    with pytest.raises(TypeError):
        SP.pack_stream(torch.zeros(4, dtype=torch.uint8),
                       torch.zeros(5, dtype=torch.bool), 4)
    with pytest.raises(TypeError):
        SP.pack_plane(torch.zeros(4, dtype=torch.int64), 4)


def _tokens(n: int, rng):
    """A token sequence covering n bytes: alternating literal and match
    runs (the match distances do not matter to the mask)."""
    lengths, kinds = [], []
    left, kind = n, 0
    while left:
        ln = int(min(left, rng.integers(1, 3000)))
        lengths.append(ln)
        kinds.append(kind)
        left -= ln
        kind ^= 1
    return np.array(kinds, np.uint8), np.array(lengths, np.int64)


@pytest.mark.parametrize("n,npos", [(70_000, 131_072), (65_536, 65_536)])
def test_literal_mask_equals_jax(n, npos):
    rng = np.random.default_rng(n)
    kinds, lengths = _tokens(n, rng)
    ls, le, n_lit = tdp.literal_spans(kinds, lengths)
    jls, jle, jn = jdp.literal_spans(kinds, lengths)
    assert n_lit == jn and np.array_equal(ls, jls) and \
        np.array_equal(le, jle)
    mask = tdp.literal_mask(npos, ls, le, torch.device("cpu"))
    tb = jdp._token_bucket(len(ls))
    ls_p = np.full(tb, npos, np.int32)
    le_p = np.full(tb, npos, np.int32)
    ls_p[:len(ls)] = ls
    le_p[:len(le)] = le
    ref = jdp._literal_mask_fn(npos)(jnp.asarray(ls_p), jnp.asarray(le_p))
    assert np.array_equal(mask.numpy(), np.asarray(ref))
    assert int(mask.sum()) == n_lit


@pytest.mark.parametrize("ctx_bits", [0, 8])
def test_device_literal_encode_equals_jax(ctx_bits):
    """The slice's module: mask -> K3 -> rANS encode of one chunk gives
    the JAX DeviceLiteralEncode payload."""
    rng = np.random.default_rng(ctx_bits + 11)
    n, npos = 90_000, 131_072
    chunk = np.zeros(npos, np.uint8)
    chunk[:n] = rng.integers(0, 40, n, dtype=np.uint8)
    kinds, lengths = _tokens(n, rng)
    ours = tdp.DeviceLiteralEncode(torch.from_numpy(chunk), kinds, lengths,
                                   ctx_bits)
    ref = jdp.DeviceLiteralEncode(jnp.asarray(chunk), kinds, lengths,
                                  ctx_bits)
    assert ours.n_lit == ref.n_lit
    assert ours.payload() == ref.payload()


def test_device_literal_encode_no_literals():
    kinds = np.array([1], np.uint8)
    lengths = np.array([70_000], np.int64)
    enc = tdp.DeviceLiteralEncode(torch.zeros(131_072, dtype=torch.uint8),
                                  kinds, lengths, 6)
    assert enc.n_lit == 0 and enc.payload() is None
