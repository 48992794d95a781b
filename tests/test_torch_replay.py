"""The port's device token replay (lrzip_next_tpu_torch.ops.replay_ragged,
ops.replay and models.device_path.replay_device) against the JAX package
on the CPU: the same piece plans and token streams, made from a seed with
numpy, go through the Pallas kernels in interpret mode (as
``tests/test_replay_ragged.py`` runs them) and through the port, whose
wrappers run their plain versions on CPU tensors.  Bytes are compared
exactly (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lrzip_next_tpu as lrz
import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu import runtime as jruntime
from lrzip_next_tpu.models import device_path as jdp
from lrzip_next_tpu.ops import rans as jrans
from lrzip_next_tpu.ops import replay as jreplay
from lrzip_next_tpu.ops import replay_ragged as jrr
from lrzip_next_tpu_torch import runtime as pruntime
from lrzip_next_tpu_torch.models import device_path as DP
from lrzip_next_tpu_torch.models import pipeline as PP
from lrzip_next_tpu_torch.ops import replay as PR
from lrzip_next_tpu_torch.ops import replay_ragged as RR

CPU = torch.device("cpu")


def _random_plan(rng, out_len, lit_len, mode):
    """Random piece plan covering [0, out_len) from a lit_len plane."""
    lens = []
    left = out_len
    while left > 0:
        if mode == "tiny":
            n = int(rng.integers(1, 8))
        elif mode == "big":
            n = int(rng.integers(2000, 30000))
        else:
            r = rng.random()
            if r < 0.3:
                n = int(rng.integers(1, 16))
            elif r < 0.8:
                n = int(rng.integers(16, 1500))
            else:
                n = int(rng.integers(1500, 20000))
        n = min(n, left)
        lens.append(n)
        left -= n
    lens = np.asarray(lens, np.int64)
    srcs = np.asarray([rng.integers(0, lit_len - n + 1) for n in lens],
                      np.int64)
    return lens, srcs


def _port_ragged(lens, srcs, lit, out_len):
    out = RR.replay_pieces_ragged(lens, srcs, torch.from_numpy(lit), out_len)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (out_len,)
    return out.numpy()


@pytest.mark.parametrize("mode", ["mixed", "tiny", "big"])
@pytest.mark.parametrize("out_len", [1, 777, RR.CELL, RR.CELL + 1, 40_000])
def test_ragged_equals_pallas_interpret(mode, out_len):
    rng = np.random.default_rng(out_len * 31 + len(mode))
    lit_len = max(out_len + 1000, 2000)
    lit = rng.integers(0, 256, size=lit_len, dtype=np.uint8)
    lens, srcs = _random_plan(rng, out_len, lit_len, mode)
    got = _port_ragged(lens, srcs, lit, out_len)
    want = np.asarray(jrr.replay_pieces_ragged(lens, srcs, jnp.asarray(lit),
                                               out_len, interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(
        got, jrr.replay_pieces_reference(lens, srcs, lit, out_len))


def test_ragged_every_misalignment():
    rng = np.random.default_rng(11)
    lit = rng.integers(0, 256, size=40_000, dtype=np.uint8)
    offs = [0, 1, 3, 127, 128, 1023, 511]
    lens = np.asarray([1024 + i * 7 for i in range(len(offs))], np.int64)
    srcs = np.asarray([so + 2048 * i for i, so in enumerate(offs)], np.int64)
    out_len = int(lens.sum())
    got = _port_ragged(lens, srcs, lit, out_len)
    want = np.asarray(jrr.replay_pieces_ragged(lens, srcs, jnp.asarray(lit),
                                               out_len, interpret=True))
    assert np.array_equal(got, want)


def test_ragged_counts_launches_only_on_the_card():
    before = (RR.ragged_launches, RR.small_launches, RR.layered_launches)
    rng = np.random.default_rng(2)
    lit = rng.integers(0, 256, size=25_000, dtype=np.uint8)
    lens, srcs = _random_plan(rng, 9000, 25_000, "mixed")
    _port_ragged(lens, srcs, lit, 9000)
    assert (RR.ragged_launches, RR.small_launches,
            RR.layered_launches) == before


def test_merge_contiguous_equals_jax():
    lens = np.array([5, 7, 3, 10, 1], np.int64)
    lits = np.array([0, 5, 40, 43, 53], np.int64)
    for got, want in zip(RR.merge_contiguous(lens, lits),
                         jrr.merge_contiguous(lens, lits)):
        assert got.tolist() == want.tolist()
    assert RR.merge_contiguous(lens, lits)[0].tolist() == [12, 14]


def test_ragged_rejects_sources_outside_the_plane():
    lit = np.zeros(100, np.uint8)
    for lens, srcs in (([50, 60], [0, 50]), ([10], [-1])):
        args = (np.asarray(lens, np.int64), np.asarray(srcs, np.int64))
        with pytest.raises(ValueError, match="literal stream length"):
            RR.replay_pieces_ragged(*args, torch.from_numpy(lit),
                                    int(sum(lens)))
        with pytest.raises(ValueError, match="literal stream length"):
            jrr.replay_pieces_ragged(*args, jnp.asarray(lit), int(sum(lens)),
                                     interpret=True)


def _table(rows):
    return torch.tensor(rows, dtype=torch.int64).reshape(3, -1)


def test_plain_versions_never_leave_their_tensors():
    """A table with sources or destinations outside the tensors: K8a reads
    0 there, K8b and K8c skip the piece."""
    lit = torch.arange(1, 101, dtype=torch.uint8)
    pieces = _table([[0, 10, 30], [95, -3, 5], [10, 6, 4]])
    out = RR.ragged_concat(lit, pieces, 1)
    assert out.shape[0] == RR.CELL
    assert out[:10].tolist() == [96, 97, 98, 99, 100, 0, 0, 0, 0, 0]
    assert out[10:16].tolist() == [0, 0, 0, 1, 2, 3]
    assert out[30:34].tolist() == [6, 7, 8, 9] and int(out[34:].sum()) == 0
    buf = torch.zeros(64, dtype=torch.uint8)
    bad = _table([[60, 0, 8], [0, 98, 90], [8, 4, 4]])
    RR.small_merge(buf, lit, bad)
    assert buf[8:12].tolist() == [91, 92, 93, 94]
    assert int(buf.sum()) == 91 + 92 + 93 + 94
    buf2 = torch.arange(64, dtype=torch.uint8)
    RR.layered_pass(buf2, _table([[32, 60], [0, 0], [8, 8]]))
    assert buf2[32:40].tolist() == list(range(8))
    assert buf2[40:].tolist() == list(range(40, 64))


@pytest.mark.parametrize("what", ["bytes", "table", "ranges", "device"])
def test_wrappers_reject_wrong_tensors(what):
    lit = torch.zeros(16, dtype=torch.uint8)
    pieces = _table([[0], [0], [4]])
    if what == "bytes":
        lit = lit.to(torch.int32)
    elif what == "table":
        pieces = pieces.to(torch.int32)
    elif what == "ranges":
        # two pieces whose byte ranges overlap: K8a and K8b search their
        # tables and refuse it; K8c takes any order
        pieces = _table([[0, 2], [8, 8], [4, 4]])
    else:
        pieces = pieces.to("meta")
    err = {"device": ValueError, "ranges": ValueError}.get(what, TypeError)
    with pytest.raises(err):
        RR.ragged_concat(lit, pieces, 1)
    with pytest.raises(err):
        RR.layered_pass(lit, pieces)
    if what == "ranges":
        with pytest.raises(ValueError):
            RR.ragged_concat(lit, _table([[0], [0], [4]]), 0)
    else:
        with pytest.raises(err):
            RR.small_merge(torch.zeros(16, dtype=torch.uint8), lit, pieces)


# ---------------------------------------------------------------------------
# token streams


def _apply(tokens, lit):
    """Sequential replay of (kind, len, dist) tokens: the decoded bytes."""
    out = bytearray()
    lp = 0
    for kind, n, dist in tokens:
        if kind == 0:
            out += lit[lp:lp + n].tobytes()
            lp += n
        else:
            for _ in range(n):
                out.append(out[-dist])
    return np.frombuffer(bytes(out), np.uint8), lp


def _fragmented_then_copied(rng):
    """Short literal and match alternations, one long match over all of it,
    and a short match into the copied region."""
    tokens, pos = [], 0
    for _ in range(300):
        n = 40 + int(rng.integers(0, 60))
        tokens.append((0, n, 0))
        pos += n
        if pos > 600:
            ml = 32 + int(rng.integers(0, 64))
            tokens.append((1, ml, int(rng.integers(ml, min(pos - 1, 4000)))))
            pos += ml
    tokens.append((1, pos, pos))
    tokens.append((1, 500, 700))
    return tokens


_STREAMS = {
    "fragmented_then_copied": _fragmented_then_copied,
    "rle_chunks_stack_layers": lambda rng: [
        (0, 2000, 0), (1, 1500, 900), (0, 1000, 0), (1, 6000, 2500)],
    "copy_of_a_copy": lambda rng: _fragmented_then_copied(rng) + [
        (0, 100, 0), (1, 30_000, 30_100), (1, 20_000, 45_000)],
    "literals_only": lambda rng: [(0, 70_000, 0), (0, 65_535, 0)],
    "few_long_matches": lambda rng: [
        (0, 20_000, 0), (1, 15_000, 18_000), (0, 3, 0), (1, 9000, 30_000)],
}


def _stream(name):
    rng = np.random.default_rng(len(name))
    tokens = _STREAMS[name](rng)
    lit = rng.integers(0, 256, sum(t[1] for t in tokens if t[0] == 0),
                       dtype=np.uint8)
    data, used = _apply(tokens, lit)
    assert used == len(lit)
    cols = [np.asarray(c) for c in zip(*tokens)]
    return (cols[0].astype(np.uint8), cols[1].astype(np.int64),
            cols[2].astype(np.int64), lit, data)


@pytest.mark.parametrize("name", list(_STREAMS))
def test_layered_equals_pallas_interpret(name):
    kinds, lens, dists, lit, data = _stream(name)
    lay = pruntime.flatten_replay_layered(kinds, lens, dists)
    want_lay = jruntime.flatten_replay_layered(kinds, lens, dists)
    assert lay is not None and want_lay is not None
    for a, b in zip(lay[:3], want_lay[:3]):
        assert np.array_equal(a, b)
    assert lay[3] == want_lay[3]
    pl_, ps_, py_, nl = lay
    if name in ("fragmented_then_copied", "copy_of_a_copy"):
        assert nl >= 1
    got = RR.replay_pieces_layered(pl_, ps_, py_, nl, torch.from_numpy(lit),
                                   len(data)).numpy()
    want = np.asarray(jrr.replay_pieces_layered(
        pl_, ps_, py_, nl, jnp.asarray(lit), len(data), interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(got, data)


def _planes(lit):
    """The same literals as a JAX and a port literal plane."""
    payload = jrans.encode_block(lit.tobytes(), 6)
    return (jdp.DeviceLitPlane(payload, len(lit)),
            DP.DeviceLitPlane(payload, len(lit), CPU), payload)


@pytest.mark.parametrize("name", list(_STREAMS))
def test_replay_device_equals_jax(name):
    kinds, lens, dists, lit, data = _stream(name)
    jplane, pplane, _ = _planes(lit)
    want = jdp.replay_device(kinds, lens, dists, jplane)
    got = DP.replay_device(kinds, lens, dists, pplane, CPU)
    assert got == want == data.tobytes()
    arr = DP.replay_tokens_device_array(kinds, lens, dists, pplane.plane)
    assert arr.dtype == torch.uint8 and arr.numpy().tobytes() == got


def test_replay_device_empty_chunk():
    none = np.zeros(0, np.int64)
    jplane, pplane, _ = _planes(np.zeros(0, np.uint8))
    assert DP.replay_device(none.astype(np.uint8), none, none, pplane,
                            CPU) == b""
    assert jdp.replay_device(none.astype(np.uint8), none, none,
                             jplane) == b""


def test_replay_device_cross_chunk_reach_is_none_in_both():
    kinds = np.array([0, 1], np.uint8)
    lens = np.array([100, 50], np.int64)
    dists = np.array([0, 101], np.int64)
    lit = np.arange(100, dtype=np.uint8)
    jplane, pplane, _ = _planes(lit)
    assert jdp.replay_device(kinds, lens, dists, jplane) is None
    assert DP.replay_device(kinds, lens, dists, pplane, CPU) is None
    assert DP.replay_tokens_device_array(kinds, lens, dists,
                                         pplane.plane) is None


def test_replay_device_literal_length_mismatch_raises_in_both():
    kinds, lens, dists, lit, _ = _stream("few_long_matches")
    jplane, pplane, _ = _planes(lit[:-1])
    with pytest.raises(ValueError, match="literal stream length mismatch"):
        jdp.replay_device(kinds, lens, dists, jplane)
    with pytest.raises(ValueError, match="literal stream length mismatch"):
        DP.replay_device(kinds, lens, dists, pplane, CPU)
    with pytest.raises(ValueError, match="literal stream length mismatch"):
        DP.replay_tokens_device_array(kinds, lens, dists,
                                      torch.zeros(10, dtype=torch.uint8))


def test_replay_device_corrupt_literals_raise_in_both():
    kinds, lens, dists, lit, _ = _stream("few_long_matches")
    _, _, payload = _planes(lit)
    bad = bytearray(payload)
    bad[-40] ^= 0x10
    with pytest.raises(ValueError, match="final state"):
        jdp.replay_device(kinds, lens, dists,
                          jdp.DeviceLitPlane(bytes(bad), len(lit)))
    with pytest.raises(ValueError, match="final state"):
        DP.replay_device(kinds, lens, dists,
                         DP.DeviceLitPlane(bytes(bad), len(lit), CPU), CPU)


@pytest.mark.parametrize("run", [30_000, 200_000])
def test_byte_rle_takes_pointer_doubling(run):
    """A match far longer than its distance: no piece plan, so the port
    resolves it by pointer doubling, as the JAX package does."""
    kinds = np.array([0, 1, 0, 1], np.uint8)
    lens = np.array([3, run, 5, 40], np.int64)
    dists = np.array([0, 1, 0, 7], np.int64)
    lit = np.array([9, 8, 7, 1, 2, 3, 4, 5], np.uint8)
    assert pruntime.flatten_replay_layered(kinds, lens, dists) is None
    assert pruntime.flatten_replay(kinds, lens, dists) is None
    want = jreplay.replay_tokens_tpu(kinds, lens, dists, lit)
    got = DP.replay_tokens_device_array(kinds, lens, dists,
                                        torch.from_numpy(lit)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, pruntime.replay_tokens(
        kinds, lens, dists, lit, int(lens.sum())))


def test_expand_tokens_equals_jax():
    kinds, lens, dists, lit, data = _stream("rle_chunks_stack_layers")
    is_match = kinds == 1
    lit_lens = np.where(is_match, 0, lens)
    lit_base = np.cumsum(lit_lens) - lit_lens
    starts = np.cumsum(lens) - lens
    src, lit_idx = PR.expand_tokens(
        torch.from_numpy(lens), torch.from_numpy(is_match),
        torch.from_numpy(dists), torch.from_numpy(lit_base))
    jsrc, jidx = jreplay.expand_tokens(
        jnp.asarray(starts.astype(np.int32)), jnp.asarray(is_match),
        jnp.asarray(dists.astype(np.int32)),
        jnp.asarray(lit_base.astype(np.int32)), len(data))
    assert np.array_equal(src.numpy(), np.asarray(jsrc))
    assert np.array_equal(lit_idx.numpy(), np.asarray(jidx))
    out = PR.resolve_bytes(src, lit_idx, torch.from_numpy(lit))
    assert np.array_equal(out.numpy(), data)
    assert np.array_equal(out.numpy(), np.asarray(jreplay.resolve_bytes(
        jsrc, jidx, jnp.asarray(lit))))


# ---------------------------------------------------------------------------
# through the entry point


def _zipf(n, seed):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.2
    return rng.choice(256, n, p=p / p.sum()).astype(np.uint8).tobytes()


def _count_calls(monkeypatch):
    calls = {"device": 0, "none": 0}
    real = PP.replay_device

    def counted(*args):
        out = real(*args)
        calls["device"] += 1
        calls["none"] += out is None
        return out

    monkeypatch.setattr(PP, "replay_device", counted)
    return calls


def test_decompress_replays_rans_chunks_on_the_device(monkeypatch):
    base = _zipf(200_000, 3)
    data = base + base[:90_000] + base[50_000:150_000]
    js = lrz.Settings(method="rans", use_tpu=True, use_mesh=False)
    archive = lrzt.compress(data, lrzt.settings_from_reference(js),
                            device="cpu")
    assert archive == lrz.compress(data, js)
    calls = _count_calls(monkeypatch)
    assert lrzt.decompress(archive, device="cpu") == data
    assert calls == {"device": 1, "none": 0}
    assert lrz.decompress(archive, lrz.Settings(use_tpu=True)) == data


def test_decompress_other_codecs_replay_on_the_host(monkeypatch):
    base = _zipf(120_000, 4)
    data = base + base[:60_000]
    archive = lrzt.compress(data, lrzt.Settings(method="gzip"), device="cpu")
    calls = _count_calls(monkeypatch)
    assert lrzt.decompress(archive, device="cpu") == data
    assert calls == {"device": 0, "none": 0}


def test_decompress_cross_chunk_reach_takes_the_host_branch(monkeypatch):
    """Three chunks whose later ones copy from the first: the device
    replay declines (None) and the host path, which holds the history,
    finishes the chunk; the JAX package decodes the same archive."""
    base = _zipf(150_000, 5)
    data = base + base + base
    js = lrz.Settings(method="rans", use_tpu=True, use_mesh=False,
                      max_chunk=150_000, cross_chunk=True)
    archive = lrz.compress(data, js)
    calls = _count_calls(monkeypatch)
    assert lrzt.decompress(archive, device="cpu") == data
    assert lrz.decompress(archive, lrz.Settings(use_tpu=True)) == data
    assert calls["device"] >= 1
