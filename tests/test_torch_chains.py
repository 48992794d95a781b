"""The matcher's chain stage (lrzip_next_tpu_torch.ops.matcher
``compact_seeds_dual``: the (dist, pos) sort, K10 on the chain starts, K10
on the chain ends, the coarse chains) against the JAX package's
``compact_seeds_dual`` (XLA, CPU): fine and coarse records and both
counts, exactly equal.  Also the stage's calls (K10 twice, K2 never, no
segmented copy over the seed array), the K2/K10 wrappers on contiguous
slices that start at any byte, and ``MatchJob`` tokens at the strides
that ``tests/test_torch_matcher.py`` leaves out."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from lrzip_next_tpu.ops import matcher as M
from lrzip_next_tpu_torch.ops import compact as C
from lrzip_next_tpu_torch.ops import matcher as PM

CPU = torch.device("cpu")
STRIDES = [2, 4, 8, 16, 32]


def _repetitive(n: int, seed: int) -> np.ndarray:
    """Random bytes with far copies, a near copy, a zero run and an
    interrupted copy (8-byte holes every 9,000 bytes)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, n // 3, dtype=np.uint8)
    holed = base.copy()
    holed[1_000::9_000] ^= 0x5A
    parts = [base, base[:n // 6], np.zeros(n // 25, np.uint8), holed,
             rng.integers(0, 256, 700, dtype=np.uint8), base[-n // 9:]]
    return np.concatenate(parts)[:n]


def _padded(data: np.ndarray) -> np.ndarray:
    out = np.zeros(PM.bucket_size(len(data)), np.uint8)
    out[:len(data)] = data
    return out


def _assert_dual_equal(pos: np.ndarray, cand: np.ndarray, limit: int,
                       stride: int, gap_v: int, gap_w: int = PM._CHAIN_GAP):
    """The port's compact_seeds_dual on (pos, cand) against the JAX
    package's, uncapped.  Returns the port's (fine, coarse)."""
    k = len(pos)
    fine, n_raw, coarse, n_w = M.compact_seeds_dual(
        jnp.asarray(pos), jnp.asarray(cand), jnp.asarray(cand >= 0),
        jnp.int32(limit), k, stride, gap_v, gap_w)
    tfine, tcoarse = PM.compact_seeds_dual(
        torch.from_numpy(pos), torch.from_numpy(cand), limit, gap_v, gap_w)
    n_raw, n_w = int(n_raw), int(n_w)
    assert len(tfine[0]) == n_raw and len(tcoarse[0]) == n_w
    for port, ref, cnt in ((tfine, fine, n_raw), (tcoarse, coarse, n_w)):
        for p, r in zip(port, ref):
            assert p.dtype == torch.int32 and p.shape == (cnt,)
            assert np.array_equal(p.numpy(), np.asarray(r)[:cnt])
    return tfine, tcoarse


@pytest.fixture(scope="module")
def chunk():
    data = _repetitive(120_000, 3)
    return data, _padded(data)


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("gap", ["verify", "coarse"])
def test_compact_seeds_dual_matches_xla(chunk, stride, gap):
    data, padded = chunk
    gap_v = M._verify_gap(stride) if gap == "verify" else M._CHAIN_GAP
    pos, cand = PM.anchor_candidates_fporder(torch.from_numpy(padded),
                                             stride)
    fine, coarse = _assert_dual_equal(pos.numpy(), cand.numpy(),
                                      len(data) - 31, stride, gap_v)
    assert len(fine[0]) > 3 and len(coarse[0]) >= 1


def _seeds(kind: str):
    """Hand-made (pos, cand, limit) seed arrays in no particular order."""
    rng = np.random.default_rng(len(kind))
    k = 3_000
    pos = (np.arange(k, dtype=np.int32) * 8 + 5000)
    limit = int(pos[-1]) + 1
    if kind == "no_chain":
        cand = np.full(k, -1, np.int32)
    elif kind == "one_chain":
        cand = pos - 4_000
        cand[:700] = -1
    elif kind == "every_seed_a_start":
        cand = pos - (np.arange(k, dtype=np.int32) * 3 + 1)
    else:   # "chain_ends_on_the_last_seed": the largest dist, last seed
        cand = pos - rng.integers(1, 40, k).astype(np.int32)
        cand[2_000:] = pos[2_000:] - 4_500
        cand[2_400:2_402] = pos[2_400:2_402] - 5    # cuts it once
    perm = rng.permutation(k)
    return pos[perm], cand[perm], limit


@pytest.mark.parametrize("gap", ["verify", "coarse"])
@pytest.mark.parametrize("kind", ["no_chain", "one_chain",
                                  "every_seed_a_start",
                                  "chain_ends_on_the_last_seed"])
def test_compact_seeds_dual_edge_cases(kind, gap):
    pos, cand, limit = _seeds(kind)
    gap_v = M._verify_gap(8) if gap == "verify" else M._CHAIN_GAP
    fine, coarse = _assert_dual_equal(pos, cand, limit, 8, gap_v)
    n = len(fine[0])
    if kind == "no_chain":
        assert n == 0 and len(coarse[0]) == 0
    elif kind == "one_chain":
        assert n == 1 and len(coarse[0]) == 1
        assert (int(fine[0][0]), int(fine[1][0])) == (int(pos.min()) + 700
                                                      * 8, limit - 1)
    elif kind == "every_seed_a_start":
        assert n == len(pos)
        assert torch.equal(fine[0], fine[1])
    else:
        assert int(fine[1].max()) == limit - 1
        assert int(coarse[1].max()) == limit - 1


class _CumminLengths(TorchFunctionMode):
    """Records the length of every ``torch.cummin`` input."""

    def __init__(self):
        super().__init__()
        self.lengths = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.cummin:
            self.lengths.append(args[0].shape[0])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("stride", [2, 8, 32])
def test_chain_stage_runs_k10_twice_and_no_seed_sized_copy(chunk,
                                                           monkeypatch,
                                                           stride):
    """``compact_seeds_dual`` compacts the chain starts and the chain ends
    with K10 (``compact_starts``), never with K2, and its segmented copy
    runs over the records only, not over the seed array."""
    data, padded = chunk
    pos, cand = PM.anchor_candidates_fporder(torch.from_numpy(padded),
                                             stride)
    k = pos.shape[0]
    calls = {"k10": [], "k2": 0, "copy": []}
    real_k10, real_copy = C.compact_starts, PM.seg_end_copy

    def k10(start, a, b):
        calls["k10"].append(start.shape[0])
        return real_k10(start, a, b)

    def k2(*args):
        calls["k2"] += 1
        return C.compact_starts3_reference(*args)

    def copy(vals, is_end):
        calls["copy"].append(vals.shape[0])
        return real_copy(vals, is_end)

    for mod in (C, PM):
        monkeypatch.setattr(mod, "compact_starts", k10)
        monkeypatch.setattr(mod, "compact_starts3", k2, raising=False)
    monkeypatch.setattr(PM, "seg_end_copy", copy)
    with _CumminLengths() as cummin:
        fine, coarse = PM.compact_seeds_dual(pos, cand, len(data) - 31,
                                             PM.verify_gap(stride),
                                             PM._CHAIN_GAP)
    n_raw = fine[0].shape[0]
    assert calls["k10"] == [k, k] and calls["k2"] == 0
    assert n_raw > 3 and calls["copy"] == [n_raw]
    assert cummin.lengths == [n_raw]
    monkeypatch.undo()
    want = PM.compact_seeds(pos, cand, len(data) - 31, PM.verify_gap(stride))
    assert all(torch.equal(a, b) for a, b in zip(fine, want))


@pytest.mark.parametrize("offset", [1, 7, 15])
def test_k2_k10_take_slices_that_start_at_any_byte(offset):
    """A contiguous slice such as ``flag[1:]`` starts at any byte; the
    wrappers take it (on the card the kernel loads such edges byte by
    byte)."""
    rng = np.random.default_rng(offset)
    k = 9_000
    flag = torch.from_numpy(rng.random(k + 16) < 0.3)[offset:offset + k]
    vals = [torch.from_numpy(rng.integers(-2**31, 2**31, k + 16,
                                          dtype=np.int64).astype(np.int32))
            [offset:offset + k] for _ in range(3)]
    assert flag.is_contiguous() and flag.storage_offset() == offset
    idx = np.flatnonzero(flag.numpy())
    got3 = C.compact_starts3(flag, *vals)
    got2 = C.compact_starts(flag, *vals[:2])
    assert int(got3[3]) == int(got2[2]) == len(idx)
    for out, x in zip((*got3[:3], *got2[:2]), (*vals, *vals[:2])):
        assert np.array_equal(out.numpy()[:len(idx)], x.numpy()[idx])


@pytest.mark.parametrize("stride", [4, 32])
@pytest.mark.parametrize("kind", ["mixed", "zeros", "random"])
def test_tokens_match_at_strides_4_and_32(corpus_factory, kind, stride):
    data = np.frombuffer(corpus_factory(200_000, kind), np.uint8)
    jtok = M.TpuMatchJob(data, stride=stride).collect()
    job = PM.MatchJob(data, stride, CPU)
    for a, b in zip(job.collect(), jtok):
        assert a.dtype == b.dtype and np.array_equal(a, b)
