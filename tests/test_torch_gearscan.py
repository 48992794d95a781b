"""K11, the scan of the cross-window index (``ops/gearscan.py``), on the
CPU: its plain version and a numpy emulation of the kernel's tiles
(staged bytes, 32 positions a thread, the rolling 32-bit gear hash,
order by tile, thread and bit) against the host pair
``gear_anchor_positions`` + ``window_hashes_at``; and the pipeline's
once-a-window anchor set (``crosschunk.anchor_set``) with its
``cross_scan_card`` counter."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu_torch.models import crosschunk as X
from lrzip_next_tpu_torch.ops import gearscan as G

ROOT = Path(__file__).resolve().parents[1]
# the one byte whose repetition meets an 8-bit mask at every position
ALL_ANCHOR_BYTE, ALL_ANCHOR_BITS = 101, 8


def _kernel_trees_window(n: int, tree_bytes: int = 256 << 10
                         ) -> np.ndarray:
    """n bytes of six consecutive trees (``portbench``'s
    ``kernel_trees``), from 1000 bytes into the second."""
    from portbench.corpus import kernel_trees
    p = json.loads((ROOT / "portbench" / "traffic" / "kernel-trees.json")
                   .read_text())["params"]
    p.update(tree_bytes=tree_bytes, copy_window=tree_bytes,
             file_max=16 << 10)
    data = kernel_trees.generate(p, 2**33 + 22, 0, "cpu")
    return data[tree_bytes + 1000:tree_bytes + 1000 + n]


def _anchor_at_end() -> tuple:
    """Random bytes cut so that their last anchor lies at n - 33, the
    last position with a whole window after it."""
    data = np.random.default_rng(5).integers(0, 256, 40_000, np.uint8)
    last = int(X.gear_anchor_positions(data)[-1])
    return data, last + 33


def _past_n() -> tuple:
    """A window whose bytes past n (padding) would make anchors: n cuts
    20 bytes after an anchor of the whole buffer, whose window then
    reads past n."""
    data = np.random.default_rng(6).integers(0, 256, 30_000, np.uint8)
    anchors = X.gear_anchor_positions(data)
    return data, int(anchors[len(anchors) // 2]) + 20


def _case(name: str):
    """(buffer, n, mask_bits): the window is buffer[:n]."""
    rng = np.random.default_rng(7)
    if name == "random":
        return rng.integers(0, 256, 3 * 8192 + 5_003, np.uint8), None, 10
    if name == "text":
        text = (ROOT / "lrzip_next_tpu_torch" / "models" / "pipeline.py") \
            .read_bytes()
        return np.frombuffer(text, np.uint8)[:50_000], None, 10
    if name == "kernel_trees":
        return _kernel_trees_window(20_000), None, 10
    if name == "one_byte_all":
        return np.full(9_000, ALL_ANCHOR_BYTE, np.uint8), None, \
            ALL_ANCHOR_BITS
    if name == "one_byte_none":
        return np.full(9_000, 0, np.uint8), None, 10
    if name == "anchor_at_end":
        data, n = _anchor_at_end()
        return data, n, 10
    if name == "past_n":
        data, n = _past_n()
        return data, n, 10
    if name == "fewer_than_16":
        return rng.integers(0, 256, 15, np.uint8), None, 10
    if name == "one_position":
        return np.full(41, ALL_ANCHOR_BYTE, np.uint8), None, ALL_ANCHOR_BITS
    if name == "odd_length":
        return rng.integers(0, 256, 8192 + 32 + 8 + 7, np.uint8), None, 6
    raise KeyError(name)


CASES = ["random", "text", "kernel_trees", "one_byte_all", "one_byte_none",
         "anchor_at_end", "past_n", "fewer_than_16", "one_position",
         "odd_length"]


def _host_pair(window: np.ndarray, mask_bits: int):
    pos = X.gear_anchor_positions(window, mask_bits)
    return pos, X.window_hashes_at(window, pos)


def _tree_hash(cols: np.ndarray, mults) -> np.ndarray:
    a = cols.astype(np.uint32)
    for k in range(5):
        half = 1 << k
        a = a[:, :-half] * np.uint32(mults[k]) + a[:, half:]
    return a[:, 0]


M1 = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)
M2 = (0xD1B54A33, 0xABC98389, 0x8CB92BA7, 0x2545F491, 0x9E377F4B)


def emulate_k11(buf: np.ndarray, n: int, mask_bits: int):
    """``csrc/gear_anchors.cu`` step by step in numpy: a tile of 8192
    positions a block, its bytes [base - 16, base + 8224) staged with
    zeros outside [0, n); each of 256 threads rolls the gear hash in 32
    bits over its 32 positions from its 48 staged bytes; the anchors
    leave in tile, thread and bit order; each window is hashed from the
    stage."""
    tile, per, halo, win = 8192, 32, 16, 32
    lo = (X._GEAR & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    mask = np.uint32((1 << mask_bits) - 1)
    hi = n - win
    tiles = -(-hi // tile) if hi > 8 else 0
    off = np.arange(256) * per
    pos, fps = [np.zeros(0, np.int64)], [np.zeros(0, np.uint64)]
    with np.errstate(over="ignore"):
        for t in range(tiles):
            base = t * tile
            idx = np.arange(base - halo, base + tile + win)
            inside = (idx >= 0) & (idx < n)
            stage = np.where(inside, buf[np.clip(idx, 0, n - 1)], 0) \
                .astype(np.uint8)

            def byte(i):
                return stage[off + i]

            g = np.zeros(256, np.uint32)
            for k in range(8):
                g += lo[byte(halo - 1 - k)] << np.uint32(k)
            bits = np.zeros((256, per), bool)
            for p in range(per):
                j = base + off + p
                bits[:, p] = ((g & mask) == mask) & (j >= 8) & (j < hi)
                g = (g << np.uint32(1)) + lo[byte(halo + p)] \
                    - (lo[byte(halo - 8 + p)] << np.uint32(8))
            th, p = np.nonzero(bits)
            s = off[th] + halo + p
            cols = stage[s[:, None] + np.arange(win)]
            pos.append((base + s - halo).astype(np.int64))
            fps.append((_tree_hash(cols, M1).astype(np.uint64)
                        << np.uint64(32)) | _tree_hash(cols, M2))
    return np.concatenate(pos), np.concatenate(fps)


@pytest.mark.parametrize("name", CASES)
def test_k11_plain_equals_host_pair(name):
    buf, n, bits = _case(name)
    n = len(buf) if n is None else n
    want = _host_pair(buf[:n], bits)
    pos, fps, count = G.gear_anchors(torch.from_numpy(buf.copy()), n,
                                     X._GEAR, bits)
    got = G.read_anchors(pos, fps, count)
    assert got[0].dtype == np.int64 and got[1].dtype == np.uint64
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    if name in ("one_byte_all", "one_position"):
        assert len(want[0]) == n - 40 and int(count) == n - 40
    if name == "anchor_at_end":
        assert want[0][-1] == n - 33
    if name in ("one_byte_none", "fewer_than_16"):
        assert len(want[0]) == 0


@pytest.mark.parametrize("name", CASES)
def test_k11_tiles_emulated_equal_host_pair(name):
    buf, n, bits = _case(name)
    n = len(buf) if n is None else n
    want = _host_pair(buf[:n], bits)
    got = emulate_k11(buf, n, bits)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_k11_padding_past_n_makes_no_anchor():
    """Where the buffer goes on past n, its bytes make no anchor: the
    whole buffer has one at n - 20, the window none there."""
    buf, n = _past_n()
    assert n - 20 in set(X.gear_anchor_positions(buf).tolist())
    pos, _, count = G.gear_anchors(torch.from_numpy(buf.copy()), n, X._GEAR,
                                   10)
    assert int(count) and int(pos[:int(count)].max()) < n - 32


@pytest.mark.parametrize("n", range(21, 32))
def test_short_window_has_no_anchor(n):
    """A window of 21-31 bytes has no position with 32 bytes after it:
    no anchor, and so no fingerprint read past its end (a negative cut
    kept positions 8 .. 2n - 33)."""
    rng = np.random.default_rng(n)
    for _ in range(3000):
        data = rng.integers(0, 256, n, np.uint8)
        assert len(X.gear_anchor_positions(data)) == 0
        pos, h = X.anchor_set(data)
        assert len(pos) == len(h) == 0


@pytest.mark.parametrize("bad", ["dtype", "2d", "n_over", "table",
                                 "mask_bits"])
def test_k11_wrapper_rejects(bad):
    data = torch.zeros(100, dtype=torch.uint8)
    args = {"data": data, "n": 100, "gear": X._GEAR, "mask_bits": 10}
    if bad == "dtype":
        args["data"] = data.to(torch.int32)
    elif bad == "2d":
        args["data"] = data.view(10, 10)
    elif bad == "n_over":
        args["n"] = 101
    elif bad == "table":
        args["gear"] = X._GEAR[:255]
    else:
        args["mask_bits"] = 33
    with pytest.raises((TypeError, ValueError)):
        G.gear_anchors(**args)


def test_anchor_set_of_a_cpu_tensor_is_the_host_pair():
    buf, _, bits = _case("random")
    got = X.anchor_set(buf, bits, torch.from_numpy(buf.copy()))
    want = _host_pair(buf, bits)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def _nine_windows() -> bytes:
    """Nine 40 KB windows, each repeating parts of the ones before."""
    rng = np.random.default_rng(9)
    base = rng.integers(0, 256, 120_000, np.uint8)
    parts = [base[i * 13_000:i * 13_000 + 40_000] for i in range(9)]
    return np.concatenate(parts).tobytes()


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("mode", ["unlimited", "cross_chunk"])
def test_host_scan_runs_once_a_window(monkeypatch, device, mode):
    """Without a card the window's anchor set comes from the host pair
    once, and serves both the lookup and the index: nine gear scans for
    nine windows (the lookup and the index each scanned, 17), every
    window's ``cross_scan_card`` 0, and the archive decodes."""
    calls = []
    scan = X.gear_anchor_positions

    def counted(data, mask_bits=10):
        calls.append(len(data))
        return scan(data, mask_bits)

    monkeypatch.setattr(X, "gear_anchor_positions", counted)
    data = _nine_windows()
    stats = []
    s = lrzt.Settings(method="gzip", max_chunk=40_000, stats_sink=stats.append,
                      **{mode: True})
    archive = lrzt.compress(data, s, device=device)
    assert len(stats) == 9 and len(calls) == 9
    assert [s["cross_scan_card"] for s in stats] == [0] * 9
    assert stats[0]["cross_anchors"] == 0
    assert sum(s["cross_bytes"] for s in stats) > len(data) // 2
    assert lrzt.decompress(archive, device=device) == data


def test_cross_window_counter_is_not_a_cross_counter():
    """``cross_scan_card`` stays out of ``COUNTERS``, whose keys read 0
    on the first window: the card scans the first window too."""
    assert "cross_scan_card" not in X.COUNTERS


def test_index_takes_the_given_anchor_set():
    """``add_chunk`` and ``lookup`` take the anchor set as given and do
    not scan: the same candidates as from the bytes."""
    rng = np.random.default_rng(2)
    seg = rng.integers(0, 256, 60_000, dtype=np.uint8)
    anchors = X.anchor_set(seg)
    a, b = X.CrossChunkIndex(), X.CrossChunkIndex()
    a.add_chunk(seg, 0)
    b.add_chunk(np.zeros(0, np.uint8), 0, anchors)
    want = a.lookup(seg, 100_000)
    got = b.lookup(np.zeros(0, np.uint8), 100_000, None, anchors)
    assert len(want[0]) > 10
    assert all(np.array_equal(x, y) for x, y in zip(got, want))

