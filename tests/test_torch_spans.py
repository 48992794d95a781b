"""The port's stage spans (``utils/spans.py``) on the CPU: with no stats
sink and no profiler nothing is recorded, with a sink every chunk's dict
carries its calling thread's stages and its pool time and reaches the
sink with its chunk (the last with the operation's own stages, when it
ends), and under a profiler the ``lrzt.`` ranges of one operation tile its calling thread
without overlapping."""

import dataclasses
import io
import time
import types

import numpy as np
import pytest
import torch

import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu_torch.utils import spans
from portbench.core.readings import stage_ms_per_gib

COMPRESS_STAGES = {"compress." + s for s in (
    "setup", "queue", "match_wait", "host_match", "cross_find", "cross_index",
    "literal_encode", "crc_wait", "tokens", "backend_wait", "write", "hash",
    "hash_wait")}
DECOMPRESS_STAGES = {"decompress." + s for s in (
    "setup", "read", "backend_wait", "parse", "flatten", "replay_launch",
    "readback_wait", "host_replay", "crc", "history", "hash", "hash_wait",
    "join")}
DEVICE_KEYS = ("device_ms", "host_ms", "literal_ms", "fill_ms")


@pytest.fixture(scope="module")
def data():
    """Skewed bytes (rANS codes their literals smaller, so a rans chunk
    takes the device literal path both ways) and a repeat."""
    p = 1.0 / np.arange(1, 257) ** 1.2
    body = np.random.default_rng(3).choice(256, 180_000, p=p / p.sum())
    body = body.astype(np.uint8).tobytes()
    return body + body[20_000:80_000]


def _settings(method, sink=None):
    return lrzt.Settings(method=method, max_chunk=80_000, stats_sink=sink)


def _timed_round_trip(data, method, sink):
    """(compress seconds, decompress seconds) of one round trip."""
    out = io.BytesIO()
    t0 = time.perf_counter()
    lrzt.compress_stream(data, out, _settings(method, sink), device="cpu")
    t1 = time.perf_counter()
    back = lrzt.decompress_stream(io.BytesIO(out.getvalue()),
                                  _settings(method, sink), device="cpu")
    t2 = time.perf_counter()
    assert back == data
    return t1 - t0, t2 - t1


@pytest.mark.parametrize("method", ["rans", "lzma"])
@pytest.mark.parametrize("device", ["cpu", None])
def test_no_sink_and_no_profiler_record_nothing(data, method, device,
                                                monkeypatch):
    """Without a sink and a profiler a stage is the shared no-op: no
    range is ever opened."""
    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert spans.stage("x", None) is spans.stage("y", None)
    assert spans.timed(refuse, None) is refuse
    out = io.BytesIO()
    lrzt.compress_stream(data, out, _settings(method), device=device)
    assert lrzt.decompress_stream(io.BytesIO(out.getvalue()),
                                  _settings(method), device=device) == data


@pytest.mark.parametrize("method", ["rans", "lzma"])
def test_sink_dicts_carry_the_stages_and_the_pool_time(data, method):
    stats = []
    t_c, t_d = _timed_round_trip(data, method, stats.append)
    comp = [s for s in stats if s["op"] == "compress"]
    dec = [s for s in stats if s["op"] == "decompress"]
    assert len(comp) + len(dec) == len(stats)
    assert [s["chunk"] for s in comp] == [0, 1, 2]
    assert [s["chunk"] for s in dec] == [0, 1, 2]
    assert sum(s["chunk_bytes"] for s in dec) == len(data)

    keys = set().union(*(s["main_ms"] for s in comp))
    assert keys <= COMPRESS_STAGES
    want = {"setup", "queue", "match_wait", "crc_wait", "tokens",
            "backend_wait", "write", "hash", "hash_wait"}
    if method == "rans":
        want.add("literal_encode")
    assert {"compress." + s for s in want} <= keys
    assert all(s["backend_ms"] > 0 for s in comp)
    # the operation's own stages land in its last chunk's dict: the
    # archive hash runs on its own thread, so the calling thread's wait
    # for it and the digest's write are the operation's, and the last
    # dict carries the hash thread's busy time
    for name in ("compress.setup", "compress.hash", "compress.hash_wait"):
        assert [(name in s["main_ms"]) for s in comp] == [False, False, True]
    assert [("hash_ms" in s) for s in comp] == [False, False, True]
    assert comp[-1]["hash_ms"] > 0
    assert [("decompress.join" in s["main_ms"]) for s in dec] == \
        [False, False, True]

    keys = set().union(*(s["main_ms"] for s in dec))
    assert keys <= DECOMPRESS_STAGES
    assert {"decompress.setup", "decompress.read", "decompress.parse",
            "decompress.backend_wait", "decompress.crc",
            "decompress.hash", "decompress.join"} <= keys
    assert ("decompress.replay_launch" in keys) == (method == "rans")
    assert ("decompress.host_replay" in keys) == (method == "lzma")
    assert all(s["backend_ms"] >= 0 for s in dec)
    assert sum(s["backend_ms"] for s in dec) > 0

    # the stages cover the calling thread's call
    for sel, secs in ((comp, t_c), (dec, t_d)):
        ms = sum(v for s in sel for v in s["main_ms"].values())
        assert 0.9 * secs * 1e3 <= ms <= secs * 1e3


@pytest.mark.parametrize("method", ["rans", "lzma"])
def test_each_chunk_dict_reaches_the_sink_with_its_chunk(data, method):
    """A chunk's dict is handed on as the chunk is written (the progress
    callback follows it) or yielded, not held back to the next chunk;
    the last one waits for the operation's end."""
    stats, seen = [], []
    settings = dataclasses.replace(
        _settings(method, stats.append),
        progress=lambda stage, done, total: seen.append(len(stats)))
    out = io.BytesIO()
    lrzt.compress_stream(data, out, settings, device="cpu")
    assert seen == [1, 2, 2] and len(stats) == 3
    del stats[:]
    chunks = []
    for chunk in lrzt.iter_decompress(io.BytesIO(out.getvalue()),
                                      _settings(method, stats.append),
                                      device="cpu"):
        chunks.append(chunk)
        assert [s["chunk"] for s in stats] == list(range(len(chunks)))[:2]
    assert b"".join(chunks) == data
    assert [s["chunk"] for s in stats] == [0, 1, 2]
    assert "decompress.hash" in stats[-1]["main_ms"]


@pytest.mark.parametrize("method", ["rans", "lzma"])
def test_decode_dicts_leave_the_compress_stage_sums_alone(data, method):
    """A decode dict carries none of the keys that
    ``stage_ms_per_gib`` sums, so the compress metrics read the same with
    the decode dicts in the run's stats."""
    stats = []
    _timed_round_trip(data, method, stats.append)
    dec = [s for s in stats if s["op"] == "decompress"]
    assert dec and not any(k in s for s in dec for k in DEVICE_KEYS)
    full = types.SimpleNamespace(
        stats=stats, ops=[{"kind": "compress", "bytes_in": len(data)}])
    comp = types.SimpleNamespace(
        stats=[s for s in stats if s["op"] == "compress"], ops=full.ops)
    for key in DEVICE_KEYS:
        assert stage_ms_per_gib(full, key) == stage_ms_per_gib(comp, key)


def test_host_matcher_and_unlimited_dicts(data):
    """The host matcher's chunks and ``-U``'s windows hand on a dict
    each too; their stages still sum to no more than the call."""
    for kw, device in (({}, None), ({"unlimited": True}, "cpu")):
        stats = []
        t0 = time.perf_counter()
        lrzt.compress(data, lrzt.Settings(method="gzip", max_chunk=80_000,
                                          stats_sink=stats.append, **kw),
                      device=device)
        secs = time.perf_counter() - t0
        assert [s["chunk"] for s in stats] == [0, 1, 2]
        assert all(s["op"] == "compress" for s in stats)
        assert sum(s["backend_ms"] for s in stats) > 0
        keys = set().union(*(s["main_ms"] for s in stats))
        assert keys <= COMPRESS_STAGES | {"compress.crc"}
        ms = sum(v for s in stats for v in s["main_ms"].values())
        assert 0.9 * secs * 1e3 <= ms <= secs * 1e3


@pytest.mark.parametrize("method", ["rans", "lzma"])
def test_ranges_tile_the_calling_thread(data, method):
    """Under a CPU profiler the ``lrzt.`` ranges of one operation on its
    calling thread lie inside the operation's range, never overlap one
    another, and cover most of it.  The lzma chunks are six times larger:
    at the fixture's size its decode takes about 15 ms, so one descheduling
    of the thread between two ranges on a loaded host would weigh more
    than a tenth of it."""
    settings = _settings(method)
    if method == "lzma":
        p = 1.0 / np.arange(1, 257) ** 1.2
        body = np.random.default_rng(4).choice(256, 1_080_000,
                                               p=p / p.sum())
        body = body.astype(np.uint8).tobytes()
        data = body + body[120_000:480_000]
        settings = dataclasses.replace(settings, max_chunk=480_000)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = io.BytesIO()
        with torch.profiler.record_function("test.compress"):
            lrzt.compress_stream(data, out, settings, device="cpu")
        with torch.profiler.record_function("test.decompress"):
            back = lrzt.decompress_stream(io.BytesIO(out.getvalue()),
                                          settings, device="cpu")
    assert back == data
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
               e.start_thread_id())
              for e in prof.profiler.kineto_results.events()]
    for op in ("compress", "decompress"):
        (s0, e0, _, tid), = [e for e in events if e[2] == "test." + op]
        mine = sorted(e for e in events
                      if e[2].startswith(spans.PREFIX + op + ".")
                      and e[3] == tid)
        assert mine
        assert s0 <= mine[0][0] and mine[-1][1] <= e0
        for a, b in zip(mine, mine[1:]):
            assert a[1] <= b[0], (a, b)
        covered = sum(e - s for s, e, _, _ in mine)
        assert covered >= 0.9 * (e0 - s0)


# every compress path: (settings, device, encode_tokens, use a test mesh,
# its stage names; where a path queues no job, "compress.queue" would
# time only a view of the window and is not asserted either way)
_JOB = {"queue", "match_wait"}
_CHUNKS = {"tokens", "crc_wait", "backend_wait", "write"}
_WHOLE = {"tokens", "crc", "backend_wait", "write"}
_CROSS = {"cross_find", "cross_index"}
PATHS = {
    "lookahead": ({}, "cpu", False, False, _JOB | _CHUNKS),
    "mesh": ({"use_mesh": True}, "cpu", False, True, _JOB | _CHUNKS),
    "host_matcher": ({}, None, False, False, {"host_match"} | _CHUNKS),
    "hook": ({}, "cpu", True, False, {"host_match"} | _CHUNKS),
    "unlimited_cpu": ({"unlimited": True}, "cpu", False, False,
                      _JOB | _CROSS | _WHOLE),
    "unlimited_host": ({"unlimited": True}, None, False, False,
                       {"host_match"} | _CROSS | _WHOLE),
    "cross_chunk": ({"cross_chunk": True}, "cpu", False, False,
                    _JOB | _CROSS | _CHUNKS),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_every_compress_path_hands_on_a_dict_a_window(data, path,
                                                      monkeypatch):
    """Each compress path (the lookahead, the mesh, the host matcher, the
    ``encode_tokens`` hook, ``-U`` with jobs and on the host, cross-chunk
    matching) hands the sink one compress dict a window, in window
    order, with that path's stage names; the operation's own stages
    land in the last dict, and where a cross-window index runs every
    dict carries its counters."""
    from lrzip_next_tpu_torch.models import crosschunk, rzip_host
    from lrzip_next_tpu_torch.parallel import mesh as pmesh
    kw, device, hook, on_mesh, stages = PATHS[path]
    if on_mesh:
        cpu_mesh = pmesh.make_mesh(devices=["cpu"] * 2)
        monkeypatch.setattr(pmesh, "pipeline_mesh", lambda *_: cpu_mesh)
    batches = pmesh.batches
    stats = []
    settings = dataclasses.replace(_settings("gzip", stats.append), **kw)
    out = io.BytesIO()
    lrzt.compress_stream(data, out, settings, device=device,
                         encode_tokens=rzip_host.rzip_encode_chunk
                         if hook else None)
    assert (pmesh.batches - batches > 0) == on_mesh
    assert [s["chunk"] for s in stats] == [0, 1, 2]
    assert [s["op"] for s in stats] == ["compress"] * 3
    assert sum(s["chunk_bytes"] for s in stats) == len(data)
    keys = set().union(*(s["main_ms"] for s in stats))
    want = {"compress." + s for s in stages | {"setup", "hash", "hash_wait"}}
    if "queue" in stages:
        assert keys == want
    else:
        assert keys - {"compress.queue"} == want
    for name in ("compress.setup", "compress.hash", "compress.hash_wait"):
        assert [(name in s["main_ms"]) for s in stats] == \
            [False, False, True]
    cross = set(crosschunk.COUNTERS) | {"cross_scan_card"}
    assert all((cross <= set(s)) == bool(_CROSS & stages) for s in stats)
    assert lrzt.decompress(out.getvalue(), device=device) == data
