"""The decode's verify tail on the CPU: each chunk's CRC in one pass as
its bytes land, and the archive hash on a thread of its own
(``utils/hashing.HashThread``, fed by ``pipeline._ChunkVerify``).  The
output, every ``ValueError`` and its message stay those of the JAX
package's decoder, which verifies on the calling thread; no hash thread
outlives a call; a corrupt chunk is never yielded; reference-style
archives, whose later chunks store the CRC of the whole prefix, still
verify."""

import io
import threading
import types
import zlib
from pathlib import Path

import numpy as np
import pytest

import lrzip_next_tpu as lrz
import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu_torch.format.constants import HASH_NAME
from lrzip_next_tpu_torch.models import pipeline as P
from lrzip_next_tpu_torch.utils import hashing
from lrzip_next_tpu_torch.utils.hashing import crc32_combine, \
    stored_crc_int


@pytest.fixture(scope="module", autouse=True)
def warm_jax_lz4_gate():
    """The JAX package's LZ4 gate loads its library racily on the first
    pool threads (ROADMAP.md, Faults): load it before any compare."""
    from lrzip_next_tpu.ops import lz4gate
    lz4gate._load_lz4()


def _zipf(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.2
    return rng.choice(256, n, p=p / p.sum()).astype(np.uint8).tobytes()


# 150 KB of skewed bytes with a repeat: rANS codes each chunk's literals
# smaller, so a rans chunk takes the device literal decode and replay
# (their plain versions on the CPU, about half a second a decode)
DATA = _zipf(120_000, 31) + _zipf(30_000, 32)
# three chunks of 50 KB, or one
CHUNKS = {1: {}, 3: {"max_chunk": 50_000}}
CRYPT = {"plain": {}, "encrypted": {"passphrase": b"pw",
                                    "costfactor_exp": 10}}
_archives = {}


def _archive(code: int, chunks: int, crypt: str = "plain",
             method: str = "rans"):
    """(JAX settings, archive) of ``DATA``, compressed once a key: rans
    with the matcher's plain version, every other method with the host
    matcher."""
    key = (code, chunks, crypt, method)
    if key not in _archives:
        js = lrz.Settings(method=method, use_tpu=method == "rans",
                          use_mesh=False, hash_name=HASH_NAME[code],
                          **CHUNKS[chunks], **CRYPT[crypt])
        _archives[key] = (js, lrzt.compress(
            DATA, lrzt.settings_from_reference(js),
            device="cpu" if method == "rans" else None))
    return _archives[key]


def _hash_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name == hashing.HASH_THREAD_NAME]


def _decode(call: str, archive: bytes, settings, device="cpu") -> bytes:
    """The port's decode of ``archive`` through one entry point."""
    if call == "stream":
        return lrzt.decompress_stream(io.BytesIO(archive), settings,
                                      device=device)
    if call == "stream_to":
        out = io.BytesIO()
        lrzt.decompress_stream_to(io.BytesIO(archive), out, settings,
                                  device=device)
        return out.getvalue()
    return b"".join(lrzt.iter_decompress(io.BytesIO(archive), settings,
                                         device=device))


def _flip(archive: bytes, pos: int) -> bytes:
    bad = bytearray(archive)
    bad[pos] ^= 0x01
    return bytes(bad)


# --- crc32_combine -----------------------------------------------------------


@pytest.mark.parametrize("len2", [0, 1, 3, 4, 17, 4_096, 100_001])
@pytest.mark.parametrize("len1", [0, 1, 5, 1_000])
def test_crc32_combine_equals_one_pass(len1, len2):
    """The CRC of ``A + B`` from those of ``A`` and ``B`` equals zlib's
    one pass, and so does the running value ``zlib.crc32(B, c)`` for any
    ``c``."""
    rng = np.random.default_rng(len1 * 7 + len2)
    a = rng.integers(0, 256, len1, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, len2, dtype=np.uint8).tobytes()
    assert crc32_combine(zlib.crc32(a), zlib.crc32(b), len2) == \
        zlib.crc32(a + b)
    for c in rng.integers(0, 2**32, 4, dtype=np.uint64):
        assert crc32_combine(int(c), zlib.crc32(b), len2) == \
            zlib.crc32(b, int(c))


# --- the hash thread ---------------------------------------------------------


@pytest.mark.parametrize("code", range(14))
def test_hash_thread_hashes_its_parts_in_order(code):
    """Parts of every size, put in order, give hashlib's digest of their
    join (the CRC for code 0); ``wait_for`` returns once they are
    hashed."""
    rng = np.random.default_rng(code)
    parts = [rng.integers(0, 256, n, dtype=np.uint8)
             for n in (0, 1, 1000, 65_537, 3)]
    thread = hashing.HashThread(hashing.ArchiveHash(code))
    try:
        assert [thread.put(p) for p in parts] == [1, 2, 3, 4, 5]
        thread.wait_for(5)
        thread.wait()
    finally:
        thread.stop()
    want = hashing.ArchiveHash(code)
    want.update(b"".join(p.tobytes() for p in parts))
    assert thread.hasher.digest() == want.digest()
    assert thread.busy_ms > 0 and not thread._thread.is_alive()


def test_hash_thread_error_reaches_put_wait_for_and_wait(monkeypatch):
    """An error on the thread ends it; the next ``put``, ``wait_for`` and
    ``wait`` each raise it."""
    def fail(self, part):
        raise OSError("input unreadable")

    monkeypatch.setattr(hashing.ArchiveHash, "update", fail)
    thread = hashing.HashThread(hashing.ArchiveHash(1))
    thread.put(b"x")
    with pytest.raises(OSError, match="unreadable"):
        thread.wait_for(1)
    with pytest.raises(OSError, match="unreadable"):
        thread.put(b"y")
    with pytest.raises(OSError, match="unreadable"):
        thread.wait()
    thread._thread.join(timeout=10)
    assert not thread._thread.is_alive()


def test_hash_thread_stop_drops_what_it_holds():
    """``stop()`` joins the thread after the part it is hashing and drops
    the rest; the thread is a daemon."""
    gate = threading.Event()
    seen = []

    class Slow:
        def update(self, part):
            seen.append(len(part))
            gate.wait(10)

    thread = hashing.HashThread(Slow())
    assert thread._thread.daemon
    for n in (1, 2, 3):
        thread.put(b"x" * n)
    while not seen:
        threading.Event().wait(0.001)
    stopper = threading.Thread(target=thread.stop)
    stopper.start()
    gate.set()
    stopper.join(timeout=10)
    assert not stopper.is_alive() and not thread._thread.is_alive()
    assert seen == [1]


# --- every hash code through every entry point -------------------------------


@pytest.mark.parametrize("call", ["stream", "stream_to", "iter"])
@pytest.mark.parametrize("crypt", sorted(CRYPT))
@pytest.mark.parametrize("chunks", sorted(CHUNKS))
@pytest.mark.parametrize("code", range(14))
def test_every_hash_code_verifies(code, chunks, crypt, call):
    """gzip chunks, replayed on the host (``device=None``: the whole
    chunk goes to the hash at once).  The output is the input; a flipped
    byte of the stored hash (the archive's last bytes, encrypted where
    the archive is) raises the JAX package's ``ValueError`` and message;
    code 0 stores no hash and starts no hash thread; none is left
    after."""
    js, archive = _archive(code, chunks, crypt, "gzip")
    ps = lrzt.settings_from_reference(js)
    assert _decode(call, archive, ps, device=None) == DATA
    it = lrzt.iter_decompress(io.BytesIO(archive), ps, device=None)
    first = next(it)
    assert len(_hash_threads()) == (1 if code else 0)
    assert first + b"".join(it) == DATA
    if code:
        bad = _flip(archive, len(archive) - 1)
        with pytest.raises(ValueError) as theirs:
            lrz.decompress(bad, js)
        with pytest.raises(ValueError) as ours:
            _decode(call, bad, ps, device=None)
        assert str(ours.value) == str(theirs.value) == \
            f"{HASH_NAME[code]} mismatch: archive corrupt"
    assert not _hash_threads()


@pytest.mark.parametrize("crypt", sorted(CRYPT))
@pytest.mark.parametrize("chunks", sorted(CHUNKS))
@pytest.mark.parametrize("code", [0, 1, 8, 13])
def test_device_replay_verifies(code, chunks, crypt):
    """rans chunks replayed through ``replay_device`` (the CPU's plain
    kernels), whose read-back feeds the CRC and the hash: the output and
    the stored-hash error as on the host path."""
    js, archive = _archive(code, chunks, crypt)
    ps = lrzt.settings_from_reference(js)
    assert _decode("stream", archive, ps) == DATA
    if code:
        with pytest.raises(ValueError,
                           match=f"^{HASH_NAME[code]} mismatch: archive "
                           "corrupt$"):
            _decode("iter", _flip(archive, len(archive) - 1), ps)
    assert not _hash_threads()


def test_decompress_file_verifies(tmp_path):
    """``decompress_file``: the history comes from the written file (a
    memmap); the output and the digest check are the same."""
    js, archive = _archive(1, 3, "plain")
    src, dst = tmp_path / "in.lrz", tmp_path / "out.bin"
    src.write_bytes(archive)
    assert lrzt.decompress_file(str(src), str(dst), device="cpu") == \
        len(DATA)
    assert dst.read_bytes() == DATA
    src.write_bytes(_flip(archive, len(archive) - 1))
    with pytest.raises(ValueError, match="MD5 mismatch"):
        lrzt.decompress_file(str(src), str(dst), device="cpu")
    assert not _hash_threads()


# --- a corrupt chunk, and errors on either thread ----------------------------


def _wrong_crc_on(monkeypatch, chunk: int):
    """Have the writer store a wrong CRC on chunk ``chunk`` (and only
    while compressing): ``stored_crc_int`` serves the writer and the
    reader both."""
    calls = []
    real = P.stored_crc_int

    def wrong(crc):
        calls.append(crc)
        return real(crc) ^ (0x80 if len(calls) == chunk + 1 else 0)

    monkeypatch.setattr(P, "stored_crc_int", wrong)


@pytest.mark.parametrize("device", ["cpu", None])
def test_corrupt_chunk_raises_before_it_is_yielded(device, monkeypatch):
    """Chunk 2 of 3 stores a CRC its bytes do not have: ``iter_decompress``
    yields chunks 0 and 1, then raises the CRC error, the JAX package's
    message, and yields nothing of chunk 2."""
    s = lrzt.Settings(method="rans", max_chunk=50_000)
    with monkeypatch.context() as m:
        _wrong_crc_on(m, 2)
        bad = lrzt.compress(DATA, s, device="cpu")
    got = []
    with pytest.raises(ValueError, match="chunk CRC mismatch") as ours:
        for chunk in lrzt.iter_decompress(io.BytesIO(bad), s,
                                          device=device):
            got.append(chunk)
    assert got == [DATA[:50_000], DATA[50_000:100_000]]
    stored = stored_crc_int(zlib.crc32(DATA[100_000:])) ^ 0x80
    assert str(ours.value) == f"chunk CRC mismatch: stored 0x{stored:08x}"
    assert not _hash_threads()


@pytest.mark.parametrize("fault", ["chunk", "hasher", "consumer"])
@pytest.mark.parametrize("device", ["cpu", None])
def test_error_leaves_no_hash_thread(device, fault, monkeypatch):
    """An error on the calling thread (chunk 1 of 3 fails its CRC), an
    error on the hash thread (its second part), and a consumer that stops
    after chunk 0: the error reaches the caller, and no hash thread is
    left."""
    s = lrzt.Settings(method="rans", max_chunk=50_000)
    archive = lrzt.compress(DATA, s, device="cpu")
    if fault == "chunk":
        with monkeypatch.context() as m:
            _wrong_crc_on(m, 1)
            archive = lrzt.compress(DATA, s, device="cpu")
        with pytest.raises(ValueError, match="chunk CRC mismatch"):
            lrzt.decompress(archive, s, device=device)
    elif fault == "hasher":
        update = hashing.ArchiveHash.update
        parts = []

        def second_fails(self, part):
            if parts:
                raise OSError("output unreadable")
            parts.append(len(part))
            update(self, part)

        monkeypatch.setattr(hashing.ArchiveHash, "update", second_fails)
        with pytest.raises(OSError, match="unreadable"):
            lrzt.decompress(archive, s, device=device)
        assert len(parts) == 1
    else:
        it = lrzt.iter_decompress(io.BytesIO(archive), s, device=device)
        assert next(it) == DATA[:50_000]
        assert len(_hash_threads()) == 1
        it.close()
    assert not _hash_threads()


# --- one CRC pass a chunk ----------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", None])
@pytest.mark.parametrize("chunks", sorted(CHUNKS))
def test_one_crc_pass_a_chunk(chunks, device, monkeypatch):
    """The decode CRCs each chunk's bytes once: the chunk's own reading,
    and the running CRC over the output combined from it, not a second
    pass."""
    js, archive = _archive(1, chunks, "plain")
    seen = []
    crc32 = zlib.crc32

    def counted(data, value=0):
        seen.append(len(memoryview(data).cast("B")))
        return crc32(data, value)

    monkeypatch.setattr(P.zlib, "crc32", counted)
    assert lrzt.decompress(archive, device=device) == DATA
    assert sum(seen) == len(DATA)


class _PrefixCrc:
    """``zlib`` as the reference's writer sees it: one CRC handle over the
    whole file, never reset between chunks (src/rzip.c:943-950), so each
    chunk stores the CRC of the whole prefix."""

    def __init__(self):
        self.value = 0

    def crc32(self, data, value=0):
        self.value = zlib.crc32(data, self.value)
        return self.value


def _prefix_crc_archive(monkeypatch, settings) -> bytes:
    with monkeypatch.context() as m:
        m.setattr(P, "zlib", _PrefixCrc())
        return lrzt.compress(DATA if settings.method != "none" else RANDOM,
                             settings, device="cpu")


RANDOM = np.random.default_rng(33).integers(0, 256, 150_000,
                                             dtype=np.uint8).tobytes()


@pytest.mark.parametrize("device", ["cpu", None])
def test_reference_prefix_crcs_verify(device, monkeypatch):
    """Chunks 1 and 2 store the CRC of the whole prefix, as the reference
    writes it: the archive verifies through the second reading, in both
    packages, with one CRC pass a chunk."""
    s = lrzt.Settings(method="rans", max_chunk=50_000)
    archive = _prefix_crc_archive(monkeypatch, s)
    assert archive != lrzt.compress(DATA, s, device="cpu")
    readings = []
    check = P.check_chunk_crc

    def spy(chunk_bytes, stored, cumulative, crc=None):
        own = check(chunk_bytes, stored, cumulative, crc)
        readings.append(stored == stored_crc_int(own))
        return own

    monkeypatch.setattr(P, "check_chunk_crc", spy)
    assert lrzt.decompress(archive, s, device=device) == DATA
    assert readings == [True, False, False]


@pytest.mark.parametrize("device", ["cpu", None])
def test_reference_prefix_crc_catches_a_flipped_byte(device, monkeypatch):
    """A flipped literal byte in chunk 2 of a prefix-CRC archive (stored
    chunks, ``method="none"``) fails both readings: the CRC error, the
    JAX package's message, before chunk 2 is yielded."""
    s = lrzt.Settings(method="none", max_chunk=50_000)
    archive = _prefix_crc_archive(monkeypatch, s)
    assert lrzt.decompress(archive, s, device=device) == RANDOM
    assert lrz.decompress(archive, lrz.Settings(method="none")) == RANDOM
    pos = archive.find(RANDOM[120_000:120_032])
    assert pos > 0
    bad = _flip(archive, pos + 7)
    got = []
    with pytest.raises(ValueError, match="chunk CRC mismatch") as ours:
        for chunk in lrzt.iter_decompress(io.BytesIO(bad), s,
                                          device=device):
            got.append(chunk)
    assert got == [RANDOM[:50_000], RANDOM[50_000:100_000]]
    with pytest.raises(ValueError) as theirs:
        lrz.decompress(bad, lrz.Settings(method="none"))
    assert str(ours.value) == str(theirs.value)
    assert not _hash_threads()


# --- the hash beside the decode ----------------------------------------------


@pytest.mark.parametrize("device", ["cpu", None])
def test_chunks_are_yielded_while_the_hash_waits(device, monkeypatch):
    """Chunk k's hash runs on while chunk k+1 decodes: with the hash held
    back, chunks 0 and 1 are yielded before it has hashed a byte."""
    gate = threading.Event()
    hashed = []
    update = hashing.ArchiveHash.update

    def held(self, part):
        gate.wait(30)
        hashed.append(len(part))
        update(self, part)

    monkeypatch.setattr(hashing.ArchiveHash, "update", held)
    js, archive = _archive(1, 3, "plain")
    it = lrzt.iter_decompress(io.BytesIO(archive), device=device)
    first, second = next(it), next(it)
    assert hashed == [] and not gate.is_set()
    gate.set()
    assert first + second + b"".join(it) == DATA
    assert sum(hashed) == len(DATA)


@pytest.mark.parametrize("device", ["cpu", None])
def test_the_hash_holds_at_most_two_chunks(device, monkeypatch):
    """With a slow hash, chunk k waits at its start for chunk k-2's hash
    (the stage ``decompress.hash_wait`` of its dict), so the thread never
    holds more than two chunks' parts."""
    update = hashing.ArchiveHash.update
    put = hashing.HashThread.put
    held = []

    def slow(self, part):
        threading.Event().wait(0.02)
        update(self, part)

    def counted(self, part):
        n = put(self, part)
        held.append(n - self._hashed)
        return n

    stats = []
    s = lrzt.Settings(method="gzip", max_chunk=25_000,
                      stats_sink=stats.append)
    archive = lrzt.compress(DATA, s, device=None)
    del stats[:]
    monkeypatch.setattr(hashing.ArchiveHash, "update", slow)
    monkeypatch.setattr(hashing.HashThread, "put", counted)
    assert lrzt.decompress(archive, s, device=device) == DATA
    assert len(held) == len(stats) > 3 and max(held) == 2
    waits = ["decompress.hash_wait" in d["main_ms"] for d in stats]
    assert waits[:2] == [False, False] and all(waits[2:])


# --- what the benchmark reads ------------------------------------------------


@pytest.mark.parametrize("method", ["rans", "gzip"])
def test_last_dict_carries_hash_ms_and_hash_wait(method):
    """The decompress's last dict carries the hash thread's ``hash_ms``
    and the op's ``decompress.hash_wait``; ``decode.hash_hidden_pct``
    reads a share of at most 100 from them."""
    stats = []
    s = lrzt.Settings(method=method, max_chunk=50_000,
                      stats_sink=stats.append)
    archive = lrzt.compress(DATA, s, device="cpu")
    del stats[:]
    assert lrzt.decompress(archive, s, device="cpu") == DATA
    assert [("hash_ms" in d) for d in stats] == [False, False, True]
    assert stats[-1]["hash_ms"] > 0
    assert "decompress.hash_wait" in stats[-1]["main_ms"]
    run = types.SimpleNamespace(stats=stats)
    assert _reader("decode.hash_hidden_pct")(run) <= 100.0


def _reader(name):
    from portbench.core import cell
    return cell.load_file(ROOT / "portbench" / "metrics" / f"{name}.py",
                          "test_metric_" + name.replace(".", "_")).read


ROOT = Path(__file__).resolve().parents[1]
# decompress dicts as the program hands them on: two files of one chunk,
# and a parent's dict, which has no ``hash_ms``
HASHED = [{"op": "decompress", "chunk": 0, "hash_ms": 200.0,
           "main_ms": {"decompress.hash_wait": 50.0}},
          {"op": "decompress", "chunk": 0, "hash_ms": 300.0,
           "main_ms": {"decompress.hash_wait": 100.0,
                       "decompress.crc": 9.0}},
          {"op": "compress", "chunk": 0, "hash_ms": 999.0,
           "main_ms": {"compress.hash_wait": 999.0}}]


def test_hidden_share_reader():
    """``100 (1 - sum hash_wait / sum hash_ms)`` over the decompress dicts;
    None on a parent's dicts, with hash code 0, and without a decompress;
    the entry in ``BENCHMARK.json`` lists the three decompress cells."""
    import json
    read = _reader("decode.hash_hidden_pct")
    run = types.SimpleNamespace
    assert read(run(stats=HASHED)) == pytest.approx(100.0 * (1 - 150 / 500))
    parent = [{k: v for k, v in d.items() if k != "hash_ms"} for d in HASHED]
    code0 = [dict(d, hash_ms=0.0) for d in HASHED[:2]]
    for stats in ([], parent, code0, HASHED[2:]):
        assert read(run(stats=stats)) is None
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = bench["per_layer"][-1]
    assert m == {"name": "decode.hash_hidden_pct", "unit": "%",
                 "better": "higher", "source": "program_span",
                 "layer": "decode path", "moves": "decompress_MBps",
                 "workloads": ["lzma-L7.kernel-tar", "rans-L7.silesia",
                               "lzma-L7-U.kernel-trees"]}
