"""The port's own copies of the host layers (format, utils, runtime,
crypto, filters, backends, rzip_host, crosschunk) against the JAX
package's originals: the C++ sources byte for byte, ``Settings`` field
for field, and the same bytes out of every layer on seeded inputs."""

import dataclasses
import io
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

import lrzip_next_tpu as lrz
import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu import backends as jbackends
from lrzip_next_tpu import runtime as jruntime
from lrzip_next_tpu.crypto import CryptoContext as JCrypto
from lrzip_next_tpu.format import constants as JC
from lrzip_next_tpu.format import container as jcontainer
from lrzip_next_tpu.format import magic as jmagic
from lrzip_next_tpu.format import tokens as jtokens
from lrzip_next_tpu.models import crosschunk as jcross
from lrzip_next_tpu.models import pipeline as jpipeline
from lrzip_next_tpu.models import rzip_host as jrzip
from lrzip_next_tpu.ops import filters as jfilters
from lrzip_next_tpu.ops import lz4gate as jgate
from lrzip_next_tpu.utils import hashing as jhashing
from lrzip_next_tpu.utils import memplan as jmemplan
from lrzip_next_tpu_torch import backends as pbackends
from lrzip_next_tpu_torch import runtime as pruntime
from lrzip_next_tpu_torch.crypto import CryptoContext as PCrypto
from lrzip_next_tpu_torch.format import constants as PC
from lrzip_next_tpu_torch.format import container as pcontainer
from lrzip_next_tpu_torch.format import magic as pmagic
from lrzip_next_tpu_torch.format import tokens as ptokens
from lrzip_next_tpu_torch.models import crosschunk as pcross
from lrzip_next_tpu_torch.models import pipeline as ppipeline
from lrzip_next_tpu_torch.models import rzip_host as przip
from lrzip_next_tpu_torch.ops import filters as pfilters
from lrzip_next_tpu_torch.ops import lz4gate as pgate
from lrzip_next_tpu_torch.utils import hashing as phashing
from lrzip_next_tpu_torch.utils import memplan as pmemplan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = ["hostops.cpp", "rans.cpp", "lzma.cpp", "zpaq.cpp", "bwt.cpp",
        "zpaq_statetable.inc"]


def _zipf(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.2
    return rng.choice(256, n, p=p / p.sum()).astype(np.uint8).tobytes()


def _repeating(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, n // 3 + 100, dtype=np.uint8).tobytes()
    return (base + _zipf(n // 3, seed) + base)[:n]


# --- sources and settings ----------------------------------------------------


@pytest.mark.parametrize("name", CSRC)
def test_cpp_source_is_byte_identical(name):
    """The copies cannot drift from the originals unseen."""
    ours = os.path.join(ROOT, "lrzip_next_tpu_torch", "runtime", "csrc", name)
    theirs = os.path.join(ROOT, "lrzip_next_tpu", "runtime", "csrc", name)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_runtime_sources_are_all_copied():
    theirs = os.path.join(ROOT, "lrzip_next_tpu", "runtime", "csrc")
    assert sorted(os.listdir(theirs)) == sorted(CSRC)
    assert [os.path.basename(s) for s in pruntime._SRCS] == \
        [os.path.basename(s) for s in jruntime._SRCS]


def test_runtime_library_lies_in_the_build_directory():
    from lrzip_next_tpu_torch.ops import _build
    assert os.path.dirname(pruntime._SO) == str(_build.BUILD_DIR)
    assert os.path.basename(pruntime._SO) != \
        os.path.basename(jruntime._SO)
    assert pruntime.available()
    assert os.path.exists(pruntime._SO)


def test_settings_fields_and_defaults_equal():
    ours = {f.name: (f.type, f.default)
            for f in dataclasses.fields(lrzt.Settings)}
    theirs = {f.name: (f.type, f.default)
              for f in dataclasses.fields(lrz.Settings)}
    assert list(ours) == list(theirs)
    assert ours == theirs
    assert dataclasses.asdict(lrzt.Settings()) == \
        dataclasses.asdict(lrz.Settings())


_SETTINGS_CASES = [
    {}, {"method": "zpaq", "compression_level": 9, "zpaq_bs": 7},
    {"method": "zstd", "compression_level": 2, "zstd_level": 0},
    {"method": "lzma", "compression_level": 4, "dict_size": 1 << 22,
     "lzma_mf": 3, "bemt": False},
    {"rzip_level": 3, "anchor_stride": 0, "threads": 3},
    {"anchor_stride": 4, "window": 2, "comment": b"hello"},
    {"passphrase": b"pw", "enc_code": 2, "costfactor_exp": 11},
    {"filter_flag": JC.FILTER_DELTA, "delta_offset": 5, "lz4_test": False,
     "threshold": 90, "hash_name": "SHA256", "bzip3_bs": 6},
    {"use_tpu": True, "use_mesh": False, "unlimited": True,
     "max_chunk": 12345, "cross_chunk": True, "block_size": 4096},
]


@pytest.mark.parametrize("kw", _SETTINGS_CASES)
def test_settings_from_reference_round_trips(kw):
    progress = lambda *a: None  # noqa: E731
    js = lrz.Settings(progress=progress, stats_sink=print, **kw)
    ps = lrzt.settings_from_reference(js)
    assert isinstance(ps, lrzt.Settings)
    for f in dataclasses.fields(lrz.Settings):
        assert getattr(ps, f.name) == getattr(js, f.name), f.name
    assert ps.progress is progress and ps.stats_sink is print
    for name in ("resolved_threads", "resolved_rzip_level",
                 "resolved_dict_size", "resolved_zpaq_level",
                 "resolved_anchor_stride", "resolved_zstd"):
        assert getattr(ps, name)() == getattr(js, name)(), name
    # a dict and a plain object carry the same fields
    assert lrzt.settings_from_reference(dataclasses.asdict(js)
                                        | {"progress": progress,
                                           "stats_sink": print}) == ps
    assert lrzt.settings_from_reference(
        types.SimpleNamespace(**vars(js))) == ps
    assert lrzt.settings_from_reference({"method": "gzip"}) == \
        lrzt.Settings(method="gzip")


@pytest.mark.parametrize("obj", [
    {"method": "gzip", "use_gpu": True},
    types.SimpleNamespace(method="gzip", lanes=4),
])
def test_settings_from_reference_raises_on_unknown_field(obj):
    with pytest.raises(ValueError, match="unknown settings field"):
        lrzt.settings_from_reference(obj)


def test_settings_from_reference_raises_on_unknown_dataclass_field():
    @dataclasses.dataclass
    class Wider(lrz.Settings):
        brand_new_dial: int = 3

    with pytest.raises(ValueError, match="brand_new_dial"):
        lrzt.settings_from_reference(Wider())


@pytest.mark.parametrize("total", [0, 1, 99_999, 100_000, 250_001,
                                   (256 << 20) + 5, 3 << 30])
@pytest.mark.parametrize("kw", [{}, {"max_chunk": 100_000}, {"window": 1},
                                {"unlimited": True},
                                {"unlimited": True, "max_chunk": 70_000},
                                {"use_tpu": True},
                                {"use_tpu": True, "max_chunk": 1 << 29}])
def test_plan_chunks_equals_jax(total, kw):
    js = lrz.Settings(**kw)
    assert ppipeline.plan_chunks(
        total, lrzt.settings_from_reference(js), ram_budget=8 << 30) == \
        jpipeline.plan_chunks(total, js, ram_budget=8 << 30)
    assert ppipeline.DEVICE_CHUNK_CAP == jpipeline.TPU_CHUNK_CAP


def test_constants_equal():
    names = [n for n in dir(JC) if n.isupper()]
    assert len(names) > 40
    for n in names:
        assert getattr(PC, n) == getattr(JC, n), n
    for size in (0, 1, 255, 256, 1 << 24, 1 << 40):
        assert PC.chunk_byte_width(size) == JC.chunk_byte_width(size)


# --- format -------------------------------------------------------------------


@pytest.mark.parametrize("kw", _SETTINGS_CASES)
def test_magic_header_bytes_equal(kw):
    js = lrz.Settings(**kw)
    ps = lrzt.settings_from_reference(js)
    for total, eof in ((0, True), (123_456_789, True), (1 << 33, False)):
        jm = jpipeline._magic_for(js, total, eof)
        pm = ppipeline._magic_for(ps, total, eof)
        if js.passphrase:
            jm.enc_code = pm.enc_code = js.enc_code
            jm.salt = pm.salt = b"12345678"
        assert pm.encode() == jm.encode()
        assert pm.header_len == jm.header_len
        back = pmagic.MagicHeader.decode(jm.encode())
        assert dataclasses.asdict(back) == dataclasses.asdict(
            jmagic.MagicHeader.decode(jm.encode()))
    jc, pc = jpipeline._backend_cfg(js), ppipeline._backend_cfg(ps)
    assert vars(pc) == vars(jc)


def _tokens(seed: int, n_tok: int = 400):
    rng = np.random.default_rng(seed)
    kinds = (rng.random(n_tok) < 0.5).astype(np.uint8)
    lengths = np.where(kinds == 1, rng.integers(32, 70_000, n_tok),
                       rng.integers(1, 200_000, n_tok)).astype(np.int64)
    starts = np.cumsum(lengths) - lengths
    dists = np.where(kinds == 1, np.minimum(
        rng.integers(1, 1 << 20, n_tok), np.maximum(starts, 1)),
        0).astype(np.int64)
    kinds[0], dists[0] = 0, 0
    return kinds, lengths, dists


@pytest.mark.parametrize("seed,w", [(1, 4), (2, 5), (3, 8)])
def test_token_stream_bytes_equal(seed, w):
    k, ln, d = _tokens(seed)
    js = jtokens.split_long_runs(k, ln, d)
    ps = ptokens.split_long_runs(k, ln, d)
    for a, b in zip(ps, js):
        assert np.array_equal(a, b)
    jstream = jtokens.encode_token_stream(*js, w, 0xDEADBEEF)
    pstream = ptokens.encode_token_stream(*ps, w, 0xDEADBEEF)
    assert np.array_equal(pstream, jstream)
    for a, b in zip(ptokens.decode_token_stream(pstream, w),
                    jtokens.decode_token_stream(jstream, w)):
        assert np.array_equal(a, b)
    parsed = pruntime.parse_token_stream(np.asarray(pstream), w)
    for a, b in zip(parsed, jtokens.decode_token_stream(jstream, w)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("history", [False, True])
def test_replay_equals_jax(history):
    rng = np.random.default_rng(8)
    hist = rng.integers(0, 256, 5_000, dtype=np.uint8) if history else None
    kinds = np.array([0, 1, 0, 1, 1], np.uint8)
    lengths = np.array([1000, 400, 50, 3000, 64], np.int64)
    dists = np.array([0, 1000 + (4000 if history else 0), 0, 7, 1450],
                     np.int64)
    lits = rng.integers(0, 256, 1050, dtype=np.uint8)
    want = jtokens.replay_tokens(kinds, lengths, dists, lits, history=hist)
    assert np.array_equal(
        ptokens.replay_tokens(kinds, lengths, dists, lits, history=hist),
        want)
    assert np.array_equal(
        pruntime.replay_tokens(kinds, lengths, dists, lits,
                               int(lengths.sum()), history=hist), want)


@pytest.mark.parametrize("encrypted", [False, True])
def test_container_bytes_equal(encrypted):
    rng = np.random.default_rng(21)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for n in (40, 70_000, 17, 333)]

    def write(mod, crypto_cls):
        blocks = [mod.Block(streamno=i % 2, c_type=JC.CTYPE_NONE,
                            c_len=len(p), u_len=len(p), payload=p)
                  for i, p in enumerate(payloads)]
        crypto = None
        if encrypted:
            crypto = crypto_cls(b"pw", b"\x0asalt123", 1)
            salts = iter(bytes([i] * 8) for i in range(1, 99))
            crypto.new_block_salt = lambda: next(salts)
        buf = io.BytesIO()
        n = mod.write_chunk(buf, 4, True, 70_390, blocks, crypto=crypto)
        assert n == len(buf.getvalue())
        return buf.getvalue(), crypto

    ours, pcrypto = write(pcontainer, PCrypto)
    theirs, _ = write(jcontainer, JCrypto)
    assert ours == theirs
    fd = io.BytesIO(theirs)
    hdr = pcontainer.read_chunk_header(fd, encrypted=encrypted)
    reader = pcontainer.ChunkReader(fd, hdr, crypto=pcrypto)
    got = {s: [reader.read_payload(r) for r in reader.blocks(s)]
           for s in (0, 1)}
    assert got == {0: payloads[0::2], 1: payloads[1::2]}


@pytest.mark.parametrize("name", ["CRC", "MD5", "RIPEMD", "SHA256", "SHA384",
                                  "SHA512", "SHA3_256", "SHA3_512",
                                  "SHAKE128_16", "SHAKE256_64"])
def test_hashing_equal(name):
    if name not in JC.HASH_CODE:
        pytest.fail(f"{name} not in the hash registry")
    data = _zipf(50_000, 3)
    try:
        jh = jhashing.ArchiveHash(JC.HASH_CODE[name])
    except ValueError:
        with pytest.raises(ValueError):
            phashing.ArchiveHash(PC.HASH_CODE[name])
        return
    ph = phashing.ArchiveHash(PC.HASH_CODE[name])
    for part in (data[:7], data[7:30_000], data[30_000:]):
        jh.update(part)
        ph.update(part)
    assert ph.digest() == jh.digest()
    assert ph.digest_size == jh.digest_size and ph.name == jh.name
    assert phashing.stored_crc_int(0x12345678) == \
        jhashing.stored_crc_int(0x12345678)
    assert phashing.crc32_of(data) == jhashing.crc32_of(data)


# --- codecs, filters, crypto ---------------------------------------------------


@pytest.mark.parametrize("method", ["none", "gzip", "bzip2", "lzma", "zstd",
                                    "lzo", "zpaq", "bzip3", "rans"])
def test_codec_bytes_equal(method):
    data = _repeating(60_000, 31)
    ctype = pbackends.ctype_for_method(method)
    assert ctype == jbackends.ctype_for_method(method)
    jcfg = jpipeline._backend_cfg(lrz.Settings(method=method, threads=2))
    pcfg = ppipeline._backend_cfg(lrzt.Settings(method=method, threads=2))
    jct, jpayload = jbackends.compress_block(data, ctype, jcfg)
    pct, ppayload = pbackends.compress_block(data, ctype, pcfg)
    assert (pct, ppayload) == (jct, jpayload)
    assert pbackends.decompress_block(jpayload, jct, len(data), pcfg) == data
    assert jbackends.decompress_block(ppayload, pct, len(data), jcfg) == data


def test_available_methods_equal():
    assert pbackends.available_methods() == jbackends.available_methods()


@pytest.mark.parametrize("flag", [JC.FILTER_X86, JC.FILTER_ARM,
                                  JC.FILTER_ARMT, JC.FILTER_ARM64,
                                  JC.FILTER_PPC, JC.FILTER_SPARC,
                                  JC.FILTER_IA64, JC.FILTER_RISCV,
                                  JC.FILTER_DELTA])
def test_filters_equal(flag):
    data = _repeating(20_001, flag)
    ours = pfilters.apply_filter(data, flag, 3)
    assert ours == jfilters.apply_filter(data, flag, 3)
    assert pfilters.undo_filter(ours, flag, 3) == data


def test_lz4_gate_equal():
    for data in (_zipf(40_000, 1), os.urandom(0) + bytes(40_000),
                 np.random.default_rng(2).integers(
                     0, 256, 40_000, dtype=np.uint8).tobytes()):
        for thr in (100, 50):
            assert pgate.compressibility_gate(data, thr) == \
                jgate.compressibility_gate(data, thr)


def test_crypto_equal():
    for enc_code in (1, 2):
        j = JCrypto(b"passphrase", b"\x0abcdefg", enc_code)
        p = PCrypto(b"passphrase", b"\x0abcdefg", enc_code)
        for n in (16, 17, 1000):
            data = _zipf(n, n)
            ct = p.encrypt_block(data, b"blocksal")
            assert ct == j.encrypt_block(data, b"blocksal")
            assert p.decrypt_block(ct, b"blocksal") == data
        assert p.salt_pass == j.salt_pass


def test_memplan_equal():
    assert pmemplan.default_max_chunk(12 << 30) == \
        jmemplan.default_max_chunk(12 << 30)
    assert pmemplan.usable_ram(9 << 30, True) == \
        jmemplan.usable_ram(9 << 30, True)
    for method in ("lzma", "zpaq", "bzip3", "gzip"):
        args = (method, 8, 1 << 26, 1 << 30, 2 << 30)
        assert dataclasses.asdict(pmemplan.negotiate(*args)) == \
            dataclasses.asdict(jmemplan.negotiate(*args))


# --- host matcher helpers -------------------------------------------------------


def test_rzip_host_equal():
    data = np.frombuffer(_repeating(90_000, 41), np.uint8)
    ours = przip.rzip_encode_chunk(data)
    theirs = jrzip.rzip_encode_chunk(data)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)
    assert np.array_equal(przip.literals_of(data, ours[0], ours[1]),
                          jrzip.literals_of(data, theirs[0], theirs[1]))
    assert np.array_equal(przip.window_fingerprints(data[:5000]),
                          jrzip.window_fingerprints(data[:5000]))


def test_crosschunk_equal():
    base = np.frombuffer(_repeating(60_000, 51), np.uint8)
    data = np.concatenate([base, base[10_000:50_000]])
    out = []
    for mod in (pcross, jcross):
        idx = mod.CrossChunkIndex()
        idx.add_chunk(data[:60_000], 0)
        cross = mod.find_cross_matches(data, idx, 60_000, 40_000,
                                       (1 << 32) - 1)
        k = np.zeros(1, np.uint8)
        ln = np.array([40_000], np.int64)
        d = np.zeros(1, np.int64)
        out.append(mod.splice_cross_matches(k, ln, d, cross, 60_000))
    for a, b in zip(*out):
        assert np.array_equal(a, b)
    assert (out[0][0] == 1).any()


# --- the runtime build ----------------------------------------------------------


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two processes that start the port's runtime build together, into
    an empty directory, both end with a loaded library, and no temporary
    is left behind."""
    code = textwrap.dedent(f"""
        import os, sys
        from lrzip_next_tpu_torch import runtime
        runtime._BUILD_DIR = {str(tmp_path)!r}
        runtime._SO = os.path.join(runtime._BUILD_DIR, "liblrzt_hostops.so")
        assert not os.path.exists(runtime._SO)
        sys.stdin.readline()
        assert runtime.available(), runtime.build_error
        assert runtime.rans_decode(runtime.rans_encode(b"abc" * 99, 6),
                                   297) == b"abc" * 99
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    try:
        for p in procs:     # both are started; release them together
            p.stdin.write("go\n")
            p.stdin.flush()
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "ok"
    assert os.listdir(tmp_path) == ["liblrzt_hostops.so"]


def test_lz4_gate_loads_once_for_all_threads(monkeypatch):
    """The gate runs on pool threads.  While one thread loads liblz4 the
    others wait for it: none may see "no library" and gate its block by
    the entropy estimate, or one chunk's blocks would be gated by two
    rules and the archive bytes would depend on thread timing."""
    import threading
    import time
    real = pgate._load_lz4()
    if real is None:
        pytest.skip("no liblz4 on this machine")
    loads = []

    class SlowCDLL:
        def __init__(self, name):
            loads.append(name)
            time.sleep(0.3)
            self.LZ4_compress_default = real.LZ4_compress_default

    monkeypatch.setattr(pgate, "_lz4", None)
    monkeypatch.setattr(pgate, "_lz4_checked", False)
    monkeypatch.setattr(pgate.ctypes, "CDLL", SlowCDLL)
    # entropy below 100% but nothing for LZ4 to find: the two rules differ
    rng = np.random.default_rng(3)
    data = (rng.integers(0, 256, 50_000, dtype=np.uint8) & 0x3F).tobytes()
    assert pgate.entropy_estimate_pct(data) < 100.0
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(pgate.compressibility_gate(data)))
        for _ in range(4)]
    for t in threads:
        t.start()
        time.sleep(0.05)
    for t in threads:
        t.join()
    assert len(loads) == 1
    assert got == [False] * 4
