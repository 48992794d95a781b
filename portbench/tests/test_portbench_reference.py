"""The plain reference decodes the program's archives and refuses
damaged ones.  The program is imported here only to make archives; the
reference itself imports none of it (``test_portbench_guard.py``)."""

import numpy as np
import pytest

import lrzip_next_tpu_torch as lrzt
from lrzip_next_tpu_torch.ops import rans
from portbench.reference import lrz


def skewed(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.2
    base = rng.choice(256, n, p=p / p.sum()).astype(np.uint8)
    base[n // 2:n // 2 + n // 8] = base[:n // 8]          # a long repeat
    base[n // 4:n // 4 + 4096] = 0                        # a zero run
    return base.tobytes()


@pytest.mark.parametrize("n", [1, 1000, 70_000, 300_001])
@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
def test_rans_blocks_decode_as_the_program_decodes(n, ctx_bits):
    data = skewed(n, n + ctx_bits)
    payload = rans.encode_block(data, ctx_bits, device="cpu")
    assert lrz.rans_decode(payload, n) == data
    assert rans.decode_block(payload, device="cpu") == data


@pytest.mark.parametrize("settings", [
    dict(method="rans", anchor_stride=8),
    dict(method="rans", anchor_stride=8, max_chunk=300_000),
    dict(method="lzma"),
    dict(method="lzma", max_chunk=200_000),
    dict(method="none")], ids=lambda s: "-".join(map(str, s.values())))
def test_reference_decodes_the_programs_archives(settings):
    data = skewed(700_000, 3)
    archive = lrzt.compress(data, lrzt.Settings(**settings), device="cpu")
    assert lrz.decode(archive) == data
    magic = lrz.read_magic(archive)
    chunks = lrz.read_chunks(archive, magic.header_len)
    assert sum(c.size for c in chunks) == len(data)
    assert chunks[-1].end + 16 == len(archive)
    pos = 0
    for c in chunks:
        assert lrz.decode_chunk(archive, c, magic) == data[pos:pos + c.size]
        pos += c.size


def test_reference_refuses_damaged_archives():
    data = skewed(400_000, 4)
    archive = lrzt.compress(data, lrzt.Settings(method="rans"), device="cpu")
    magic = lrz.read_magic(archive)
    (chunk,) = lrz.read_chunks(archive, magic.header_len)
    flips = [chunk.blocks[s][0][3] + 40 for s in (0, 1)] + [len(archive) - 1]
    for at in flips:
        bad = bytearray(archive)
        bad[at] ^= 0x10
        with pytest.raises(lrz.Corrupt):
            lrz.decode(bytes(bad))
    with pytest.raises(lrz.Corrupt):
        lrz.read_magic(b"LRZX" + archive[4:])
