"""Stand-ins of the twelve files of the Silesia corpus, at their own sizes.

Input ``i`` is file ``order_c[i % 12]`` of ``params["files"]``, where
``order_c`` is a seeded permutation for cycle ``c = i // 12``: every
seed sends the same twelve sizes each cycle, in its own order.  Set-up
inputs (negative indices) are one of each file.

Each file is drawn from its class, seeded by ``(seed, index)``:

- ``english``, ``polish``: Zipf words of a seeded vocabulary (Polish
  with its two-byte UTF-8 letters), with capitals and punctuation;
- ``xml``: Zipf draws of tags, attributes and words;
- ``chem``: Zipf draws of the numeric and atom fields of structure
  records (the NCI file);
- ``x86``: order-1 chains of a seeded byte model, 4 KiB a chain;
- ``exe_mix``: 64 KiB pieces of x86, text, random bytes and zeros (a tar
  of program binaries);
- ``tar_src``: a source tarball (``kernel_tar.build``, ``params["tar"]``);
- ``records``: fixed 100-byte database rows: a sequential key, small
  integers, a name from a vocabulary, float64 amounts;
- ``image16``: a 16-bit little-endian greyscale image, ``bits`` deep,
  ``width`` wide: a smooth field of a few waves plus Gaussian noise of
  ``noise`` levels, black where the field is under a quarter of full
  scale;
- ``stars``: 28-byte star records sorted by right ascension: float64 RA
  and Dec, float32 magnitude and proper motion, two letters of spectral
  type, two flag bytes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import common, kernel_tar

EN = [bytes([c]) for c in b"etaoinshrdlcumwfgypbvkjxqz"]
EN_W = [12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8,
        2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.15, 0.15, 0.1, 0.07]
PL = [bytes([c]) for c in b"aioeznrwcsytkdpmujlbg"] + [
    "ą".encode(), "ę".encode(), "ó".encode(), "ł".encode(), "ś".encode(),
    "ż".encode(), "ć".encode(), "ń".encode(), "ź".encode()]
PL_W = [8.9, 8.2, 7.8, 7.7, 5.6, 5.5, 4.7, 4.7, 4.0, 4.3, 3.8, 3.8, 3.5,
        3.3, 3.1, 2.8, 2.5, 2.3, 2.1, 1.5, 1.4, 1.0, 1.1, 0.9, 1.8, 0.7, 0.8,
        0.4, 0.2, 0.1]
SEPS = [b" ", b", ", b". ", b".\n", b";\n", b"\n\n", b"! ", b"? "]
SEP_W = [80, 8, 5, 3, 1, 1, 1, 1]


def warmup(params) -> list:
    return [-1 - k for k in range(len(params["files"]))]


def file_of(params, seed: int, index: int) -> dict:
    files = params["files"]
    if index < 0:
        return files[-1 - index]
    order = common.host_rng(seed, "silesia.order", index // len(files)
                            ).permutation(len(files))
    return files[order[index % len(files)]]


def _words(rng, alphabet, weights, n_words, capital: bool):
    words = common.make_words(rng, n_words, alphabet, weights, 5.5, SEPS,
                              SEP_W)
    if capital:
        words = [w[:1].upper() + w[1:] if i % 7 == 0 else w
                 for i, w in enumerate(words)]
    return words


def english(gen, rng, n, device, params, spec):
    v = common.Vocabulary(_words(rng, EN, EN_W, params["vocab_words"], True),
                          params["zipf_s"], device)
    return v.text(gen, n, device)


def polish(gen, rng, n, device, params, spec):
    v = common.Vocabulary(_words(rng, PL, PL_W, params["vocab_words"], True),
                          params["zipf_s"], device)
    return v.text(gen, n, device)


def xml(gen, rng, n, device, params, spec):
    tags = [b"record", b"name", b"value", b"item", b"id", b"type", b"date",
            b"author", b"title", b"entry", b"ref", b"note"]
    words = []
    for w in _words(rng, EN, EN_W, params["vocab_words"] // 2, False):
        t = tags[int(rng.integers(0, len(tags)))]
        words += [w, b"<" + t + b">", b"</" + t + b">\n",
                  b"<" + t + b' id="' + w.strip() + b'">']
    return common.Vocabulary(words, params["zipf_s"], device).text(
        gen, n, device)


def chem(gen, rng, n, device, params, spec):
    atoms = [b" C   0  0", b" N   0  0", b" O   0  0", b" H   0  0",
             b" S   0  0", b" Cl  0  0", b" P   0  0"]
    words = [b"%10.4f" % x for x in rng.normal(0, 3, 3000)]
    words += atoms + [b"  0  0  0  0  0  0\n", b"  1  0  0\n", b"  2  0  0\n",
                      b"M  END\n$$$$\n", b"\n  -OEChem-\n\n"]
    words += [b"%3d%3d" % (a, b) for a, b in rng.integers(1, 40, (600, 2))]
    order = rng.permutation(len(words))
    return common.Vocabulary([words[i] for i in order], 0.9, device).text(
        gen, n, device)


def x86(gen, rng, n, device, params, spec):
    table = common.order1_table(rng).to(device)
    rows = (n + 4095) // 4096
    return common.order1_bytes(gen, table, rows, 4096, device).view(-1)[:n]


def exe_mix(gen, rng, n, device, params, spec):
    piece = 1 << 16
    k = (n + piece - 1) // piece
    kinds = rng.choice(4, size=k, p=[0.5, 0.2, 0.2, 0.1])
    parts = {0: x86(gen, rng, int((kinds == 0).sum()) * piece, device,
                    params, spec),
             1: english(gen, rng, int((kinds == 1).sum()) * piece, device,
                        params, spec),
             2: common.random_bytes(gen, int((kinds == 2).sum()) * piece,
                                    device)}
    out = torch.zeros((k, piece), dtype=torch.uint8, device=device)
    for c, data in parts.items():
        rows = torch.from_numpy(np.flatnonzero(kinds == c)).to(device)
        if rows.shape[0]:
            out[rows] = data.view(-1, piece)
    return out.view(-1)[:n]


def tar_src(gen, rng, n, device, params, spec):
    seed = int(rng.integers(1 << 62))
    data, _ = kernel_tar.build(params["tar"], seed, seed, 0, n, device,
                               "silesia.tar")
    return torch.from_numpy(data).to(device)


def _le(values: torch.Tensor, width: int) -> torch.Tensor:
    """(N, width) uint8 little-endian bytes of int64 values."""
    shifts = torch.arange(width, device=values.device) * 8
    return ((values[:, None] >> shifts) & 0xFF).to(torch.uint8)


def _float_bytes(values: torch.Tensor, dtype) -> torch.Tensor:
    return values.to(dtype).contiguous().view(torch.uint8).view(
        values.shape[0], -1)


def records(gen, rng, n, device, params, spec):
    rows = (n + 99) // 100
    names = _words(rng, EN, EN_W, 2000, True)
    table = torch.tensor(np.frombuffer(b"".join(
        (w.strip() + b" " * 20)[:20] for w in names), np.uint8).reshape(
            -1, 20).copy(), device=device)
    key = torch.arange(rows, device=device) + int(rng.integers(1, 1 << 20))
    small = torch.randint(0, 64, (rows, 4), generator=gen, device=device)
    pick = torch.randint(0, len(names), (rows,), generator=gen, device=device)
    amount = torch.floor(torch.rand(rows, 2, generator=gen, device=device,
                                    dtype=torch.float64) * 1e6) / 100
    rec = torch.cat([
        _le(key, 4), small.to(torch.uint8), table[pick],
        _float_bytes(amount[:, 0], torch.float64),
        _float_bytes(amount[:, 1], torch.float64),
        torch.zeros((rows, 100 - 4 - 4 - 20 - 16), dtype=torch.uint8,
                    device=device)], 1)
    return rec.view(-1)[:n]


def image16(gen, rng, n, device, params, spec):
    width = spec["width"]
    height = (n // 2 + width - 1) // width
    y = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    x = torch.arange(width, device=device, dtype=torch.float32)[None, :]
    top = float(1 << spec["bits"]) - 1
    field = torch.full((height, width), top / 3, device=device)
    for _ in range(6):
        fy, fx = rng.uniform(0.001, 0.02, 2)
        ph = rng.uniform(0, 2 * math.pi)
        field += float(rng.uniform(0.03, 0.12)) * top * torch.cos(
            2 * math.pi * (fy * y + fx * x) + ph)
    field += torch.randn((height, width), generator=gen, device=device) * \
        spec["noise"]
    pix = torch.where(field < top / 4, 0.0, field).clamp(0, top).to(
        torch.int32)
    return _le(pix.view(-1).to(torch.int64), 2).view(-1)[:n]


def stars(gen, rng, n, device, params, spec):
    rows = (n + 27) // 28
    ra = torch.sort(torch.rand(rows, generator=gen, device=device,
                               dtype=torch.float64) * (2 * math.pi)).values
    dec = torch.asin(torch.rand(rows, generator=gen, device=device,
                                dtype=torch.float64) * 2 - 1)
    mag = torch.rand(rows, generator=gen, device=device) * 9 + 2
    pm = torch.randn(rows, generator=gen, device=device) * 0.01
    sp = torch.tensor([list(b"B0"), list(b"A0"), list(b"F5"), list(b"G2"),
                       list(b"K0"), list(b"M3")], dtype=torch.uint8,
                      device=device)
    kind = torch.randint(0, 6, (rows,), generator=gen, device=device)
    flags = torch.randint(0, 4, (rows, 2), generator=gen, device=device)
    rec = torch.cat([_float_bytes(ra, torch.float64),
                     _float_bytes(dec, torch.float64),
                     _float_bytes(mag, torch.float32),
                     _float_bytes(pm, torch.float32), sp[kind],
                     flags.to(torch.uint8)], 1)
    return rec.view(-1)[:n]


CLASSES = {f.__name__: f for f in (english, polish, xml, chem, x86, exe_mix,
                                   tar_src, records, image16, stars)}


def generate(params, seed: int, index: int, device, with_info: bool = False):
    spec = file_of(params, seed, index)
    gen = common.dev_gen(device, seed, "silesia.bytes", index)
    rng = common.host_rng(seed, "silesia.model", index)
    data = common.to_host(CLASSES[spec["class"]](
        gen, rng, spec["size"], device, params, spec))
    if not with_info:
        return data
    return data, {"name": spec["name"], "size": spec["size"]}
