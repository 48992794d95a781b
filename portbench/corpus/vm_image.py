"""A virtual-machine disk image stand-in, in blocks of ``block`` bytes.

Block classes come in runs (geometric lengths with the mean of each
class, in a seeded order): zero blocks, executable-like bytes
(independent order-1 chains of a seeded byte model, one a block), text
(Zipf words of a seeded vocabulary) and random bytes (already compressed
files). Each class holds its declared share of the blocks, to the block.
Then ``repeat_share`` of the non-zero blocks are overwritten, in
segments of whole blocks inside one non-zero run, by copies of earlier
non-zero regions at block distances drawn log-uniform from
``repeat_dist`` (bytes). A copy never overlaps its own source.

Parameters (the traffic file's ``params``): ``size``, ``block``,
``shares`` and ``run_blocks`` (per class: zero, exe, text, random),
``repeat_share``, ``repeat_dist`` [lo, hi], ``repeat_blocks`` [lo, hi]
(segment lengths, log-uniform), ``vocab_words``, ``zipf_s``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import common

CLASSES = ("zero", "exe", "text", "random")

LETTERS = [bytes([c]) for c in b"etaoinshrdlcumwfgypbvkjxqz"]
LETTER_W = [12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8,
            2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.15, 0.15,
            0.1, 0.07]
SEPS = [b" ", b" ", b", ", b".\n", b"\n", b"=", b"/", b"\t"]
SEP_W = [70, 0, 8, 5, 6, 4, 4, 3]


def warmup(params) -> list:
    """Indices of the set-up inputs: one image of the window's size."""
    return [-1]


def layout(params, seed: int, index: int):
    """(classes per block, repeat segments (dst, src, n) in blocks)."""
    rng = common.host_rng(seed, "vm_image.layout", index)
    nblocks = params["size"] // params["block"]
    runs = []
    for c, name in enumerate(CLASSES):
        want = int(round(params["shares"][name] * nblocks))
        mean = params["run_blocks"][name]
        lens = rng.geometric(1.0 / mean, size=int(want / mean * 2) + 16)
        lens = lens[:int(np.searchsorted(np.cumsum(lens), want)) + 1]
        lens[-1] -= int(lens.sum()) - want
        runs += [(c, int(n)) for n in lens if n > 0]
    order = rng.permutation(len(runs))
    classes = np.zeros(nblocks, np.int8)
    cls = np.array([runs[i][0] for i in order], np.int8)
    lens = np.array([runs[i][1] for i in order], np.int64)
    filled = np.repeat(cls, lens)[:nblocks]
    classes[:len(filled)] = filled
    return classes, repeat_plan(params, rng, classes)


def repeat_plan(params, rng: np.random.Generator, classes: np.ndarray):
    """Segments (dst, src, n) in blocks, sorted by dst: whole blocks of
    one non-zero run copied from an earlier all-non-zero region."""
    block = params["block"]
    nz = classes != 0
    target = int(round(params["repeat_share"] * int(nz.sum())))
    zero_before = np.concatenate([[0], np.cumsum(~nz)])
    run_start = np.flatnonzero(np.diff(np.concatenate([[0], nz.view(
        np.int8), [0]])) == 1)
    run_end = np.flatnonzero(np.diff(np.concatenate([[0], nz.view(
        np.int8), [0]])) == -1)
    if target == 0 or len(run_start) == 0:
        return np.zeros((0, 3), np.int64)
    run_w = (run_end - run_start) / (run_end - run_start).sum()
    dlo, dhi = (np.log(max(d // block, 1)) for d in params["repeat_dist"])
    llo, lhi = (np.log(n) for n in params["repeat_blocks"])
    taken = np.zeros(len(classes), bool)
    segs, done = [], 0
    for _ in range(1000):
        if done >= target:
            break
        k = 4096
        r = rng.choice(len(run_start), size=k, p=run_w)
        dst = run_start[r] + (rng.random(k) * (run_end[r] - run_start[r])
                              ).astype(np.int64)
        n = np.exp(rng.uniform(llo, lhi, k)).astype(np.int64)
        d = np.exp(rng.uniform(dlo, dhi, k)).astype(np.int64)
        for dst_i, n_i, d_i, end_i in zip(dst.tolist(), n.tolist(),
                                          d.tolist(), run_end[r].tolist()):
            n_i = max(1, min(n_i, end_i - dst_i, target - done))
            src = dst_i - d_i
            if d_i < n_i or src < 0 or taken[dst_i:dst_i + n_i].any() or \
                    zero_before[src + n_i] != zero_before[src]:
                continue
            taken[dst_i:dst_i + n_i] = True
            segs.append((dst_i, src, n_i))
            done += n_i
            if done >= target:
                break
    segs.sort()
    return np.array(segs, np.int64).reshape(-1, 3)


def generate(params, seed: int, index: int, device, with_info: bool = False):
    block = params["block"]
    classes, segs = layout(params, seed, index)
    nblocks = len(classes)
    img = torch.zeros((nblocks, block), dtype=torch.uint8, device=device)
    cls_dev = torch.from_numpy(classes).to(device)

    rng = common.host_rng(seed, "vm_image.model")
    table = common.order1_table(rng).to(device)
    gen = common.dev_gen(device, seed, "vm_image.bytes", index)
    exe = torch.nonzero(cls_dev == 1).flatten()
    for i in range(0, exe.shape[0], 1 << 17):
        part = exe[i:i + (1 << 17)]
        img[part] = common.order1_bytes(gen, table, part.shape[0], block,
                                        device)
    txt = torch.nonzero(cls_dev == 2).flatten()
    if txt.shape[0]:
        vocab = common.Vocabulary(
            common.make_words(rng, params["vocab_words"], LETTERS, LETTER_W,
                              5.0, SEPS, SEP_W), params["zipf_s"], device)
        img[txt] = vocab.text(gen, txt.shape[0] * block, device).view(
            -1, block)
    rnd = torch.nonzero(cls_dev == 3).flatten()
    if rnd.shape[0]:
        img[rnd] = common.random_bytes(gen, rnd.shape[0] * block,
                                       device).view(-1, block)
    for dst, src, n in segs.tolist():
        img[dst:dst + n] = img[src:src + n]
    data = common.to_host(img.view(-1))
    if not with_info:
        return data
    return data, {"classes": classes, "repeats": segs, "block": block}
