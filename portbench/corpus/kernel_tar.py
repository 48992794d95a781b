"""A source-tree tarball stand-in (a kernel tarball, say): ustar members of
C-like text, written end to end to exactly ``size`` bytes.

Each member is a 512-byte ustar header and its content padded to 512.
Content sizes are log-normal (``file_median``, ``file_sigma``, at most
``file_max``). A member is fresh text (Zipf draws from a seeded
vocabulary of identifiers, keywords and punctuation) or, with
probability ``near_copy_share``, a near-copy of an earlier fresh member
that starts at most ``copy_window`` bytes back: the same bytes with
``edits`` [lo, hi] spans of ``edit_len`` [lo, hi] bytes (at most a 32nd
of the member each) replaced by fresh text. The archive ends with zero
blocks. The layout (sizes, near-copies, edits) and the vocabulary are
the same for every seed, so that a seed changes the text and not the
amount of work: drawn per seed, they moved the ratio by 7% from seed to
seed.

``build`` is shared with the Silesia generator's source-tar class.
"""

from __future__ import annotations

import bisect

import numpy as np

from . import common

KEYWORDS = [b"\t", b";\n", b"(", b") ", b"{\n", b"}\n\n", b", ", b" = ",
            b"->", b"\t\t", b"return ", b"if (", b"struct ", b"static ",
            b"int ", b"unsigned long ", b"void ", b"const ", b"NULL",
            b" == ", b"0", b"1", b"#include <", b">\n", b"#define ",
            b"/* ", b" */\n", b"[i]", b"else ", b"for (", b"goto out;\n",
            b"u32 ", b"&", b"!", b" + ", b"sizeof(", b"err", b"dev",
            b"break;\n", b"case "]
SYLLABLES = [b"sk", b"buf", b"dev", b"net", b"irq", b"mm", b"page", b"lock",
             b"init", b"get", b"set", b"put", b"free", b"alloc", b"list",
             b"head", b"node", b"queue", b"reg", b"ctl", b"cfg", b"data",
             b"ops", b"drv", b"pci", b"usb", b"fs", b"inode", b"file",
             b"priv", b"hw", b"tx", b"rx", b"len", b"addr", b"map", b"ring",
             b"idx", b"flags", b"state"]
ID_SEPS = [b" ", b"(", b", ", b");\n", b" = ", b"->", b";\n", b")"]
ID_SEP_W = [30, 20, 15, 10, 8, 7, 6, 4]
DIRS = [b"drivers/net", b"fs/ext4", b"mm", b"kernel/sched", b"net/ipv4",
        b"drivers/gpu/drm", b"arch/x86/kernel", b"sound/core",
        b"drivers/usb/core", b"block", b"crypto", b"lib", b"include/linux"]


def warmup(params) -> list:
    return [-1]


def vocabulary(rng: np.random.Generator, n_words: int, s: float, device):
    """Keywords and punctuation at the top ranks, then identifiers of one
    to three syllables joined by ``_``, each with its separator."""
    ids = []
    for _ in range(n_words):
        k = int(rng.integers(1, 4))
        parts = [SYLLABLES[j] for j in rng.integers(0, len(SYLLABLES), k)]
        sep = ID_SEPS[rng.choice(len(ID_SEPS), p=np.array(ID_SEP_W) / sum(
            ID_SEP_W))]
        ids.append(b"_".join(parts) + sep)
    words = []
    for i, w in enumerate(ids):
        if i % 3 == 0 and i // 3 < len(KEYWORDS):
            words.append(KEYWORDS[i // 3])
        words.append(w)
    return common.Vocabulary(words, s, device)


def _header(name: bytes, size: int, mtime: int) -> np.ndarray:
    h = bytearray(512)
    h[0:len(name[:99])] = name[:99]
    h[100:108] = b"0000644\0"
    h[108:116] = b"0001750\0"
    h[116:124] = b"0001750\0"
    h[124:136] = b"%011o\0" % size
    h[136:148] = b"%011o\0" % mtime
    h[148:156] = b" " * 8
    h[156:157] = b"0"
    h[257:265] = b"ustar\x0000"
    h[265:269] = b"user"
    h[297:301] = b"user"
    h[148:156] = b"%06o\0 " % sum(h)
    return np.frombuffer(bytes(h), np.uint8)


def build(params, seed: int, layout_seed: int, index: int, size: int,
          device, tag: str):
    """(tar bytes of exactly ``size``, members (offset, length, copy_of)):
    the layout and the vocabulary from ``layout_seed``, the text from
    ``seed``."""
    rng = common.host_rng(layout_seed, tag, "layout", index)
    gen = common.dev_gen(device, seed, tag, "text", index)
    vocab = vocabulary(common.host_rng(layout_seed, tag, "vocab"),
                       params["vocab_words"], params["zipf_s"], device)
    # the layout first, so that the fresh text is drawn in one call
    lo_e, hi_e = params["edits"]
    lo_l, hi_l = params["edit_len"]
    members, edits, fresh, fresh_at = [], [], [], []
    pos = need = 0
    while True:
        n = int(min(params["file_max"], max(1, rng.lognormal(
            np.log(params["file_median"]), params["file_sigma"]))))
        src = -1
        if rng.random() < params["near_copy_share"]:
            lo = bisect.bisect_left(fresh_at, pos - params["copy_window"])
            if lo < len(fresh):
                src = fresh[int(rng.integers(lo, len(fresh)))]
                n = members[src][1]
        end = pos + 512 + (n + 511) // 512 * 512
        if end + 1024 > size:
            break
        spans = []
        if src < 0:
            fresh.append(len(members))
            fresh_at.append(pos + 512)
            need += n
        else:
            for _ in range(int(rng.integers(lo_e, hi_e + 1))):
                ln = min(n // 32 + 1, int(rng.integers(lo_l, hi_l + 1)))
                spans.append((int(rng.integers(0, n - ln + 1)), ln))
                need += ln
        members.append((pos + 512, n, src))
        edits.append(spans)
        pos = end
    pool = common.to_host(vocab.text(gen, need, device))
    out = np.zeros(size, np.uint8)
    mtime = 1_600_000_000 + int(rng.integers(0, 1 << 24))
    cur = 0
    for i, ((body, n, src), spans) in enumerate(zip(members, edits)):
        name = b"linux/" + DIRS[i % len(DIRS)] + b"/file%05d.c" % i
        out[body - 512:body] = _header(name, n, mtime + i)
        if src < 0:
            out[body:body + n] = pool[cur:cur + n]
            cur += n
            continue
        s0 = members[src][0]
        out[body:body + n] = out[s0:s0 + n]
        for at, ln in spans:
            out[body + at:body + at + ln] = pool[cur:cur + ln]
            cur += ln
    return out, members


def generate(params, seed: int, index: int, device, with_info: bool = False):
    data, members = build(params, seed, 0, index, params["size"], device,
                          "kernel_tar")
    if not with_info:
        return data
    return data, {"members": members}
