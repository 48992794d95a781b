"""Seeded building blocks of the corpus generators.

Every stream of random numbers is derived from ``(seed, *parts)`` by
SHA-256, so the same seed and index give the same bytes on one kind of
device, whatever else the run draws.  Layouts (block classes, file
sizes, repeat plans) come from numpy on the host; bulk content (text,
order-1 code, noise) from a ``torch.Generator`` on the run's device, in
pieces of at most ``PIECE`` bytes, so that a 1 GiB input takes well
under a second on the card.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

PIECE = 16 << 20


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for the stream named by ``parts``."""
    text = "/".join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def host_rng(seed: int, *parts) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *parts))


def dev_gen(device, seed: int, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *parts))
    return g


def random_bytes(gen: torch.Generator, n: int, device) -> torch.Tensor:
    return torch.randint(0, 256, (n,), generator=gen, device=device,
                         dtype=torch.uint8)


class Vocabulary:
    """Words packed end to end on the device, each with its separator,
    drawn by rank with Zipf weights ``1 / rank ** s``."""

    def __init__(self, words, s: float, device):
        lens = np.array([len(w) for w in words], np.int64)
        self.mean_len = float((lens / np.arange(1, len(lens) + 1) ** s).sum()
                              / (1.0 / np.arange(1, len(lens) + 1) ** s).sum())
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
        self.bytes = torch.from_numpy(
            np.frombuffer(b"".join(words), np.uint8).copy()).to(device)
        self.lens = torch.from_numpy(lens).to(device)
        self.offs = torch.from_numpy(offs).to(device)
        w = 1.0 / np.arange(1, len(words) + 1, dtype=np.float64) ** s
        self.cdf = torch.from_numpy(np.cumsum(w) / w.sum()).to(device)

    def text(self, gen: torch.Generator, n: int, device) -> torch.Tensor:
        """``n`` bytes of words drawn independently by their weights."""
        out = torch.empty(n, dtype=torch.uint8, device=device)
        done = 0
        while done < n:
            want = min(PIECE, n - done)
            nw = int(want / self.mean_len * 1.2) + 16
            u = torch.rand(nw, generator=gen, device=device,
                           dtype=torch.float64)
            idx = torch.searchsorted(self.cdf, u).clamp_(
                max=self.cdf.shape[0] - 1)
            lens = self.lens[idx]
            ends = torch.cumsum(lens, 0)
            keep = int(torch.searchsorted(ends, torch.tensor(
                [want], device=device)).item()) + 1
            idx, lens, ends = idx[:keep], lens[:keep], ends[:keep]
            word = torch.repeat_interleave(
                torch.arange(keep, device=device), lens)
            within = torch.arange(word.shape[0], device=device) - \
                (ends - lens)[word]
            piece = self.bytes[self.offs[idx][word] + within]
            take = min(want, piece.shape[0])
            out[done:done + take] = piece[:take]
            done += take
        return out


def make_words(rng: np.random.Generator, n: int, alphabet, weights,
               mean_len: float, seps, sep_weights, max_len: int = 16):
    """``n`` distinct-ish words of letters from ``alphabet`` (a list of
    byte strings, so that a letter may be a multi-byte UTF-8 sequence),
    each followed by one of ``seps``."""
    p = np.asarray(weights, np.float64)
    p /= p.sum()
    q = np.asarray(sep_weights, np.float64)
    q /= q.sum()
    lens = np.clip(rng.poisson(mean_len - 1, n) + 1, 1, max_len)
    letters = rng.choice(len(alphabet), size=int(lens.sum()), p=p)
    sep_idx = rng.choice(len(seps), size=n, p=q)
    words, pos = [], 0
    for i, ln in enumerate(lens):
        words.append(b"".join(alphabet[j] for j in letters[pos:pos + ln])
                     + seps[sep_idx[i]])
        pos += ln
    return words


def order1_table(rng: np.random.Generator, s: float = 1.3) -> torch.Tensor:
    """(256, 4096) uint8: row ``prev`` maps a 12-bit slot to the next
    byte.  Each row is a Zipf law over its own permutation of the bytes,
    with extra weight on 0x00, 0xFF and ``prev`` itself, as in machine
    code (padding, immediates, repeated opcodes)."""
    table = np.empty((256, 4096), np.uint8)
    ranks = 1.0 / np.arange(1, 257, dtype=np.float64) ** s
    for prev in range(256):
        p = np.empty(256)
        p[rng.permutation(256)] = ranks
        p[0] += 0.15
        p[255] += 0.05
        p[prev] += 0.05
        counts = np.floor(p / p.sum() * 4096).astype(np.int64)
        counts[np.argmax(p)] += 4096 - counts.sum()
        table[prev] = np.repeat(np.arange(256, dtype=np.uint8), counts)
    return torch.from_numpy(table.reshape(-1))


def order1_bytes(gen: torch.Generator, table: torch.Tensor, chains: int,
                 length: int, device) -> torch.Tensor:
    """(chains, length) uint8: independent order-1 chains from ``table``
    (``order1_table``, on ``device``), each starting after a 0 byte."""
    out = torch.empty((chains, length), dtype=torch.uint8, device=device)
    prev = torch.zeros(chains, dtype=torch.int64, device=device)
    step = 256
    for t0 in range(0, length, step):
        k = min(step, length - t0)
        slots = torch.randint(0, 4096, (k, chains), generator=gen,
                              device=device, dtype=torch.int64)
        for t in range(k):
            nxt = table[prev * 4096 + slots[t]]
            out[:, t0 + t] = nxt
            prev = nxt.to(torch.int64)
    return out


def to_host(t: torch.Tensor) -> np.ndarray:
    """The generated bytes as a host array (the program's input type)."""
    return t.cpu().numpy()
