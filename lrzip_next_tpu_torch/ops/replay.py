"""Token replay by pointer doubling, in plain PyTorch.

Port of ``expand_tokens`` and ``resolve_bytes`` of
``lrzip_next_tpu/ops/replay.py`` (plain XLA there, no kernel): the replay
of a chunk whose tokens the native runtime could not flatten into a
piece plan (byte-RLE chains: a match far longer than its distance).

1. Every output byte gets a source index: itself for a literal byte,
   ``i - dist`` for a match byte.
2. ``src = src[src]`` until nothing changes: every chain ends at a
   literal byte after O(log chain) gathers.

The JAX package's flat-plan paths of that module (``_replay_copy``,
``expand_flat``, ``gather_by_sort``) stand in for gathers that its
machine lacks; here every flat plan goes through ``ops/replay_ragged``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def expand_tokens(lengths: torch.Tensor, is_match: torch.Tensor,
                  dists: torch.Tensor, lit_base: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-byte (src, lit_idx) maps from columnar tokens, all (T,) int64
    but the bool ``is_match``; ``lit_base`` is each token's offset in the
    literal stream.  ``src[i]`` is i for a literal byte and ``i - dist``
    for a match byte; ``lit_idx[i]`` the literal-stream index of a
    literal byte (else 0)."""
    t = lengths.shape[0]
    seg = torch.repeat_interleave(
        torch.arange(t, device=lengths.device), lengths)
    starts = torch.cumsum(lengths, 0) - lengths
    pos = torch.arange(seg.shape[0], device=lengths.device)
    m = is_match[seg]
    src = torch.where(m, pos - dists[seg], pos)
    lit_idx = torch.where(m, 0, lit_base[seg] + pos - starts[seg])
    return src, lit_idx


def resolve_bytes(src: torch.Tensor, lit_idx: torch.Tensor,
                  literals: torch.Tensor) -> torch.Tensor:
    """Pointer-double ``src`` to its literal roots, then gather the
    literal values."""
    while True:
        nxt = src[src]
        if torch.equal(nxt, src):
            break
        src = nxt
    return literals[lit_idx[src]]
