"""K11: a window's content-defined anchors and their fingerprints.

``gear_anchors(data, n, gear, mask_bits)`` returns ``(pos, fps, count)``:
every position j with 8 <= j < n - 32 where the low ``mask_bits`` bits of
the gear hash ``g[j] = sum_{k<8} gear[data[j-1-k]] << k`` are all set, in
ascending order, as int32 in the first ``count`` slots of ``pos``; the
32-byte tree-hash fingerprint at each (``crosschunk.window_hashes_at``'s
``(a << 32) | b``) as int64 bit patterns in ``fps``; and ``count`` as a
0-dim int32 tensor, all on ``data``'s device.  Slots from ``count`` on
are unspecified; ``pos`` and ``fps`` have room for every position
(``max(n - 40, 0)``), since a window of one repeated byte can make each
one an anchor.  Only ``data[:n]`` is read: padding past ``n`` makes no
anchor.

A CUDA tensor launches ``csrc/gear_anchors.cu`` (one launch after one
``cudaMemsetAsync`` of its workspace, on the current stream; nothing for
``n <= 40``); a CPU tensor runs ``gear_anchors_reference``, the same
arithmetic in plain PyTorch (the gear sums in the table's low 32-bit
words, which give the low ``mask_bits <= 32`` bits exactly).
``read_anchors`` brings the result to the host: the count first, then
that many entries, through pinned buffers.

Counterpart of the JAX package's numpy scan
(``lrzip_next_tpu/models/crosschunk.py`` ``gear_anchor_positions`` and
``window_hashes_at``); no ``pallas_call`` computes it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .anchor import HASH_W, _M1, _U32, _mul_u32

# the second tree hash's multipliers (crosschunk.window_hashes_at)
_M2 = (0xD1B54A33, 0xABC98389, 0x8CB92BA7, 0x2545F491, 0x9E377F4B)
_LOW = 8    # the first position with 8 bytes before it

launches = 0


def _capacity(n: int) -> int:
    return max(n - HASH_W - _LOW, 0)


def _check(data: torch.Tensor, n: int, gear: np.ndarray,
           mask_bits: int) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise TypeError(f"gear_anchors takes a 1-D uint8 tensor, got "
                        f"{data.dtype} {tuple(data.shape)}")
    if not data.is_contiguous():
        raise ValueError("gear_anchors needs a contiguous tensor")
    if not 0 <= n <= data.shape[0] or n >= 1 << 31:
        raise ValueError(f"gear_anchors: n={n} for {data.shape[0]} bytes "
                         "(the kernel takes fewer than 2**31)")
    if gear.shape != (256,):
        raise ValueError(f"gear_anchors: a table of 256 entries, got "
                         f"{gear.shape}")
    if not 1 <= mask_bits <= 32:
        raise ValueError(f"gear_anchors: mask_bits {mask_bits} not in 1..32")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gear_anchors: unsupported device {data.device}")


def _tree_hash(cols: torch.Tensor, mults) -> torch.Tensor:
    """The 5-level 32-bit tree hash of each row of 32 bytes (int64)."""
    a = cols
    for k in range(5):
        half = 1 << k
        a = (_mul_u32(a[:, :-half], mults[k]) + a[:, half:]) & _U32
    return a[:, 0]


def gear_anchors_reference(data: torch.Tensor, n: int, gear: np.ndarray,
                           mask_bits: int):
    """Plain PyTorch K11 with the kernel's output contract."""
    cap = _capacity(n)
    pos = torch.zeros(cap, dtype=torch.int32, device=data.device)
    fps = torch.zeros(cap, dtype=torch.int64, device=data.device)
    if cap == 0:
        return pos, fps, torch.zeros((), dtype=torch.int32,
                                     device=data.device)
    lo = torch.from_numpy((gear & np.uint64(_U32)).astype(np.int64)) \
        .to(data.device)
    b = data[:n].to(torch.int64)
    j = torch.arange(_LOW, n - HASH_W, device=data.device)
    g = torch.zeros(cap, dtype=torch.int64, device=data.device)
    for k in range(8):
        g += lo[b[j - 1 - k]] << k
    mask = (1 << mask_bits) - 1
    hit = j[(g & mask) == mask]
    k = hit.shape[0]
    cols = b[hit[:, None] + torch.arange(HASH_W, device=data.device)]
    a, c = _tree_hash(cols, _M1), _tree_hash(cols, _M2)
    # (a << 32) | c as an int64 bit pattern: a's top bit is the sign
    a = torch.where(a >= 1 << 31, a - (1 << 32), a)
    pos[:k] = hit.to(torch.int32)
    fps[:k] = (a << 32) | c
    return pos, fps, torch.tensor(k, dtype=torch.int32, device=data.device)


def gear_anchors(data: torch.Tensor, n: int, gear: np.ndarray,
                 mask_bits: int):
    """K11 on the tensor's own device (see the module docstring)."""
    global launches
    _check(data, n, gear, mask_bits)
    if data.device.type == "cpu":
        return gear_anchors_reference(data, n, gear, mask_bits)
    dev = data.device
    cap = _capacity(n)
    pos = torch.empty(cap, dtype=torch.int32, device=dev)
    fps = torch.empty(cap, dtype=torch.int64, device=dev)
    if cap == 0:
        return pos, fps, torch.zeros((), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    lib = _build.library()
    lo = np.ascontiguousarray(gear & np.uint64(_U32), dtype=np.uint32)
    # freed on return, maybe before the kernel ends: the caching allocator
    # hands the block only to work queued after it on this stream
    ws = torch.empty(lib.lrzt_gear_anchors_slots(n), dtype=torch.int64,
                     device=dev)
    _build.check(lib.lrzt_gear_anchors(
        data.data_ptr(), n, mask_bits, lo.ctypes.data, ws.data_ptr(),
        ws.shape[0], pos.data_ptr(), fps.data_ptr(), count.data_ptr(),
        _build.stream_ptr(dev)), "gear_anchors")
    with _build.count_lock:
        launches += 1
    return pos, fps, count


def read_anchors(pos: torch.Tensor, fps: torch.Tensor, count: torch.Tensor):
    """``gear_anchors``' result on the host: (positions as int64,
    fingerprints as uint64) numpy arrays.  On CUDA the count comes back
    first, then that many entries of each, through pinned buffers, on
    the current stream of their device."""
    if pos.device.type == "cpu":
        k = int(count)
        return (pos[:k].numpy().astype(np.int64),
                fps[:k].numpy().view(np.uint64).copy())
    stream = torch.cuda.current_stream(pos.device)
    host = torch.empty((), dtype=torch.int32, pin_memory=True)
    host.copy_(count, non_blocking=True)
    stream.synchronize()
    k = int(host)
    hp = torch.empty(k, dtype=torch.int32, pin_memory=True)
    hf = torch.empty(k, dtype=torch.int64, pin_memory=True)
    if k:
        hp.copy_(pos[:k], non_blocking=True)
        hf.copy_(fps[:k], non_blocking=True)
        stream.synchronize()
    return hp.numpy().astype(np.int64), hf.numpy().view(np.uint64).copy()
