"""A one-device compile check and a multi-device dry run of the port (the
counterpart of the JAX package's ``__graft_entry__.py``).

``entry`` gives the matcher's anchor step and a seeded 64 KiB chunk;
``dryrun_multichip(n)`` runs the real compress path through a mesh of n
devices (``parallel/mesh.py``) at tiny shapes and holds its archives
against the single-device ones.  ``device`` names the device every mesh
entry stands for (the mesh of ``make_mesh(devices=[device] * n)``), so
the dry run runs on one card or on the CPU.
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np
import torch

from ..device import resolve_device
from ..ops.matcher import anchor_candidates_fporder
from . import mesh as pmesh


def entry(device="cuda"):
    """``(fn, (chunk,))``: ``fn(chunk)`` is the matcher's anchor stage at
    stride 8 (level 7), returning position-ordered ``(pos, cand, ok)``
    (the JAX package's ``anchor_candidates``), and ``chunk`` a seeded
    64 KiB uint8 tensor on ``device``."""
    dev = resolve_device(device)

    def fn(data: torch.Tensor):
        spos, cand = anchor_candidates_fporder(data, 8)
        order = torch.sort(spos, stable=True).indices
        cand = cand[order]
        return spos[order], cand, cand >= 0

    example = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, 1 << 16, dtype=np.uint8)).to(dev)
    return fn, (example,)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Compress a multi-chunk input through the mesh path of
    ``compress_stream`` on a mesh of ``n_devices`` entries of ``device``,
    decode it, and hold the archive against the single-device one: gzip
    and rans (the mesh with the device literal encode) byte for byte,
    ``cross_chunk`` byte for byte, and an encrypted run (whose salt is
    random) by its round trip.  Raises ``AssertionError`` on a
    difference."""
    from ..models.pipeline import Settings, compress_stream, \
        decompress_stream

    dev = resolve_device(device)
    mesh = pmesh.make_mesh(devices=[dev] * n_devices)
    dp = mesh.devices.shape[0]
    csize = 4096
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, csize // 2, dtype=np.uint8).tobytes()
    # dp * 2 + 1 chunks: mirrored halves make long-range matches, and the
    # odd last chunk makes a batch of its own
    data = (base + base) * (dp * 2) + base

    def run(use_mesh: bool, settings: Settings) -> bytes:
        out = io.BytesIO()
        settings = dataclasses.replace(settings, use_mesh=use_mesh)
        if not use_mesh:
            compress_stream(data, out, settings, device=dev)
            return out.getvalue()
        orig, before = pmesh.pipeline_mesh, pmesh.batches
        pmesh.pipeline_mesh = lambda *_: mesh
        try:
            compress_stream(data, out, settings, device=dev)
        finally:
            pmesh.pipeline_mesh = orig
        # two full batches of dp chunks and the odd one
        assert pmesh.batches - before == 3, \
            f"{pmesh.batches - before} mesh batches, not 3"
        return out.getvalue()

    def decoded(archive: bytes, settings: Settings) -> bytes:
        return decompress_stream(io.BytesIO(archive), settings, device=dev)

    for kw in ({"method": "gzip"}, {"method": "rans"},
               {"method": "gzip", "cross_chunk": True}):
        s = Settings(max_chunk=csize, **kw)
        mesh_arch = run(True, s)
        assert mesh_arch == run(False, s), \
            f"mesh archive differs from single-device ({kw})"
        assert decoded(mesh_arch, s) == data, \
            f"mesh archive round-trip failed ({kw})"

    # encrypted archives embed a random salt: equivalence by round trip
    s = Settings(method="gzip", max_chunk=csize, passphrase=b"dryrun-pw")
    for use_mesh in (True, False):
        assert decoded(run(use_mesh, s), s) == data, \
            "mesh encrypted round-trip failed"
