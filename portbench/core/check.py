"""The comparison that decides ``correct``.

Every number compared is a count of files or chunks that break a
guarantee the configuration states, so each limit is 0 (an exact
comparison):

- ``failed_ops``: operations of the window that raised;
- ``roundtrip_bad_files``: files whose decompressed bytes, returned by
  the timed ``decompress_stream``, differ from the benchmark's input
  (cells that decompress; every file of the window);
- ``reference_bad_chunks``: chunks that the plain reference
  (``reference/lrz.py``) does not decode to the input's bytes, over a
  sample of the window's archives drawn from the seed (``plan``), and the
  largest file of the window where the traffic asks for it;
- ``reference_bad_hashes``: sampled archives whose stored MD5 is not the
  MD5 of their input (``hashlib``);
- ``same_archive_bad_files``: where the configuration states
  ``same_archive_as`` (the mesh), sampled inputs whose archive differs
  from the one the program writes with those settings (one card).

The reference reads only the archive and the benchmark's own input.
"""

from __future__ import annotations

import time

from portbench.corpus import common
from portbench.reference import lrz


def plan(seed: int, n_files: int, spec: dict) -> set:
    """Indices of the files the reference will decode, drawn from the
    seed before the window, so that the run keeps only their bytes."""
    rng = common.host_rng(seed, "check.sample", n_files)
    k = min(spec.get("files", 1), n_files)
    return {int(i) for i in rng.choice(n_files, size=k, replace=False)}


def reference(picked, seed: int, spec: dict):
    """(bad chunks, bad hashes, chunks decoded) over the sampled files."""
    bad_chunks = bad_hashes = decoded = 0
    for r in picked:
        data = memoryview(r.data)
        try:
            magic = lrz.read_magic(r.archive)
            chunks = lrz.read_chunks(r.archive, magic.header_len)
        except (lrz.Corrupt, IndexError) as e:
            r.note = f"archive unreadable: {e}"
            bad_chunks += 1
            bad_hashes += 1
            continue
        if lrz.stored_hash(r.archive, chunks, magic) != lrz.md5(data) or \
                magic.size != len(data):
            bad_hashes += 1
        rng = common.host_rng(seed, "check.chunks", r.index)
        n = min(spec.get("chunks_per_file", 1), len(chunks))
        starts, p = [], 0
        for c in chunks:
            starts.append(p)
            p += c.size
        if p != len(data):
            bad_chunks += 1
        for ci in sorted(rng.choice(len(chunks), size=n, replace=False)):
            c = chunks[ci]
            try:
                got = lrz.decode_chunk(r.archive, c, magic)
            except (lrz.Corrupt, IndexError, ValueError) as e:
                r.note = f"chunk {ci}: {e}"
                got = None
            decoded += 1
            if got != data[starts[ci]:starts[ci] + c.size]:
                bad_chunks += 1
    return bad_chunks, bad_hashes, decoded


def compare(cell, records, seed: int, program, log) -> list:
    """[(name, value, limit)] of the run; also logs each line."""
    t0 = time.perf_counter()
    spec = cell.traffic.get("reference_sample", {})
    checks = [("failed_ops", sum(r.failed for r in records), 0)]
    if "decompress" in cell.traffic["ops"]:
        checks.append(("roundtrip_bad_files",
                       sum(r.roundtrip_ok is False for r in records), 0))
    picked = [r for r in records if r.kept and r.archive is not None]
    bad_chunks, bad_hashes, decoded = reference(picked, seed, spec)
    checks += [("reference_bad_chunks", bad_chunks, 0),
               ("reference_bad_hashes", bad_hashes, 0)]
    same = cell.config.get("same_archive_as")
    if same is not None and picked:
        r = picked[0]
        witness = program.with_settings(**same).compress(r.data)
        checks.append(("same_archive_bad_files",
                       int(witness != r.archive), 0))
    log(f"reference: {len(picked)} archives, {decoded} chunks decoded in "
        f"{time.perf_counter() - t0:.3f} s")
    for r in picked:
        if getattr(r, "note", None):
            log(f"file {r.index}: {r.note}")
    return checks
