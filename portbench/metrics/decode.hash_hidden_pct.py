"""decode.hash_hidden_pct: 100 x (1 - the decompress calling thread's
waits for the archive hash (the ``stats_sink`` ``main_ms`` stage
``decompress.hash_wait``) over the hash thread's busy milliseconds (the
counter ``hash_ms`` of each decompress's last dict)), summed over the
decompress ops: the share of the hash that runs beside the decode.  None
where no decompress dict has the counter (the parent's program, where
the MD5 ran on the calling thread) or the hash took no time (hash code
0)."""


def read(run):
    sel = [s for s in run.stats
           if s.get("op") == "decompress" and "hash_ms" in s]
    busy = sum(s["hash_ms"] for s in sel)
    if busy <= 0:
        return None
    wait = sum(s["main_ms"].get("decompress.hash_wait", 0.0)
               for s in run.stats if s.get("op") == "decompress")
    return 100.0 * (1.0 - wait / busy)
