#!/usr/bin/env python3
"""Host-clock seconds of the port's ``-U`` cross-window index on one
64 MiB window, on its host path (without a card; on a card K11 gives
each window's anchor set, timed by ``chip_smoke.py``'s ``check_k11``):

    python3 tools/torch_unlimited_index_profile.py [--mib 256]

The input is ``chip_smoke.long_range_corpus`` of ``--mib`` MiB (made from
its seeds); the window is 64 MiB.  Prints the seconds of
``gear_anchor_positions`` on the second window, of ``add_chunk`` on the
first, and of ``find_cross_matches`` of the second against the first,
with the matches found.  Host code only: it needs no card.
"""

import argparse
import os
import sys
import time

MIB = 1 << 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=256)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from chip_smoke import long_range_corpus
    from lrzip_next_tpu_torch.models import crosschunk as X
    big = long_range_corpus(args.mib * MIB)
    win = 64 * MIB
    t0 = time.perf_counter()
    X.gear_anchor_positions(big[win:2 * win])
    t_gear = time.perf_counter() - t0
    index = X.CrossChunkIndex()
    t0 = time.perf_counter()
    index.add_chunk(big[:win], 0)
    t_add = time.perf_counter() - t0
    t0 = time.perf_counter()
    cross = X.find_cross_matches(big, index, win, win, len(big))
    t_find = time.perf_counter() - t0
    print(f"-U host index, one 64 MiB window of {args.mib} MiB: gear "
          f"anchors {t_gear:.3f} s, add_chunk {t_add:.3f} s, "
          f"find_cross_matches {t_find:.3f} s ({len(cross)} matches, "
          f"{sum(c[1] for c in cross)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
