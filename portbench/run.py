"""Run one cell of the benchmark of lrzip_next_tpu_torch once.

    python3 portbench/run.py --workload rans-L7.vm-1gib --seed 7 \\
        --seconds 10 --trace 0

From the root of a checkout holding ``BENCHMARK.json``, ``portbench/``
and the program.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number the
comparison made beside its limit); the last lines of standard error are
the same comparisons.  With ``--trace 0`` the metrics are the cell's
``end_to_end`` metrics, with ``--trace 1`` its ``per_layer`` ones.

It exits 2, printing no result, where CUDA is missing or has fewer cards
than the cell asks for, and 3 where JAX or the JAX package was loaded.
``--fault NAME`` plants one of ``core/faults.py``'s faults under the
timed path; benchmark runs never pass it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    from portbench.core import cell as cells, runner

    cell = cells.resolve(args.workload, ROOT)
    # a cell sees the first cards it asks for and no others, so that its
    # syncs and peak readings cover its own cards on a larger host
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    visible = visible.split(",") if visible is not None else \
        [str(i) for i in range(cell.chips)]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(visible[:cell.chips])
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} found")
        return 2
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          T_START, device="cuda", fault=args.fault, log=log)
    if out is None:
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
