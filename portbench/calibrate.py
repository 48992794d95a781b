"""The archive share of a configuration on a traffic mix's inputs.

    python3 portbench/calibrate.py --config lzma-L7 --traffic vm-1gib \\
        --seed 7 --files 1

Generates ``--files`` inputs of the mix as a run of a cell does (input
``i`` from ``(seed, i)``), compresses each with the settings of
``portbench/configs/<config>.json`` and prints one JSON line: the bytes
in, the archive bytes and the archive's share of the input in percent,
per file and summed.  A traffic file's ``calibration`` says which of its
parameters was set with it, against which published number.  On a card
where CUDA is available, else on the CPU.
"""

import argparse
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--files", type=int, default=1)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch
    import lrzip_next_tpu_torch as lrzt
    from lrzip_next_tpu_torch.models.pipeline import Settings
    from portbench.core import cell as cells, guard

    config = json.loads((ROOT / "portbench" / "configs" /
                         f"{args.config}.json").read_text())
    traffic = cells.load_traffic(ROOT, args.traffic)
    gen = cells.load_generator(ROOT, traffic["generator"])
    device = "cuda" if torch.cuda.is_available() else "cpu"
    settings = Settings(**config["settings"])
    files = []
    for i in range(args.files):
        data = gen.generate(traffic["params"], args.seed, i,
                            "cuda:0" if device == "cuda" else "cpu")
        t0 = time.perf_counter()
        out = io.BytesIO()
        lrzt.compress_stream(data, out, settings, device=device)
        files.append({"index": i, "bytes_in": len(data),
                      "archive_bytes": out.tell(),
                      "seconds": time.perf_counter() - t0})
    found = guard.loaded()
    if found:
        print("refused: loaded " + ", ".join(found), file=sys.stderr)
        return 3
    total_in = sum(f["bytes_in"] for f in files)
    total_out = sum(f["archive_bytes"] for f in files)
    print(json.dumps({
        "config": args.config, "traffic": args.traffic, "seed": args.seed,
        "device": torch.cuda.get_device_name(0) if device == "cuda"
        else "cpu", "files": files, "bytes_in": total_in,
        "archive_bytes": total_out,
        "share_pct": 100.0 * total_out / total_in}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
