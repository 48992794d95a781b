#!/usr/bin/env python3
"""Count the SASS instructions of the port's CUDA kernels, statically:

    python3 tools/torch_sass_count.py FILE.cu [FILE.cu ...]

Each source is compiled with nvcc for sm_90a (the flags of
``lrzip_next_tpu_torch/ops/_build.py``) into a cubin under a temporary
directory, ``cuobjdump -sass`` disassembles it, and for every kernel the
script prints the number of instructions of each family that bounds the
anchor and compaction kernels: shared loads and stores (LDS, STS), global
loads and stores (LDG, STG), bulk copies (UBLKCP), integer multiply-adds
(IMAD, without the IMAD.MOV and IMAD.SHL forms that the compiler uses as
moves and shifts), integer minima (IMNMX, VIMNMX), byte permutes (PRMT),
barriers (BAR) and all instructions.  The counts are of the code, not of
its execution: a loop body counts once.  Needs nvcc and cuobjdump (the
CUDA toolkit); a card is not needed.
"""

import collections
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FAMILIES = ("LDS", "STS", "LDG", "STG", "UBLKCP", "IMAD", "IMNMX", "PRMT",
            "BAR")


def family(op: str) -> str:
    base = op.split(".")[0]
    if base == "IMAD" and (".MOV" in op or ".SHL" in op):
        return "IMAD(move/shift)"
    if base == "VIMNMX":
        return "IMNMX"
    return base


def main() -> int:
    from lrzip_next_tpu_torch.ops import _build
    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        for src in sys.argv[1:]:
            cubin = Path(tmp) / (Path(src).stem + ".cubin")
            subprocess.run([nvcc, *_build.NVCC_FLAGS, "-cubin", src, "-o",
                            str(cubin)], check=True)
            sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                                  check=True, capture_output=True,
                                  text=True).stdout
            counts, name = {}, None
            for line in sass.splitlines():
                m = re.match(r"\s*Function : (\S+)", line)
                if m:
                    name = m.group(1)
                    counts[name] = collections.Counter()
                    continue
                m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]*)", line)
                if m and name is not None:
                    counts[name][family(m.group(1))] += 1
            for fn, c in counts.items():
                total = sum(c.values())
                print(f"SASS {src} {fn}: " + ", ".join(
                    f"{f} {c[f]}" for f in FAMILIES) +
                    f", IMAD(move/shift) {c['IMAD(move/shift)']}, "
                    f"all {total}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
