"""No run loads JAX or the JAX package, and the reference loads nothing
of the program.  Module names are compared by their top-level part, as
a whole: the program's name begins with the JAX package's."""

import json
import subprocess
import sys
from pathlib import Path

from portbench.core import guard

ROOT = Path(__file__).resolve().parents[2]

RUN_IMPORTS = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.core import cell, runner, check, trace, faults, guard
from portbench.reference import lrz
bench = json.load(open({root!r} + "/BENCHMARK.json"))
for w in bench["workloads"]:
    c = cell.resolve(w["name"])
    c.generator.generate(dict(c.traffic["params"], size=1 << 16)
                         if "size" in c.traffic["params"] else
                         c.traffic["params"], 1, -1, "cpu")
import lrzip_next_tpu_torch as lrzt
a = lrzt.compress(b"abc" * 5000, lrzt.Settings(method="rans"), device="cpu")
assert lrz.decode(a) == b"abc" * 5000
assert lrzt.decompress(a, device="cpu") == b"abc" * 5000
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.reference import lrz
print(json.dumps(sorted(sys.modules)))
"""


def loaded_by(script: str) -> list:
    out = subprocess.run([sys.executable, "-c", script.format(
        root=str(ROOT))], capture_output=True, text=True, timeout=600,
        cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_names_are_compared_by_their_whole_top_level_part():
    mods = {"lrzip_next_tpu_torch": 1, "lrzip_next_tpu_torch.ops": 1,
            "jaxtyping": 1, "numpy": 1}
    assert guard.loaded(modules=mods) == []
    mods.update({"lrzip_next_tpu.ops.matcher": 1, "jax.numpy": 1,
                 "jaxlib": 1, "flax": 1})
    assert guard.loaded(modules=mods) == [
        "flax", "jax.numpy", "jaxlib", "lrzip_next_tpu.ops.matcher"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = loaded_by(RUN_IMPORTS)
    assert "lrzip_next_tpu_torch" in mods and "portbench.reference.lrz" in mods
    assert guard.loaded(modules=dict.fromkeys(mods)) == []


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded_by(REFERENCE_ONLY)
    assert "portbench.reference.lrz" in mods
    assert guard.loaded({"lrzip_next_tpu_torch", "lrzip_next_tpu", "jax",
                         "torch"}, dict.fromkeys(mods)) == []
