"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the program."""

import json
import subprocess
import sys

from benchmark.harness import forbidden_modules
from benchmark.spec import BENCH_DIR, ROOT


def loaded_top_levels(*modules: str, readers=()) -> set:
    code = ("import sys, json; sys.path.insert(0, %r)\n" % str(ROOT)
            + "".join(f"import {m}\n" for m in modules)
            + "from benchmark.spec import load_reader\n"
            + "".join(f"load_reader({r!r})\n" for r in readers)
            + "print(json.dumps(sorted({n.split('.', 1)[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    readers = sorted(p.stem for p in (BENCH_DIR / "metrics").glob("*.py"))
    assert "choose_roofline" in readers
    tops = loaded_top_levels("benchmark.run", "benchmark.harness", "benchmark.system", "benchmark.control",
                             "benchmark.readers", readers=readers)
    assert "tpu_scheduler_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "tpu_scheduler"}


def test_reference_loads_nothing_of_the_program():
    tops = loaded_top_levels("benchmark.reference.check", "benchmark.reference.greedy")
    assert not tops & {"jax", "jaxlib", "flax", "tpu_scheduler", "tpu_scheduler_torch"}


def test_forbidden_compares_whole_top_level_names():
    assert forbidden_modules({"tpu_scheduler_torch": 1, "tpu_scheduler_torch.ops": 1, "jaxtyping": 1}) == []
    assert forbidden_modules({"tpu_scheduler.ops": 1, "jax": 1, "flax.linen": 1}) == ["flax.linen", "jax",
                                                                                       "tpu_scheduler.ops"]
