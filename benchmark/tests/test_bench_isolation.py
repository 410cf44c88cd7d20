"""Nothing the benchmark loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``vulkansift_tpu`` (compared whole: the port's name begins with
the JAX package's), and the reference loads nothing of the program."""

import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

PROBE = """
import sys
sys.path[:0] = [{bench!r}, {repo!r}]
{imports}
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {{"jax", "jaxlib", "flax", "vulkansift_tpu",
                      "vulkansift_tpu_torch"}}))
"""


def _loaded(imports: str) -> str:
    code = PROBE.format(bench=str(BENCH), repo=str(BENCH.parent),
                        imports=imports)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, check=True, timeout=120).stdout.strip()


def test_reference_loads_nothing_of_the_program():
    assert _loaded("import reference.sift, reference.match, yardstick.check, "
                   "yardstick.images, yardstick.traffic, yardstick.roofline"
                   ) == "[]"


def test_harness_loads_the_port_and_no_jax():
    assert _loaded("import run, readings, yardstick.loop, yardstick.trace, "
                   "yardstick.spec\nimport vulkansift_tpu_torch"
                   ) == "['vulkansift_tpu_torch']"


def test_a_run_loads_no_jax(tiny):
    import run as bench_run
    bench_run.measure(**tiny("oxford640-pairs"), seed=3, seconds=1,
                      trace=False, device="cpu")
    assert bench_run.forbidden_modules() == []
