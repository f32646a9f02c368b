"""Nothing the benchmark runs loads JAX or the JAX package: the check
compares whole top-level names (libhm_tpu_torch begins with libhm_tpu),
a run loads neither, and the benchmark's files import neither, nor the
JAX package's harnesses.  Without the program beside it the benchmark
gives no result."""
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
import harness


def test_whole_name_comparison(monkeypatch):
    import libhm_tpu_torch  # noqa: F401
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "libhm_tpu_torch.fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "libhm_tpu.hostdec", object())
    assert harness.forbidden_modules() == ["libhm_tpu"]
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax", "libhm_tpu"]


RUN_SMALL = r"""
import sys, time
sys.path[:0] = [{bench!r}, {root!r}]
from conftest import small_spec, run_small
import harness
line, _, _ = run_small(small_spec({cell!r}), trace={trace})
assert line["correct"], line
print("FORBIDDEN", harness.forbidden_modules())
print("TOP", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


@pytest.mark.parametrize("cell,trace", [("main10_ra_1080p.batch", 1),
                                        ("main10_intra_1080p.batch", 0)])
def test_a_run_loads_no_jax(cell, trace):
    code = RUN_SMALL.format(bench=os.path.join(BENCH, "tests"), root=ROOT,
                            cell=cell, trace=trace)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert "FORBIDDEN []" in lines
    top = [ln for ln in lines if ln.startswith("TOP")][0]
    assert "'libhm_tpu_torch'" in top and "'libhm_tpu'" not in top


IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|libhm_tpu)\b"
                    r"(?!_)", re.M)


def test_sources_import_no_jax_and_no_old_harness():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py") or f.startswith("test_hevcbench_imports"):
                continue
            src = open(os.path.join(d, f)).read()
            assert not IMPORT.search(src), f
            for old in ("bench_torch", "bench_kernels", "BENCH_r0",
                        "import bench"):
                assert old not in src, (f, old)


def test_no_result_beside_only_the_benchmark(tmp_path):
    """A directory with BENCHMARK.json and hevc_bench alone: no program,
    so a run on the CPU fails before any result, and run.py prints none."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "hevc_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path[:0] = ['hevc_bench', "
            "'hevc_bench/tests']\n"
            "import harness\n"
            "spec = harness.load_cell('.', 'hevc_bench', "
            "'main10_ra_1080p.batch')\n"
            "harness.run_cell(spec, 1, 0.1, False, 'cpu', time.perf_counter())"
            "\nprint('RESULT')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path, timeout=300, env=env)
    assert r.returncode != 0 and "RESULT" not in r.stdout
    assert "libhm_tpu_torch" in r.stderr
    r = subprocess.run([sys.executable, "hevc_bench/run.py", "--workload",
                        "main10_ra_1080p.batch", "--seed", "1", "--seconds",
                        "1"], capture_output=True, text=True, cwd=tmp_path,
                       timeout=300, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""
