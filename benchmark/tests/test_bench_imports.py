"""Nothing the benchmark runs loads JAX, flax or the JAX package (compared
by whole top-level module names: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests._dry import ROOT

FILES = sorted(glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"),
                         recursive=True))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(f, ROOT) for f in FILES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(ROOT, "benchmark", "reference",
                                       "*.py")):
        assert "droid_slam_tpu_torch" not in set(_imports(path)), path
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.reference.tracking, benchmark.reference.backend;"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('droid')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.spec()["workloads"]])
def test_a_run_loads_no_jax(workload):
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark.tests._dry import dry_run;"
            f"dry_run({workload!r});"
            "from benchmark import harness;"
            "print(harness.forbidden_modules())")
    env = dict(os.environ, OMP_NUM_THREADS="4")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
