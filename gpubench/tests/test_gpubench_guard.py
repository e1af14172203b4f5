"""Nothing the benchmark runs imports jax or gamma_tpu, and the plain
reference imports nothing of gamma_tpu_torch (top-level module names,
compared whole: gamma_tpu_torch's name begins with gamma_tpu's)."""

import ast
import glob
import json
import os
import subprocess
import sys

from conftest import BENCH, ROOT

JAX = {"jax", "jaxlib", "flax", "gamma_tpu"}

DRY_RUN = r"""
import glob, json, os, sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import make_root
import gpubench
for p in sorted(glob.glob(os.path.join({bench!r}, "*.py"))
                + glob.glob(os.path.join({bench!r}, "reference", "*.py"))):
    rel = os.path.relpath(p, {root!r})[:-3].replace(os.sep, ".")
    if not rel.endswith("__init__"):
        __import__(rel)
from gpubench import harness, spec
root = make_root({tmp!r})
bd = os.path.join(root, "gpubench")
for name in sorted(glob.glob(os.path.join(bd, "metrics", "*.py"))):
    spec.load_reader(bd, os.path.basename(name)[:-3])
cell = spec.load_cell("tiny-pq-bulk", root, os.path.join(root, "gpubench"))
out = harness.run_cell(cell, 5, 0.5, True, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_after_a_dry_run(tmp_path):
    code = DRY_RUN.format(root=ROOT, tests=os.path.dirname(__file__),
                          bench=BENCH, tmp=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "gpubench" in top and "gamma_tpu_torch" in top
    assert not top & JAX, top & JAX


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import gpubench.reference.exact\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    top = set(eval(p.stdout.strip()))
    assert not top & (JAX | {"gamma_tpu_torch"})
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in JAX | {"gamma_tpu_torch",
                                                     "gpubench"}, (path, n)
