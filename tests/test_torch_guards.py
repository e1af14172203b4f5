"""Guards on the port's boundaries.

  * gamma_tpu_torch, tools/perf_torch.py run whole, and
    tools/x1_ab_torch.py import with jax, gamma_tpu and experiments/
    unavailable (the machine with the card has no JAX);
  * the host-only modules it copies from gamma_tpu stay identical to
    their originals apart from the package name in imports;
  * chip_smoke.py refuses to report without a card or outside a
    checkout of the repository."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# modules carried over verbatim (package name in imports aside)
COPIED = [
    "version.py", "config.py", "batcher.py",
    "api/__init__.py", "api/doc.py", "api/request.py", "api/response.py",
    "api/status.py",
    "utils/__init__.py", "utils/bitmap.py", "utils/fileio.py",
    "utils/growth.py", "utils/log.py", "utils/perf.py", "utils/lru.py",
    "table/__init__.py", "table/table.py",
    "native/__init__.py",
    "storage/__init__.py", "storage/migrate.py", "storage/native_backend.py",
    "realtime/__init__.py", "vector/__init__.py",
    "index/registry.py",
    "idl/__init__.py", "idl/wire.py", "utils/datasets.py", "server.py",
    "cluster/__init__.py", "cluster/router.py", "cluster/partition.py",
]


def _run(code, cwd=REPO, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gamma_tpu'] = None\n"
        "sys.modules['experiments'] = None\n"
        "import gamma_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'gamma_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'gamma_tpu', 'experiments') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = _run(code)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_original(rel):
    with open(os.path.join(REPO, "gamma_tpu_torch", rel)) as f:
        port = f.read().replace("gamma_tpu_torch", "gamma_tpu")
    with open(os.path.join(REPO, "gamma_tpu", rel)) as f:
        assert port == f.read(), f"{rel} drifted from gamma_tpu/{rel}"


def test_only_ivfpq_registered():
    """The seven models of the JAX package are registered (SCANN also as
    VEARCH), under the same names; any other name raises KeyError with
    the list of known names."""
    from gamma_tpu.index import model_names as jax_model_names
    from gamma_tpu_torch.index import create_model, model_names
    assert sorted(model_names()) == ["BINARYIVF", "FLAT", "HNSW",
                                     "IVFFLAT", "IVFPQ", "IVFPQ_FASTSCAN",
                                     "SCANN", "VEARCH"]
    assert sorted(model_names()) == sorted(jax_model_names())
    with pytest.raises(KeyError, match="IVFPQ_FASTSCAN"):
        create_model("NSG", None, {})


@pytest.mark.parametrize("module", [
    "gamma_tpu_torch.faisslike", "gamma_tpu_torch.index.ivfflat",
    "gamma_tpu_torch.index.flat", "gamma_tpu_torch.convert",
    "gamma_tpu_torch.index.scann", "gamma_tpu_torch.index.binary_ivf",
    "gamma_tpu_torch.ops.avq", "gamma_tpu_torch.vector.raw_store",
    "gamma_tpu_torch.index.hnsw", "gamma_tpu_torch.c_api",
    "gamma_tpu_torch.idl.wire", "gamma_tpu_torch.server",
    "gamma_tpu_torch.cluster", "gamma_tpu_torch.parallel"])
def test_module_imports_without_jax(module):
    """Each of these modules alone, with jax, gamma_tpu and
    experiments/ blocked: it is found, imports, and pulls in none of
    them."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'gamma_tpu', 'experiments'):\n"
        "    sys.modules[m] = None\n"
        f"mod = importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'gamma_tpu', 'experiments') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = _run(code)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_perf_tool_runs_without_jax(tmp_path):
    """tools/perf_torch.py imported and run whole (on the CPU, at a tiny
    size) with jax, gamma_tpu and experiments/ blocked: it pulls in
    none of them."""
    code = (
        "import sys\n"
        "for m in ('jax', 'gamma_tpu', 'experiments'):\n"
        "    sys.modules[m] = None\n"
        "sys.path.insert(0, 'tools')\n"
        "import perf_torch\n"
        "perf_torch.main(['--n', '2048', '--d', '16', '--nq', '16', "
        f"'--device', 'cpu', '--path', {str(tmp_path / 'eng')!r}])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'gamma_tpu', 'experiments') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok", out.stdout


def test_chip_smoke_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_without_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path is moot")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_x1_ab_tool_refuses_without_card():
    """tools/x1_ab_torch.py with jax, gamma_tpu and experiments/ blocked
    and no card: it pulls in none of them and exits with its message
    before it builds or times anything."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path is moot")
    code = (
        "import sys, runpy\n"
        "for m in ('jax', 'gamma_tpu', 'experiments'):\n"
        "    sys.modules[m] = None\n"
        "sys.argv = ['x1_ab_torch.py', '--other', '.']\n"
        "try:\n"
        "    runpy.run_path('tools/x1_ab_torch.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print(e.code)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'gamma_tpu', 'experiments') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "x1_ab_torch: no CUDA device", out.stdout
