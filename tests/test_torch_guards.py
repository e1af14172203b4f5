"""Guards on the port's boundaries.

  * gamma_tpu_torch imports with jax, gamma_tpu and experiments/
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
    """IVFPQ, IVFPQ_FASTSCAN, IVFFLAT, FLAT, SCANN (also as VEARCH) and
    BINARYIVF are registered; HNSW, not ported yet, raises KeyError with
    the list of known names."""
    from gamma_tpu_torch.index import create_model, model_names
    assert sorted(model_names()) == ["BINARYIVF", "FLAT", "IVFFLAT",
                                     "IVFPQ", "IVFPQ_FASTSCAN", "SCANN",
                                     "VEARCH"]
    with pytest.raises(KeyError, match="IVFPQ_FASTSCAN"):
        create_model("HNSW", None, {})


@pytest.mark.parametrize("module", [
    "gamma_tpu_torch.faisslike", "gamma_tpu_torch.index.ivfflat",
    "gamma_tpu_torch.index.flat", "gamma_tpu_torch.convert",
    "gamma_tpu_torch.index.scann", "gamma_tpu_torch.index.binary_ivf",
    "gamma_tpu_torch.ops.avq", "gamma_tpu_torch.vector.raw_store"])
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
