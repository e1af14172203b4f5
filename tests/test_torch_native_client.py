"""The C++ client (native/gamma_client.cc) against the port's server:
the twin of tests/test_native_client.py, which holds it against the JAX
package's.  The demo binary creates a table, ingests, searches and
closes over the frame protocol; the engines it creates run on the CPU
(the c_api's module default, set here and put back afterwards)."""

import os
import shutil
import subprocess

import pytest

from gamma_tpu_torch import c_api
from gamma_tpu_torch.server import serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "native", "gamma_client.cc")


@pytest.fixture(scope="module")
def demo_bin(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the C++ client")
    out = str(tmp_path_factory.mktemp("bin") / "gamma_client_demo")
    subprocess.run(["g++", "-O1", "-std=c++17", "-o", out, SRC],
                   check=True)
    return out


@pytest.fixture
def cpu_engines():
    old = c_api.set_default_device("cpu")
    yield
    c_api.set_default_device(old)


def test_cpp_client_end_to_end(demo_bin, cpu_engines, tmp_path):
    sock = str(tmp_path / "ps.sock")
    srv = serve(sock)
    try:
        proc = subprocess.run(
            [demo_bin, sock, str(tmp_path / "engine")],
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "OK" in proc.stdout
    finally:
        srv.stop()
