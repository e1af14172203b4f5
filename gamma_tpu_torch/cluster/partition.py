"""Partition server entry points.

A partition server is just `gamma_tpu_torch.server.serve()` owning one engine —
the Vearch "ps" role (reference: vearch ps/ Go service; the engine below
it is this repo's GammaEngine).  Two launch modes:

  * `launch_local(n, base)` — n in-process threaded servers on unix
    sockets (tests / single-host multi-partition);
  * `python -m gamma_tpu_torch.cluster.partition --socket PATH` — a standalone
    process per TPU host (one engine per host; the engine's own mesh
    sharding covers the host's chips, docs/MULTIHOST.md tier 1).
"""

from __future__ import annotations

import argparse
import os
from typing import List

from gamma_tpu_torch.server import serve


class LocalCluster:
    """In-process partition servers for tests and single-host use."""

    def __init__(self, sockets: List[str], servers):
        self.sockets = sockets
        self._servers = servers

    def stop(self, index: int) -> None:
        """Kill one partition server (failure injection)."""
        self._servers[index].stop()

    def stop_all(self) -> None:
        for s in self._servers:
            try:
                s.stop()
            except Exception:       # noqa: BLE001 — best-effort teardown
                pass


def launch_local(n: int, base_dir: str) -> LocalCluster:
    os.makedirs(base_dir, exist_ok=True)
    sockets, servers = [], []
    for i in range(n):
        path = os.path.join(base_dir, f"ps{i}.sock")
        servers.append(serve(path))
        sockets.append(path)
    return LocalCluster(sockets, servers)


def main() -> None:
    ap = argparse.ArgumentParser(description="gamma-tpu partition server")
    ap.add_argument("--socket", help="unix socket path")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args()
    addr = args.socket if args.socket else (args.host, args.port)
    serve(addr, background=False)


if __name__ == "__main__":
    main()
