"""Live partition migration.

Reference: storage/migrate_data.{h,cc} — a snapshot cursor over
[0, max_docid) plus a file-backed incremental queue of add/update/delete
docids, so a partition can stream to another node while writes continue
(driven through BeginMigrate / GetMigrageDoc / TerminateMigrate,
c_api/gamma_api.h:194-206).
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Iterator, List, Tuple


class MigrateData:
    _REC = struct.Struct("<qb")   # docid, is_delete

    def __init__(self, root: str, snapshot_end: int):
        self.snapshot_end = snapshot_end
        self.cursor = 0
        self._lock = threading.Lock()
        self._path = os.path.join(root, "migrate.queue")
        self._wf = open(self._path, "wb")
        self._rf = open(self._path, "rb")

    # ---- writer side (hooked into engine ingest) ----

    def add_doc(self, docid: int) -> None:
        self._append(docid, False)

    def update_doc(self, docid: int) -> None:
        self._append(docid, False)

    def delete_doc(self, docid: int) -> None:
        self._append(docid, True)

    def _append(self, docid: int, is_delete: bool) -> None:
        with self._lock:
            self._wf.write(self._REC.pack(docid, 1 if is_delete else 0))
            self._wf.flush()

    # ---- reader side ----

    def next_batch(self, n: int) -> List[Tuple[int, bool]]:
        """Snapshot docids first, then incremental records."""
        out: List[Tuple[int, bool]] = []
        while self.cursor < self.snapshot_end and len(out) < n:
            out.append((self.cursor, False))
            self.cursor += 1
        while len(out) < n:
            rec = self._rf.read(self._REC.size)
            if len(rec) < self._REC.size:
                break
            docid, is_del = self._REC.unpack(rec)
            out.append((int(docid), bool(is_del)))
        return out

    def close(self) -> None:
        self._wf.close()
        self._rf.close()
        if os.path.exists(self._path):
            os.remove(self._path)
