"""GammaRouter: key-hash partitioning + scatter/gather search merge.

Reference: Vearch's router service — hash(doc key) → partition, write
fan-out to every replica, search fan-out to one healthy replica per
partition with a score merge of the per-partition top-k (the same merge
gamma itself does across multi-GPU shards, gpu.cc:588-640).

Failure model (docs/MULTIHOST.md): replicas of a partition are full
engines fed the same write stream; a replica that errors is marked dead
and excluded from reads until `recover_replica` re-clones it from a
healthy sibling's dump.  Masters (metadata quorum) are out of scope —
the partition map lives in the router, as in a single-router deployment.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import shutil
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from gamma_tpu_torch.api.doc import Doc
from gamma_tpu_torch.api.request import Request
from gamma_tpu_torch.api.response import (Response, ResultItem, SearchResult,
                                    SearchResultCode)
from gamma_tpu_torch.server import GammaClient
from gamma_tpu_torch.utils.log import get_logger


@dataclasses.dataclass
class PartitionSpec:
    """One partition: replica addresses (unix path or (host, port))."""
    replicas: List[Any]
    alive: List[bool] = dataclasses.field(default_factory=list)
    # writes (docs + deletes) a dead replica has MISSED since it died —
    # the divergence window is explicit until recover_replica zeroes it
    lag: List[int] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.alive:
            self.alive = [True] * len(self.replicas)
        if not self.lag:
            self.lag = [0] * len(self.replicas)


class RouterError(RuntimeError):
    pass


class GammaRouter:
    def __init__(self, partitions: Sequence[Any], *, metric: str = "l2",
                 max_fanout_threads: int = 16):
        """`partitions`: one entry per partition — an address, or a list
        of replica addresses.  `metric` decides merge order ("l2": lower
        score better; "ip": higher better)."""
        self.partitions: List[PartitionSpec] = [
            PartitionSpec(list(p) if isinstance(p, (list, tuple))
                          and not self._is_addr(p) else [p])
            for p in partitions]
        self.metric = metric
        self.log = get_logger()
        self._clients: Dict[Any, GammaClient] = {}
        self._pool = cf.ThreadPoolExecutor(max_workers=max_fanout_threads)

    @staticmethod
    def _is_addr(p) -> bool:
        """("host", port) tuples are single addresses, not replica lists."""
        return (isinstance(p, (list, tuple)) and len(p) == 2
                and isinstance(p[0], str) and isinstance(p[1], int))

    # ---- connections ----
    # one client per REPLICA, keyed (partition, replica): the frame
    # protocol binds one engine handle per connection, so two replicas on
    # the same server need separate connections

    def _client(self, pi: int, ri: int) -> GammaClient:
        key = (pi, ri)
        cli = self._clients.get(key)
        if cli is None:
            cli = GammaClient(self.partitions[pi].replicas[ri])
            self._clients[key] = cli
        return cli

    def _drop_client(self, pi: int, ri: int) -> None:
        cli = self._clients.pop((pi, ri), None)
        if cli is not None:
            try:
                cli._sock.close()
            except OSError:
                pass

    def _mark_dead(self, pi: int, ri: int) -> None:
        spec = self.partitions[pi]
        spec.alive[ri] = False
        self._drop_client(pi, ri)
        self.log.warning("router: partition %d replica %d marked dead",
                         pi, ri)

    # ---- partitioning ----

    def partition_of(self, key: Any) -> int:
        return zlib.crc32(str(key).encode()) % len(self.partitions)

    # ---- bootstrap ----

    def bootstrap(self, configs: Sequence[Sequence[Any]], table_info
                  ) -> None:
        """Init every replica engine with its config and create the table
        (deployments that pre-provision engines can skip this)."""
        for pi, spec in enumerate(self.partitions):
            for ri, addr in enumerate(spec.replicas):
                cli = self._client(pi, ri)
                if cli.init(configs[pi][ri]) != 0:
                    raise RouterError(f"init failed p{pi} r{ri}")
                if cli.create_table(table_info) != 0:
                    raise RouterError(f"create_table failed p{pi} r{ri}")

    # ---- writes: fan to every live replica of the owner partition ----

    def add_or_update_docs(self, docs: Sequence[Doc]) -> List[int]:
        groups: Dict[int, List[Tuple[int, Doc]]] = {}
        for i, doc in enumerate(docs):
            groups.setdefault(self.partition_of(doc.key), []).append(
                (i, doc))
        codes = [0] * len(docs)

        def send(pi: int, batch: List[Tuple[int, Doc]]):
            # ack semantics: success if ANY replica took the write (no
            # write-quorum — Vearch acks the same way and re-syncs via
            # partition recovery); replicas that errored are marked dead
            # and their missed-write count accrues in spec.lag until
            # recover_replica re-clones them
            spec = self.partitions[pi]
            payload = [d for _, d in batch]
            got = None
            for ri in range(len(spec.replicas)):
                if not spec.alive[ri]:
                    spec.lag[ri] += len(payload)
                    continue
                try:
                    got = self._client(pi, ri).add_or_update_docs(payload)
                except (OSError, RuntimeError):
                    self._mark_dead(pi, ri)
                    spec.lag[ri] += len(payload)
            if got is None:
                raise RouterError(f"partition {pi}: no live replica")
            for (i, _), c in zip(batch, got):
                codes[i] = c

        futs = [self._pool.submit(send, pi, batch)
                for pi, batch in groups.items()]
        for f in futs:
            f.result()
        return codes

    def delete(self, key: Any) -> int:
        pi = self.partition_of(key)
        spec = self.partitions[pi]
        status = -1
        for ri in range(len(spec.replicas)):
            if not spec.alive[ri]:
                spec.lag[ri] += 1
                continue
            try:
                status = self._client(pi, ri).delete(key)
            except (OSError, RuntimeError):
                self._mark_dead(pi, ri)
                spec.lag[ri] += 1
        return status

    def del_doc_by_query(self, request: Request) -> int:
        total = 0
        for pi, spec in enumerate(self.partitions):
            got = None
            for ri in range(len(spec.replicas)):
                if not spec.alive[ri]:
                    continue
                try:
                    got = self._client(pi, ri).del_doc_by_query(request)
                except (OSError, RuntimeError):
                    self._mark_dead(pi, ri)
            if got is not None and got > 0:
                total += got
        return total

    # ---- reads ----

    def get_doc(self, key: Any) -> Optional[Doc]:
        pi = self.partition_of(key)
        spec = self.partitions[pi]
        for ri in range(len(spec.replicas)):
            if not spec.alive[ri]:
                continue
            try:
                return self._client(pi, ri).get_doc(key)
            except (OSError, RuntimeError):
                self._mark_dead(pi, ri)
        raise RouterError(f"partition {pi}: no live replica")

    def _one_partition_search(self, pi: int, request: Request
                              ) -> Response:
        spec = self.partitions[pi]
        for ri in range(len(spec.replicas)):
            if not spec.alive[ri]:
                continue
            try:
                return self._client(pi, ri).search(request)
            except (OSError, RuntimeError):
                self._mark_dead(pi, ri)
        raise RouterError(f"partition {pi}: no live replica")

    def search(self, request: Request) -> Response:
        """Scatter to every partition, gather, merge per-query top-k by
        score (reference merge: the GPU shard aggregation,
        gamma_index_ivfpq_gpu.cc:588-640; Vearch does the same across
        partition servers)."""
        futs = [self._pool.submit(self._one_partition_search, pi, request)
                for pi in range(len(self.partitions))]
        parts = [f.result() for f in futs]
        nq = max((len(p.results) for p in parts), default=0)
        reverse = self.metric == "ip"          # higher score = better
        merged = Response()
        merged.online_log_message = "; ".join(
            p.online_log_message for p in parts if p.online_log_message)
        for qi in range(nq):
            items: List[ResultItem] = []
            total = 0
            code = SearchResultCode.SUCCESS
            msg = ""
            for p in parts:
                if qi >= len(p.results):
                    continue
                sr = p.results[qi]
                total += sr.total
                if sr.result_code != SearchResultCode.SUCCESS:
                    code = sr.result_code
                    msg = sr.msg
                items.extend(sr.result_items)
            items.sort(key=lambda it: it.score, reverse=reverse)
            merged.results.append(SearchResult(
                total=total, result_code=code, msg=msg,
                result_items=items[: request.topn]))
        return merged

    # ---- broadcast maintenance ops ----

    def _broadcast(self, fn_name: str) -> List[int]:
        out = []
        for pi, spec in enumerate(self.partitions):
            for ri in range(len(spec.replicas)):
                if not spec.alive[ri]:
                    continue
                try:
                    out.append(getattr(self._client(pi, ri), fn_name)())
                except (OSError, RuntimeError):
                    self._mark_dead(pi, ri)
        return out

    def build_index(self) -> List[int]:
        return self._broadcast("build_index")

    def flush(self) -> List[int]:
        return self._broadcast("flush")

    def dump(self) -> List[int]:
        return self._broadcast("dump")

    def load(self) -> List[int]:
        return self._broadcast("load")

    def status(self) -> List[Any]:
        out = []
        for pi, spec in enumerate(self.partitions):
            for ri in range(len(spec.replicas)):
                if not spec.alive[ri]:
                    continue
                try:
                    out.append(self._client(pi, ri).status())
                    break                      # one replica per partition
                except (OSError, RuntimeError):
                    self._mark_dead(pi, ri)
        return out

    def doc_count(self) -> int:
        return sum(st.doc_count for st in self.status())

    def replica_status(self) -> List[Dict[str, Any]]:
        """Per-partition replica health: alive flags + missed-write lag
        (the divergence window of the any-replica ack model — nonzero lag
        means that replica must be re-cloned, not trusted for reads)."""
        return [{"alive": list(spec.alive), "lag": list(spec.lag)}
                for spec in self.partitions]

    # ---- replica management (re-replication / partition move) ----

    def recover_replica(self, pi: int, ri: int, *, new_addr=None,
                        new_config=None, source_path: str = None,
                        dest_path: str = None) -> None:
        """Re-clone a dead replica from a healthy sibling: sibling dump →
        copy checkpoint dir → init the new engine over the copy → load.
        Single-filesystem form of Vearch's partition recovery (production
        ships the dump directory; the protocol is the same — a dump is a
        self-contained partition).  docs/MULTIHOST.md "Migration"."""
        spec = self.partitions[pi]
        donor = next((j for j, ok in enumerate(spec.alive)
                      if ok and j != ri), None)
        if donor is None:
            raise RouterError(f"partition {pi}: no donor replica")
        donor_cli = self._client(pi, donor)
        if donor_cli.flush() != 0 or donor_cli.dump() != 0:
            raise RouterError(f"partition {pi}: donor dump failed")
        if dest_path and source_path and dest_path != source_path:
            shutil.rmtree(dest_path, ignore_errors=True)
            shutil.copytree(source_path, dest_path)
        if new_addr is not None:
            spec.replicas[ri] = new_addr
        self._drop_client(pi, ri)          # fresh connection, fresh handle
        cli = self._client(pi, ri)
        if cli.init(new_config) != 0 or cli.load() < 0:
            raise RouterError(f"partition {pi}: replica load failed")
        spec.alive[ri] = True
        spec.lag[ri] = 0      # re-clone covers every missed write

    def close(self) -> None:
        for pi, spec in enumerate(self.partitions):
            for ri in range(len(spec.replicas)):
                if spec.alive[ri]:
                    try:
                        self._client(pi, ri).close()
                    except (OSError, RuntimeError):
                        pass
        for cli in list(self._clients.values()):
            try:
                cli._sock.close()
            except OSError:
                pass
        self._clients.clear()
        self._pool.shutdown(wait=False)
