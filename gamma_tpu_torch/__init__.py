"""gamma_tpu_torch — the PyTorch/CUDA port of gamma_tpu.

The same engine API as gamma_tpu (documents mixing scalar fields and
vectors, realtime ingest, filtered hybrid search, dump/load), on PyTorch
tensors, with the TPU's Pallas kernels rewritten by hand for NVIDIA
Hopper (CUDA C++ under csrc/, built at first use).  Module paths mirror
gamma_tpu's, and gamma_tpu stays the reference the port is tested
against.  This package never imports jax or gamma_tpu.

Ported: the engine with all seven retrieval models (IVFPQ in its dense
scan mode, the default, and on the gather tier over the residual-SQ8 or
PQ payload, with OPQ; IVFPQ_FASTSCAN, IVFFLAT, FLAT, SCANN/VEARCH,
BINARYIVF and HNSW), the disk tier, the faiss-like standalone facade
(`gamma_tpu_torch.faisslike`) and the serving surface (`c_api`,
`idl.wire`, `server`, `cluster`) and multi-device serving (`parallel`,
`GammaEngine.enable_sharded_search`); every Pallas kernel of gamma_tpu,
in every operand form, has a CUDA counterpart.
"""

from gamma_tpu_torch.version import __version__
from gamma_tpu_torch.config import (
    DataType,
    EngineConfig,
    FieldInfo,
    TableInfo,
    VectorInfo,
)
from gamma_tpu_torch.api.request import Request, VectorQuery, RangeFilter, TermFilter
from gamma_tpu_torch.api.response import Response, SearchResult, ResultItem
from gamma_tpu_torch.api.doc import Doc
from gamma_tpu_torch.engine import GammaEngine

__all__ = [
    "__version__",
    "DataType",
    "EngineConfig",
    "FieldInfo",
    "TableInfo",
    "VectorInfo",
    "Request",
    "VectorQuery",
    "RangeFilter",
    "TermFilter",
    "Response",
    "SearchResult",
    "ResultItem",
    "Doc",
    "GammaEngine",
]
