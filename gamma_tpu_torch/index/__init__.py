"""Retrieval models (the plugin layer).

Reference: index/retrieval_model.h RetrievalModel ABC + the Reflector
registry (index/reflector.h:27-80 REGISTER_MODEL).  Importing this package
registers the built-in models: all seven of the JAX package, IVFPQ
(dense scan, or the gather tier over the residual-SQ8 or PQ payload),
IVFPQ_FASTSCAN, IVFFLAT, FLAT, SCANN (also as VEARCH), BINARYIVF and
HNSW.  create_model raises KeyError, with the list of known names, for
any other name.
"""

from gamma_tpu_torch.index import registry
from gamma_tpu_torch.index.registry import (register_model, create_model,
                                            model_names)
from gamma_tpu_torch.index.model import RetrievalModel

from gamma_tpu_torch.index import ivfpq as _ivfpq   # noqa: F401
from gamma_tpu_torch.index import ivfpq_fastscan as _ivfpqfs   # noqa: F401
from gamma_tpu_torch.index import ivfflat as _ivfflat   # noqa: F401
from gamma_tpu_torch.index import flat as _flat   # noqa: F401
from gamma_tpu_torch.index import scann as _scann   # noqa: F401
from gamma_tpu_torch.index import binary_ivf as _bivf   # noqa: F401
from gamma_tpu_torch.index import hnsw as _hnsw   # noqa: F401

__all__ = ["register_model", "create_model", "model_names", "RetrievalModel"]
