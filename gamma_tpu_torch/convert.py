"""State carried across from the JAX package (and back).

Both packages persist an IVFPQ model as `<field>.ivfpq.npz`, and an
IVFPQ_FASTSCAN model as `<field>.ivfpqfs.npz`, with the same numpy
arrays: centroids, codebooks, opq_rot, codes, vids, docids, lens,
indexed_count and, when the SQ8 sidecar is held, sq_codes, sq_norms,
sq_scale, sq_off.  A dump of the PQ payload carries no sq_* arrays, and
FastScan's codes are packed nibbles [nlist, cap, M/2].  An IVFFLAT model
is `<field>.ivfflat.npz`: centroids, codes (the bf16 rows' bytes [nlist,
cap, 2d]), vids, docids, lens, indexed_count.  These functions translate
those payloads to the port's tensors and back, so each package loads the
other's dump.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from gamma_tpu_torch.ops.distances import l2_norms
from gamma_tpu_torch.ops.pq import codebooks_from
from gamma_tpu_torch.realtime.invert_index import IVFState

_SQ_KEYS = ("sq_codes", "sq_norms", "sq_scale", "sq_off")


def ivfpq_arrays_to_torch(z: Mapping[str, np.ndarray],
                          device) -> Dict[str, Any]:
    """The arrays of a `.ivfpq.npz` → model state on `device`:
    {trained, centroids, cent_norms, pq, opq_rot (None when absent),
    state, indexed_count[, sq_codes, sq_norms, sq_scale, sq_off]}."""
    def t(name, dtype):
        return torch.from_numpy(np.ascontiguousarray(
            z[name], dtype=dtype)).to(device)

    out: Dict[str, Any] = {"trained": int(z["trained"])}
    if not out["trained"]:
        return out
    cents = t("centroids", np.float32)
    rot = np.asarray(z["opq_rot"])
    out.update(
        centroids=cents,
        cent_norms=l2_norms(cents),
        pq=codebooks_from(t("codebooks", np.float32)),
        opq_rot=t("opq_rot", np.float32) if rot.size else None,
        state=IVFState(t("codes", np.uint8), t("vids", np.int32),
                       t("docids", np.int32), t("lens", np.int32)),
        indexed_count=int(z["indexed_count"]),
    )
    if all(k in z for k in _SQ_KEYS):
        out.update(sq_codes=t("sq_codes", np.uint8),
                   sq_norms=t("sq_norms", np.float32),
                   sq_scale=t("sq_scale", np.float32),
                   sq_off=t("sq_off", np.float32))
    return out


def ivfpq_torch_to_arrays(model) -> Dict[str, np.ndarray]:
    """The inverse: a port IVFPQ or IVFPQ_FASTSCAN model → the arrays of
    its dump."""
    if not model.trained():
        return {"trained": np.array(0)}

    def a(x):
        return x.detach().cpu().numpy()

    out = dict(
        trained=np.array(1),
        centroids=a(model.centroids),
        codebooks=a(model.pq.codebooks),
        opq_rot=(a(model.opq_rot) if model.opq_rot is not None
                 else np.zeros(0)),
        codes=a(model.state.codes),
        vids=a(model.state.vids),
        docids=a(model.state.docids),
        lens=a(model.state.lens),
        indexed_count=np.array(model.indexed_count),
    )
    if model.sq_codes is not None:
        out.update(sq_codes=a(model.sq_codes), sq_norms=a(model.sq_norms),
                   sq_scale=a(model.sq_scale), sq_off=a(model.sq_off))
    return out


def ivfflat_arrays_to_torch(z: Mapping[str, np.ndarray],
                            device) -> Dict[str, Any]:
    """The arrays of a `.ivfflat.npz` → model state on `device`:
    {trained, centroids, cent_norms, state, indexed_count}."""
    def t(name, dtype):
        return torch.from_numpy(np.ascontiguousarray(
            z[name], dtype=dtype)).to(device)

    out: Dict[str, Any] = {"trained": int(z["trained"])}
    if not out["trained"]:
        return out
    cents = t("centroids", np.float32)
    out.update(
        centroids=cents,
        cent_norms=l2_norms(cents),
        state=IVFState(t("codes", np.uint8), t("vids", np.int32),
                       t("docids", np.int32), t("lens", np.int32)),
        indexed_count=int(z["indexed_count"]),
    )
    return out


def ivfflat_torch_to_arrays(model) -> Dict[str, np.ndarray]:
    """The inverse: a port IVFFLAT model → the arrays of its dump."""
    if not model.trained():
        return {"trained": np.array(0)}
    st = model.state
    return dict(
        trained=np.array(1),
        centroids=model.centroids.cpu().numpy(),
        codes=st.codes.cpu().numpy(),
        vids=st.vids.cpu().numpy(),
        docids=st.docids.cpu().numpy(),
        lens=st.lens.cpu().numpy(),
        indexed_count=np.array(model.indexed_count),
    )
