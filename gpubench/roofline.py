"""Peaks of the card and the least work of a search, from the
configuration and the traffic alone.

The bound of a request is the larger of two times: the bytes it must
read or write at least once per batch at the memory's peak, and its
operations at the card's dense bf16 peak.  Nothing here looks at the
kernels the program launches, so a fused or redesigned kernel is read
against the same work.

IVFPQ, per request of b queries over n rows of d dimensions, M one-byte
codes a row, nlist lists, recall_num R candidates reranked exactly,
raw rows of s bytes an element on the card:

  dense (every row's reconstruction scored, then R reranked):
    ops   = 2 b n d + 2 b R d
    bytes = n M + b R d s + 4 b d
  gather (nprobe lists a query, ADC over the codes, then R reranked):
    ops   = 2 b nlist d + b nprobe (n / nlist) M + 2 b R d
    bytes = f (n M + 4 n) + 4 b M ksub + b R d s + 4 b d,
            f = min(1, b nprobe / nlist): the share of lists probed
  (ksub = 2^nbits: one float table entry per code value and sub-vector
  a query; 4 n: a 32-bit id beside each code.)
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 bandwidth and the dense
# (no sparsity) bf16 tensor-core rate, both at the 700 W limit
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                   "bf16_ops_per_s": 989e12}}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float8": 1}


def _shape(cfg: Dict[str, Any], traffic: Dict[str, Any],
           params: Dict[str, Any]):
    rp = cfg["retrieval_params"]
    s = ELEMENT_BYTES[cfg["store"]["store_param"].get("device_dtype",
                                                      "bfloat16")]
    return (int(traffic["batch"]), int(cfg["corpus"]["n"]),
            int(cfg["corpus"]["d"]), int(rp["nsubvector"]),
            int(rp["ncentroids"]), int(params.get("nprobe", rp["nprobe"])),
            int(params.get("recall_num", 100)),
            2 ** int(rp.get("nbits_per_idx", 8)), s)


def ivfpq_work(mode: str, cfg: Dict[str, Any], traffic: Dict[str, Any],
               params: Dict[str, Any]) -> Tuple[float, float]:
    """(bytes, ops) of one request in scan mode `mode`."""
    b, n, d, m, nlist, nprobe, r, ksub, s = _shape(cfg, traffic, params)
    rerank_ops, rerank_bytes = 2.0 * b * r * d, float(b * r * d * s)
    if mode == "dense":
        return (n * m + rerank_bytes + 4.0 * b * d,
                2.0 * b * n * d + rerank_ops)
    f = min(1.0, b * nprobe / nlist)
    return (f * (n * m + 4.0 * n) + 4.0 * b * m * ksub + rerank_bytes
            + 4.0 * b * d,
            2.0 * b * nlist * d + b * nprobe * (n / nlist) * m + rerank_ops)


def bound_s(nbytes: float, ops: float, kind: str) -> Optional[float]:
    """The least time of (nbytes, ops) on a card of `kind`; None for a
    card whose peaks are not in PEAKS."""
    p = PEAKS.get(kind)
    if p is None:
        return None
    return max(nbytes / p["bytes_per_s"], ops / p["bf16_ops_per_s"])
