#!/usr/bin/env python3
"""H100 smoke run of the PyTorch/CUDA port (gamma_tpu_torch).

    python3 chip_smoke.py            # needs one CUDA card; no flags needed

Builds the port's CUDA kernels from csrc/, holds each kernel against its
plain PyTorch version at the main paths' shapes, then drives the port's
GammaEngine through its public API at the SIFT1M geometry of the TPU
bench (nlist 2048, nprobe 64, gather tier), one engine after another:
  D        IVFPQ M 32 over the residual-SQ8 sidecar (kernels B1/B2):
           ingest, auto-train, searches (plain, hybrid, score range, a
           hot list that switches the scan to the folded kernel),
           delete, dump and load;
  D-pq     IVFPQ M 32 over the PQ payload (B3, 8-bit), the same checks
           but the hot list;
  D-fs     IVFPQ_FASTSCAN M 64 (B3, packed 4-bit), likewise;
  D-b4     IVFPQ M 20 x 4-bit over the PQ payload (B4) at 300k docs:
           the search with the kernel equals it with the plain version;
  D-b5     the FastScan per-query-table scan (B5, no engine path) over
           D-fs's own codes;
  D-dense  IVFPQ M 32 on its default scan mode, the dense scan over the
           reconstruction mirror with the exact rerank's rows fetched by
           X1, at 1M docs: the checks of D, delete, dump and a load that
           rebuilds the mirror, and a split of the dense search's device
           time;
  D-opq    the same with OPQ, searched dense and gather (B1).
D-pq, D-fs and D-b4 rerank through X1 as well; D-fs also answers one
dense request.
Every phase raises on a failed check, so the run exits non-zero and
prints no result line; the last stdout line is the device record.

Phases (one line each): A card, B kernel build, C kernels vs plain at
the slices' nominal shapes and at the edge shapes of every kernel (group
widths 8 to 128, ragged tiles and caps, strided views, code rows,
codebooks and gathered rows of other widths, both index types),
D.. engines (their searches also record the
operands they hand each kernel, and a time breakdown), E kernels vs
plain at the engines' own widths and on those recorded operands.  Each
kernel row carries its time, its plain version's, the least time the
card could take for the same work (`bound_ms`: bytes over 3.35 TB/s or
operations over the peak rate of their type, the larger) and, where one
PyTorch call computes the same function, that call's time.  B3's rows
also carry `smem_floor_ms`, the least time its lookups could take as a
gather from a bf16 table in shared memory (information, not the bound).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
D = 128
NLIST, M_SUB, NPROBE, TOPK = 2048, 32, 64, 10
N_DOCS, INDEXING_SIZE = 1_000_000, 262144   # auto-train on the 3rd batch
N_B4 = 300_000                 # D-b4's depth: auto-train still fires
BIG = 3.0e38
GATHER = {"ncentroids": NLIST, "nprobe": NPROBE, "scan_mode": "gather"}
# the default scan mode ("auto": dense while the mirror fits)
DENSE = {"ncentroids": NLIST, "nprobe": NPROBE, "nsubvector": M_SUB}
X1_N, X1_K = 1_000_000, 1024 * 100   # the exact rerank's row gather
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, dense FLOP/s by type
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "f32": 67e12}
SMEM_BYTES_PER_CLOCK = 128     # shared-memory bytes one SM moves a clock
# filled by phase A: SM count and the card's highest SM clock (Hz)
CARD = {"sms": None, "sm_clock_hz": None}
# the engines of the ADC kernels: tag → (retrieval type, params, docs)
ADC_ENGINES = {
    "pq": ("IVFPQ", dict(GATHER, nsubvector=M_SUB, gather_payload="pq"),
           N_DOCS),
    "fs": ("IVFPQ_FASTSCAN", dict(GATHER, nsubvector=2 * M_SUB), N_DOCS),
    "b4": ("IVFPQ", dict(GATHER, nsubvector=20, nbits_per_idx=4,
                         gather_payload="pq"), N_B4),
}
# kernel → (source, TPU kernel it replaces)
KERNELS = {
    "gsq": ("gamma_tpu_torch/csrc/gsq.cu", "gamma_tpu/ops/pallas_gsq.py:107"),
    "gsq_fold": ("gamma_tpu_torch/csrc/gsq.cu",
                 "gamma_tpu/ops/pallas_gsq.py:143"),
    "gadc": ("gamma_tpu_torch/csrc/gadc.cu",
             "gamma_tpu/ops/pallas_gadc.py:148"),
    "adc": ("gamma_tpu_torch/csrc/adc.cu", "gamma_tpu/ops/pallas_adc.py:41"),
    "adc_fs": ("gamma_tpu_torch/csrc/adc.cu",
               "gamma_tpu/ops/pallas_adc.py:116"),
    "gather_rows": ("gamma_tpu_torch/csrc/gather_rows.cu",
                    "experiments/exp_rerank.py:38"),
}


def cuda_time(fn, iters=20, warmup=3):
    """Mean milliseconds per call, from CUDA events after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(call, n):
    """The device events of n calls, in the order they started, from one
    torch.profiler CUDA trace (one warm call first)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a trace that has just started can miss what is launched in its
        # first milliseconds
        time.sleep(0.05)
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def device_time(fn, iters=50, flush_bytes=128 << 20):
    """Mean milliseconds of device time per call of fn: the device events
    of the calls themselves, summed from ONE profiled window of `iters`
    rounds of (flush, call).  The flush streams `flush_bytes` through
    the 50 MB L2 cache with a kernel no call here uses (an integer xor);
    its events are told from the call's by their name, which two short
    windows of the flush alone and the call alone establish (they must
    share no name).  The trace can lose events (it has lost the first
    rounds of a window, and single events inside one), and a sum over a
    window with holes, divided by `iters`, reads low: so a round counts
    only if it is whole, that is if it holds as many of the call's
    events as most rounds do, and at least a fifth of the rounds must
    count (43 to 50 of 50 did on an H100, once 32).
    For a call shorter than its own host-side launch (X1 takes tens of
    microseconds), CUDA events around a loop time the host's launch rate
    instead of the kernels; and the engine's rerank finds the store rows
    cold in L2, after the select has streamed gigabytes through it."""
    import torch
    src = torch.zeros(flush_bytes // 4, dtype=torch.int32, device="cuda")
    dst = torch.empty_like(src)

    def flush():
        torch.bitwise_xor(src, 1, out=dst)

    def flushed_call():
        flush()
        fn()

    def names(call):
        for n in (30, 100, 300):        # a window can come back empty
            found = {e.name for e in _device_events(call, n)}
            if found:
                break
        return found

    flush_names, own_names = names(flush), names(fn)
    assert flush_names and own_names and not flush_names & own_names, (
        "device_time: the flush and the call share a kernel",
        sorted(flush_names), sorted(own_names))
    rounds = []                 # the call's events after each flush seen
    for e in _device_events(flushed_call, iters):
        if e.name in flush_names:
            rounds.append([])
        elif rounds:
            rounds[-1].append(e.time_range.elapsed_us())
    sizes = [len(r) for r in rounds]
    whole = max(set(sizes), key=sizes.count) if sizes else 0
    kept = [r for r in rounds if len(r) == whole]
    assert whole and 5 * len(kept) >= iters, (
        "device_time: whole rounds seen", len(kept), "of", iters, sizes)
    return sum(map(sum, kept)) / 1e3 / len(kept)


# ---------------------------------------------------------------------
# A. the card
# ---------------------------------------------------------------------

def phase_a():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    # full-f32 products everywhere (the q.c term and the oracles)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0].split(",")
    CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    CARD["sm_clock_hz"] = 1e6 * float(clocks[0])
    print(smi)
    print("phase A card:", json.dumps({
        "nvidia_smi": smi, "sms": CARD["sms"],
        "sm_clock_max_mhz": float(clocks[0]),
        "sm_clock_now_mhz": float(clocks[1]), "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision()}))
    return smi


# ---------------------------------------------------------------------
# B. kernel build
# ---------------------------------------------------------------------

def phase_b():
    """One nvcc per source, all started together."""
    from gamma_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    names = ["gsq", "gadc", "adc", "gather_rows"]
    cuda_build.load_all(names)
    print("phase B build:", json.dumps({
        **{f"{n}_build_s": cuda_build.BUILD_SECONDS[n] for n in names},
        "load_s": time.perf_counter() - t0,
        "build_dir": os.path.relpath(cuda_build.BUILD_DIR, HERE)}))


# ---------------------------------------------------------------------
# C. kernels against their plain versions
# ---------------------------------------------------------------------

def _operands(cap, tile, metric, masked, seed, q_pad=64, b=1024, d=D,
              wide=0):
    """Grouped operands at the main path's shapes: nlist 2048, d_pad 128,
    B 1024 x P 64 probes grouped Q = 64 per list (the edge cases pass
    another q_pad, batch or width; `wide` more slots make codes and
    norms trimmed views of a wider sidecar, the list axis strided)."""
    import torch
    from gamma_tpu_torch.ops.gadc import build_groups, group_bound
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    p = NPROBE
    codes = torch.randint(0, 256, (NLIST, cap + wide, d), generator=g,
                          device=dev, dtype=torch.uint8)[:, :cap]
    lens = torch.randint(1, cap + 1, (NLIST,), generator=g, device=dev,
                         dtype=torch.int32)
    norms = (100.0 + 900.0 * torch.rand((NLIST, cap + wide), generator=g,
                                        device=dev))[:, :cap]
    list_ids = torch.randint(0, NLIST, (b, p), generator=g, device=dev)
    g_pad = group_bound(b, p, NLIST, q_pad)
    glist, ntiles, _, _, _ = build_groups(list_ids, lens, q_pad=q_pad,
                                          tile=tile, g_pad=g_pad)
    qs = (0.02 * torch.randn((g_pad, q_pad, d), generator=g, device=dev)
          ).to(torch.bfloat16)
    if masked:
        pos = torch.arange(cap, device=dev)[None, :]
        dead = (pos >= lens[:, None]) | (
            torch.rand((NLIST, cap), generator=g, device=dev) < 0.05)
        bias = torch.where(dead, BIG, 0.0)
        nrm = norms + bias if metric == "l2" else bias
    else:
        nrm = norms
    if wide:
        full = torch.zeros((NLIST, cap + wide), device=dev)
        full[:, :cap] = nrm
        return codes, full[:, :cap], glist, ntiles, qs
    return codes, nrm.contiguous(), glist, ntiles, qs


def _bound(plain_live):
    med = float(plain_live.abs().median()) if plain_live.numel() else 0.0
    return 1e-4 * max(1.0, med)


def _metric(alpha):
    return "l2" if alpha == 2.0 else "ip"


def _roofline(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type (ops: type →
    count, the times of the types added)."""
    t_bytes = nbytes / HBM_BPS
    t_ops = sum(n / PEAK[t] for t, n in ops.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _list_slots(glist, ntiles, tile, nlist):
    """Posting slots the groups read, each (list, slot) once: per list,
    the most live tiles any of its groups scans."""
    import torch
    live = ntiles.long() * tile
    per = torch.zeros(nlist, dtype=torch.long, device=live.device)
    per.scatter_reduce_(0, glist.long(), live, "amax")
    return int(per.sum()), int(live.sum())


def _grouped_bound(row, codes, glist, ntiles, tile, slot_floats, in_bytes,
                   out_bytes, ops_of_live):
    """Bound of a grouped scan (B1/B2/B3): the code row and the
    `slot_floats` f32 values (norm, bias) of each slot it reads, its
    other inputs, its output; ops from the slot-visits of all groups."""
    slots, visits = _list_slots(glist, ntiles, tile, codes.shape[0])
    nbytes = (slots * (codes.shape[2] + 4 * slot_floats) + in_bytes
              + out_bytes)
    row["bound_ms"], row["bound_by"] = _roofline(nbytes,
                                                 ops_of_live(visits))
    row["library_ms"] = None           # no one PyTorch call computes it
    return visits


def _compare_b1(ops, kw, origin):
    """B1 against its plain version on operands `ops` = (codes, nrm,
    glist, ntiles, qs) with the wrapper's keywords `kw`."""
    import torch
    from gamma_tpu_torch.ops import gsq
    kw = {k: v for k, v in kw.items() if k != "precise"}
    codes, _, _, ntiles, _ = ops
    cap, tile = codes.shape[1], kw["tile"]
    got = gsq.gsq(*ops, **kw)
    ref = gsq._gsq_plain(*ops, **kw)
    torch.cuda.synchronize()
    live = (torch.arange(cap, device=codes.device)[None, :]
            < ntiles.long()[:, None] * tile)[:, None, :].expand_as(ref)
    live = live & (ref < 1e37)        # masked-out slots carry the bias
    err = (got - ref).abs()
    tol = _bound(ref[live])
    max_abs = float(err[live].max())
    rel = float((err[live] / ref[live].abs().clamp_min(1.0)).max())
    dead_exact = bool(torch.equal(got[~live], ref[~live]))
    # no atomics, a fixed order of sums: a second launch gives the same bits
    assert torch.equal(gsq.gsq(*ops, **kw), got), "B1 launches differ"
    row = dict(kernel="gsq", operands=origin, cap=cap, tile=tile,
               metric=_metric(kw["alpha"]), masked=kw["masked"],
               groups=int(ref.shape[0]), q=int(ref.shape[1]),
               d_pad=int(codes.shape[2]),
               max_abs_err=max_abs, max_rel_err=rel, bound=tol)
    assert torch.isfinite(got).all(), ("non-finite B1 output", row)
    assert max_abs <= tol, row
    assert dead_exact, ("skipped/masked B1 slots differ from plain", row)
    qs = ops[4]
    g_n, q_n = int(ref.shape[0]), int(ref.shape[1])
    _grouped_bound(row, codes, ops[2], ntiles, tile, 1, qs.numel() * 2,
                   ref.numel() * 4,
                   lambda v: {"bf16": 2.0 * q_n * v * qs.shape[2]})
    del got, ref, live, err
    row["ms"] = cuda_time(lambda: gsq.gsq(*ops, **kw))
    row["plain_ms"] = cuda_time(lambda: gsq._gsq_plain(*ops, **kw),
                                iters=3, warmup=1)
    return row


def _compare_b2(ops, kw, origin):
    """B2 against its plain version (values, then argmins outside
    near-ties) on operands `ops` with the wrapper's keywords `kw`."""
    import torch
    from gamma_tpu_torch.ops import gsq
    kw = {k: v for k, v in kw.items() if k != "precise"}
    codes, _, _, ntiles, _ = ops
    cap, tile, fold = codes.shape[1], kw["tile"], kw["fold"]
    nt, lb = cap // tile, tile // fold
    vals, args = gsq.gsq_fold(*ops, **kw)
    pv, pa = gsq._gsq_fold_plain(*ops, **kw)
    torch.cuda.synchronize()
    g_n, q_n, capf = pv.shape
    live_t = (torch.arange(nt, device=codes.device)[None, :]
              < ntiles.long()[:, None])                       # [G, nt]
    live = live_t[:, None, :, None].expand(g_n, q_n, nt, lb).reshape(
        g_n, q_n, capf)
    live = live & (pv < 1e37)
    tol = _bound(pv[live])
    err = (vals - pv).abs()
    max_abs = float(err[live].max())
    rel = float((err[live] / pv[live].abs().clamp_min(1.0)).max())
    row = dict(kernel="gsq_fold", operands=origin, cap=cap, tile=tile,
               lb=lb, metric=_metric(kw["alpha"]), masked=True,
               groups=g_n, q=q_n, d_pad=int(codes.shape[2]),
               max_abs_err=max_abs, max_rel_err=rel, bound=tol,
               share_differing=float((vals != pv)[live].float().mean()))
    assert max_abs <= tol, row
    assert torch.equal(vals[~live], pv[~live]), ("B2 skipped bins", row)
    # where the two argmins differ, the kernel's pick must be a near-tie:
    # its plain-version distance is within the bound of the plain minimum
    full = gsq._gsq_plain(*ops, tile=tile, alpha=kw["alpha"],
                          with_norms=True, masked=True)
    full = full.reshape(g_n, q_n, nt, fold, lb)
    picked = torch.gather(full, 3, args.long().reshape(
        g_n, q_n, nt, 1, lb)).reshape(g_n, q_n, capf)
    differ = live & (args != pa)
    row["arg_mismatches"] = int(differ.sum())
    qs = ops[4]
    _grouped_bound(row, codes, ops[2], ntiles, tile, 1, qs.numel() * 2,
                   pv.numel() * 8,
                   lambda v: {"bf16": 2.0 * q_n * v * qs.shape[2]})
    if differ.any():
        gap = float((picked[differ] - pv[differ]).abs().max())
        assert gap <= tol, ("B2 argmin is not a near-tie", gap, row)
    del full, picked, vals, args, pv, pa, live, err
    row["ms"] = cuda_time(lambda: gsq.gsq_fold(*ops, **kw))
    row["plain_ms"] = cuda_time(lambda: gsq._gsq_fold_plain(*ops, **kw),
                                iters=3, warmup=1)
    return row


def _check_b1(cap, metric, masked, seed, **shape):
    tile = min(512, cap)
    ops = _operands(cap, tile, metric, masked, seed, **shape)
    return _compare_b1(ops, dict(
        tile=tile, alpha=2.0 if metric == "l2" else 1.0, masked=masked,
        with_norms=masked or metric == "l2"), "synthetic")


def _check_b2(cap, metric, seed, **shape):
    from gamma_tpu_torch.ops import gsq
    tile, _ = gsq.fold_geometry(cap, 4096, 8)
    ops = _operands(cap, tile, metric, True, seed, **shape)
    return _compare_b2(ops, dict(
        tile=tile, alpha=2.0 if metric == "l2" else 1.0, fold=8),
        "synthetic")


def _b3_bound(codes, glist, rg, cb, cbn, alpha, packed):
    """Per element of B3's [G, Q, cap] output: sum_m ulp_bf16(|lut entry
    picked|) + 1e-5 x sum_m |lut entry picked|, from the LUT the plain
    formula gives (a bf16 rounding of one entry may flip when its f32
    dot sums in another order)."""
    import torch
    from gamma_tpu_torch.ops.adc import unpack_nibbles
    m, ksub, dsub = cb.shape
    g_n, q_n, _ = rg.shape
    cap = codes.shape[1]
    out = torch.empty((g_n, q_n, cap), dtype=torch.float32,
                      device=codes.device)
    cbf = cb.float()
    for g0 in range(0, g_n, 16):
        g1 = min(g_n, g0 + 16)
        r = rg[g0:g1].float().reshape(g1 - g0, q_n, m, dsub)
        lut = (cbn - alpha * torch.einsum("gqmt,mkt->gqmk", r, cbf)).to(
            torch.bfloat16).float()                       # [g, Q, M, ksub]
        c = codes[glist[g0:g1].long()]
        c = unpack_nibbles(c) if packed else c            # [g, cap, M]
        idx = c.long().permute(0, 2, 1)[:, None].expand(g1 - g0, q_n, m,
                                                         cap)
        picked = torch.gather(lut, 3, idx).abs()          # [g, Q, M, cap]
        ulp = torch.exp2(torch.floor(torch.log2(picked.clamp_min(1e-30)))
                         - 7)
        out[g0:g1] = ulp.sum(2) + 1e-5 * picked.sum(2)
    return out


def _compare_b3(ops, kw, origin):
    """B3 against its plain version on operands `ops` = (codes, glist,
    ntiles, rg, cb, cbn[, bias]) with the wrapper's keywords `kw`."""
    import torch
    from gamma_tpu_torch.ops import gadc
    codes, glist, ntiles, rg, cb, cbn = ops[:6]
    bias = ops[6] if len(ops) > 6 else None
    cap, tile = codes.shape[1], kw["tile"]
    got = gadc.gadc(*ops, **kw)
    ref = gadc._gadc_plain(codes, glist, ntiles, rg, cb, cbn, bias, **kw)
    torch.cuda.synchronize()
    live = (torch.arange(cap, device=codes.device)[None, :]
            < ntiles.long()[:, None] * tile)[:, None, :].expand_as(ref)
    live = live & (ref < 1e37)        # masked-out slots carry the bias
    bound = _b3_bound(codes, glist, rg, cb, cbn, kw["alpha"], kw["packed"])
    err = (got - ref).abs()
    row = dict(kernel="gadc", operands=origin, cap=cap, tile=tile,
               packed=kw["packed"], metric=_metric(kw["alpha"])
               if not kw["packed"] else "l2", alpha=kw["alpha"],
               masked=bias is not None, groups=int(ref.shape[0]),
               q=int(ref.shape[1]), M=int(cb.shape[0]),
               ksub=int(cb.shape[1]), dsub=int(cb.shape[2]), max_abs_err=float(err[live].max()),
               max_err_over_bound=float((err / bound)[live].max()),
               share_differing=float((got != ref)[live].float().mean()),
               live_elements=int(live.sum()))
    assert torch.isfinite(got).all(), ("non-finite B3 output", row)
    assert bool((err <= bound)[live].all()), row
    assert torch.equal(got[~live], ref[~live]), (
        "skipped/masked B3 slots differ from plain", row)
    m, ksub, dsub = cb.shape
    g_n, q_n = int(ref.shape[0]), int(ref.shape[1])
    # the LUT build is a bf16 product; the lookups are f32 adds
    visits = _grouped_bound(
        row, codes, glist, ntiles, tile, int(bias is not None),
        rg.numel() * 2 + cb.numel() * 2 + cbn.numel() * 4, ref.numel() * 4,
        lambda v: {"bf16": 2.0 * g_n * q_n * m * ksub * dsub,
                   "f32": float(q_n) * v * m})
    # not the bound: the least time a gather from a bf16 LUT in shared
    # memory could take, 2 bytes per (live slot-visit, query, m) lookup
    # over every SM's shared-memory rate at the card's highest clock
    row["smem_floor_ms"] = 1e3 * (2.0 * visits * q_n * m) / (
        CARD["sms"] * SMEM_BYTES_PER_CLOCK * CARD["sm_clock_hz"])
    del got, ref, live, err, bound
    row["ms"] = cuda_time(lambda: gadc.gadc(*ops, **kw))
    row["plain_ms"] = cuda_time(
        lambda: gadc._gadc_plain(codes, glist, ntiles, rg, cb, cbn, bias,
                                 **kw), iters=2, warmup=1)
    return row


def _compare_adc(name, ops, origin):
    """B4 (`adc`) or B5 (`adc_fs`) against its plain version on operands
    (codes, list_ids, lut): f32 tables in, so only the sum order differs,
    bound 1e-5 x sum_m |lut entry picked| per element."""
    import torch
    from gamma_tpu_torch.ops import adc
    fn = getattr(adc, name)
    plain = getattr(adc, f"_{name}_plain")
    codes, ids, lut = ops
    got = fn(*ops)
    ref = plain(*ops)
    bound = 1e-5 * plain(codes, ids, lut.abs())
    torch.cuda.synchronize()
    err = (got - ref).abs()
    row = dict(kernel=name, operands=origin, cap=int(codes.shape[1]),
               pairs=int(ids.numel()), M=int(lut.shape[-2]),
               ksub=int(lut.shape[-1]), max_abs_err=float(err.max()),
               max_err_over_bound=float((err / bound.clamp_min(1e-30)
                                         ).max()),
               share_differing=float((got != ref).float().mean()))
    assert torch.isfinite(got).all(), (f"non-finite {name} output", row)
    assert bool((err <= bound).all()), row
    lists = int(torch.unique(ids).numel())
    m = lut.shape[-2]
    row["bound_ms"], row["bound_by"] = _roofline(
        lists * codes.shape[1] * codes.shape[2] + lut.numel() * 4
        + ref.numel() * 4, {"f32": float(ids.numel()) * codes.shape[1] * m})
    row["library_ms"] = None
    del got, ref, err, bound
    row["ms"] = cuda_time(lambda: fn(*ops))
    row["plain_ms"] = cuda_time(lambda: plain(*ops), iters=3, warmup=1)
    return row


def _compare_x1(table, idx, origin):
    """X1 against its plain version: the rows must be equal bit for bit
    (a copy does no arithmetic).  Timed beside torch.index_select, the
    one PyTorch call for the same rows (it takes no out-of-range index,
    so it is timed on the indices clamped to the table).  All three by
    their device time (`device_time`); `events_ms` is the kernel's CUDA
    event time, which its host-side launch can exceed."""
    import torch
    from gamma_tpu_torch.ops import gather_rows as x1
    n, d = table.shape
    got = x1.gather_rows(table, idx)
    ref = x1._gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    valid = int(((idx >= 0) & (idx < n)).sum())
    row = dict(kernel="gather_rows", operands=origin, n=n, d=d,
               k=int(idx.numel()), dtype=str(table.dtype).split(".")[-1],
               idx_dtype=str(idx.dtype).split(".")[-1], valid_rows=valid,
               bitexact=bool(torch.equal(got.view(torch.uint8),
                                         ref.view(torch.uint8))),
               max_abs_err=float((got.float() - ref.float()).abs().max()))
    assert row["bitexact"], row
    row.update(_index_stats(idx, n))
    row_bytes = d * table.element_size()
    # each valid row read once, every output row written once, the index
    row["bound_ms"], row["bound_by"] = _roofline(
        valid * row_bytes + idx.numel() * (row_bytes + idx.element_size()),
        {})
    del got, ref
    clamped = idx.clamp(0, n - 1)
    row["ms"] = device_time(lambda: x1.gather_rows(table, idx))
    row["events_ms"] = cuda_time(lambda: x1.gather_rows(table, idx),
                                 iters=50)
    row["plain_ms"] = device_time(lambda: x1._gather_rows_plain(table, idx))
    row["library_ms"] = device_time(
        lambda: torch.index_select(table, 0, clamped))
    return row


def _index_stats(idx, n):
    """What an index tensor asks of a row gather: the share of indices
    outside the table (zero rows, nothing read), the share of the valid
    ones that repeat an index already in the tensor (a row read again,
    likely from cache), and how near consecutive indices lie (the
    median distance in rows, and the share within 32 rows)."""
    import torch
    idx = idx.long()
    ok = (idx >= 0) & (idx < n)
    valid = idx[ok]
    gap = (idx[1:] - idx[:-1]).abs()[ok[1:] & ok[:-1]]
    return dict(
        out_of_range_share=1.0 - float(ok.float().mean()),
        repeated_share=(1.0 - torch.unique(valid).numel() / valid.numel()
                        if valid.numel() else 0.0),
        median_gap_rows=float(gap.median()) if gap.numel() else None,
        near_share=float((gap <= 32).float().mean()) if gap.numel()
        else None)


def _x1_edge_cases():
    """X1 beside its nominal shape: int64 indices, rows whose width
    allows no 16-byte unit (127 bf16: 2-byte units; 77 u8: 1-byte units;
    33 f32: 4-byte units), the last under indices that repeat 1000 rows."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(81)
    rows = []
    for n, d, dtype, idx_dtype, span in [
            (X1_N, D, torch.bfloat16, torch.int64, X1_N),
            (200_000, 127, torch.bfloat16, torch.int32, 200_000),
            (200_000, 77, torch.uint8, torch.int64, 200_000),
            (200_000, 33, torch.float32, torch.int32, 1000)]:
        # byte values: exact in every row type
        table = torch.randint(0, 256, (n, d), generator=g, device=dev,
                              dtype=torch.uint8).to(dtype)
        idx = torch.randint(0, span, (X1_K,), generator=g,
                            device=dev).to(idx_dtype)
        idx[::997] = -1
        idx[1::991] = n
        rows.append(_compare_x1(table, idx, "synthetic"))
        del table, idx
        torch.cuda.empty_cache()
    return rows


def _x1_operands(seed):
    """The experiment's geometry (exp_rerank.py:68-69): a 1M x 128 bf16
    table and 1024 x 100 int32 indices, some of them -1 and n."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((X1_N, D), generator=g, device=dev).to(
        torch.bfloat16)
    idx = torch.randint(0, X1_N, (X1_K,), generator=g, device=dev,
                        dtype=torch.int32)
    idx[::997] = -1
    idx[1::991] = X1_N
    return table, idx


def _b3_operands(cap, m, ksub, dsub, tile, *, packed, alpha, masked, seed,
                 rg_scale=1.0, q_pad=64, b=1024):
    """Grouped B3 operands at the engines' shapes: nlist 2048, B 1024 x
    P 64 grouped Q = 64 per list, codebooks and rg rows in bf16 (the
    edge cases pass another q_pad or batch)."""
    import torch
    from gamma_tpu_torch.ops.gadc import build_groups, group_bound
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    p = NPROBE
    w = m // 2 if packed else m
    codes = torch.randint(0, 256 if packed else ksub, (NLIST, cap, w),
                          generator=g, device=dev, dtype=torch.uint8)
    lens = torch.randint(1, cap + 1, (NLIST,), generator=g, device=dev,
                         dtype=torch.int32)
    list_ids = torch.randint(0, NLIST, (b, p), generator=g, device=dev)
    g_pad = group_bound(b, p, NLIST, q_pad)
    glist, ntiles, _, _, _ = build_groups(list_ids, lens, q_pad=q_pad,
                                          tile=tile, g_pad=g_pad)
    rg = (rg_scale * torch.randn((g_pad, q_pad, m * dsub), generator=g,
                                 device=dev)).to(torch.bfloat16)
    cb = torch.randn((m, ksub, dsub), generator=g, device=dev).to(
        torch.bfloat16)
    cbn = ((cb.float() ** 2).sum(-1) if alpha == 2.0
           else torch.zeros((m, ksub), device=dev))
    ops = [codes, glist, ntiles, rg, cb, cbn]
    if masked:
        pos = torch.arange(cap, device=dev)[None, :]
        dead = (pos >= lens[:, None]) | (
            torch.rand((NLIST, cap), generator=g, device=dev) < 0.05)
        ops.append(torch.where(dead, BIG, 0.0))
    return tuple(ops), dict(tile=tile, alpha=alpha, packed=packed)


def _adc_operands(cap, m, ksub, *, packed, seed, b=1024):
    """B4 / B5 operands: nlist 2048, B 1024 x P 64 pairs, f32 tables per
    pair (B4) or per query (B5)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    p = NPROBE
    w = m // 2 if packed else m
    codes = torch.randint(0, 256 if packed else ksub, (NLIST, cap, w),
                          generator=g, device=dev, dtype=torch.uint8)
    ids = torch.randint(0, NLIST, (b, p), generator=g, device=dev)
    shape = (b, m, 16) if packed else (b, p, m, ksub)
    return codes, ids, 10.0 * torch.randn(shape, generator=g, device=dev)


def _adc_edge_cases():
    """B4 and B5 beside their nominal shapes, a quarter of the batch
    each: code rows of 7 bytes (read byte by byte), a codes operand that
    starts off a 16-byte boundary (a view from slot 1 of 20-byte rows),
    256-entry tables over a cap past one block's 1024 slots, and B5 over
    10-byte rows at a cap no step divides."""
    import torch
    rows = []
    for name, cap, m, ksub, packed, skip in [
            ("adc", 300, 7, 16, False, 0), ("adc", 500, 20, 16, False, 1),
            ("adc", 1280, 8, 256, False, 0),
            ("adc_fs", 1000, 20, 16, True, 0)]:
        codes, ids, lut = _adc_operands(cap + skip, m, ksub, packed=packed,
                                        seed=72 + len(rows), b=256)
        rows.append(_compare_adc(name, (codes[:, skip:], ids, lut),
                                 "synthetic"))
        del codes, ids, lut
        torch.cuda.empty_cache()
    return rows


def _b2_edge_cases():
    """B2 beside its nominal shape: tile = cap with lb 608 (L2 and IP),
    Q 8 and Q 128 (a quarter of the batch), and a d_pad that is no
    multiple of 128 (48: the 16-dim chunks) over a ragged lb 100."""
    import torch
    rows = [_check_b2(4864, "l2", 32), _check_b2(4864, "ip", 33),
            _check_b2(4864, "l2", 34, q_pad=8, b=256),
            _check_b2(4864, "ip", 35, q_pad=128, b=256),
            _check_b2(800, "l2", 36, q_pad=16, b=256, d=48)]
    torch.cuda.empty_cache()
    return rows


def _b1_edge_cases():
    """B1 beside its nominal shape, a quarter of the batch each: Q 8 and
    Q 128, a d_pad that is no multiple of 128 (48: the 16-dim chunks),
    cap 1000 under 512-slot logical tiles (ragged last block, ragged
    last tile), IP unmasked (no norms: -ip alone), codes and norms that
    are trimmed views of a wider sidecar, and a cap that is no multiple
    of 4 (999: the 4-byte stores)."""
    import torch
    rows = [_check_b1(1280, "l2", True, 43, q_pad=8, b=256),
            _check_b1(1280, "l2", False, 44, q_pad=128, b=256),
            _check_b1(1024, "l2", True, 45, q_pad=16, b=256, d=48),
            _check_b1(1000, "l2", True, 46, b=256),
            _check_b1(1000, "ip", False, 47, b=256),
            _check_b1(1280, "l2", True, 48, b=256, wide=768),
            _check_b1(999, "l2", True, 49, q_pad=32, b=256)]
    torch.cuda.empty_cache()
    return rows


def _b3_edge_cases():
    """B3 beside its nominal shapes, a quarter of the batch each: 8-bit
    at Q 8 and Q 128, ksub 16 unpacked (M 32, dsub 4), dsub 8 (M 16), a
    cap that no span divides (1000), M 24 (24-byte code rows: no 16-byte
    loads; LUT stages of 16 + 8), M 48 (three stages), an odd dsub with
    a ksub that is no multiple of 16 (M 8 x 24, dsub 3), dsub 32 (two
    MMAs a tile); packed at dsub 4 (M 32) and Q 16."""
    import torch
    rows = []
    cases = [
        dict(cap=1280, m=M_SUB, ksub=256, dsub=4, tile=256, packed=False,
             alpha=2.0, masked=True, q_pad=8),
        dict(cap=1280, m=M_SUB, ksub=256, dsub=4, tile=256, packed=False,
             alpha=1.0, masked=False, q_pad=128),
        dict(cap=1280, m=M_SUB, ksub=16, dsub=4, tile=512, packed=False,
             alpha=2.0, masked=True),
        dict(cap=1280, m=16, ksub=256, dsub=8, tile=256, packed=False,
             alpha=2.0, masked=True),
        dict(cap=1000, m=M_SUB, ksub=256, dsub=4, tile=256, packed=False,
             alpha=2.0, masked=False),
        dict(cap=1280, m=24, ksub=256, dsub=4, tile=256, packed=False,
             alpha=2.0, masked=True),
        dict(cap=640, m=48, ksub=256, dsub=2, tile=256, packed=False,
             alpha=2.0, masked=True),
        dict(cap=640, m=8, ksub=24, dsub=3, tile=256, packed=False,
             alpha=2.0, masked=True),
        dict(cap=640, m=4, ksub=256, dsub=32, tile=256, packed=False,
             alpha=1.0, masked=True),
        dict(cap=1280, m=M_SUB, ksub=16, dsub=4, tile=512, packed=True,
             alpha=2.0, masked=True),
        dict(cap=1280, m=2 * M_SUB, ksub=16, dsub=2, tile=512, packed=True,
             alpha=2.0, masked=False, q_pad=16),
    ]
    for i, case in enumerate(cases):
        shape = [case.pop(k) for k in ("cap", "m", "ksub", "dsub", "tile")]
        rows.append(_compare_b3(*_b3_operands(
            *shape, seed=90 + i, b=256, **case), "synthetic"))
        torch.cuda.empty_cache()
    return rows


def phase_c():
    """The slices' nominal shapes: B1 at cap 1024, B2 at cap 8192; B3
    8-bit (M 32 x 256, tile 256) and packed (M 64 x 16, tile 512) at cap
    1280; B4 (M 20 x 16) at cap 512; B5 (M 64 packed) at cap 1280; X1
    over a 1M x 128 bf16 table at 102,400 rows.  Beside each, its edge
    shapes."""
    import torch
    rows = []
    for i, metric in enumerate(("l2", "ip")):
        rows.append(_check_b1(1024, metric, False, 10 + i))
        rows.append(_check_b1(1024, metric, True, 20 + i))
        rows.append(_check_b2(8192, metric, 30 + i))
        torch.cuda.empty_cache()
    rows += _b1_edge_cases()
    rows += _b2_edge_cases()
    for i, (alpha, masked) in enumerate([(2.0, True), (2.0, False),
                                         (1.0, True), (1.0, False)]):
        rows.append(_compare_b3(*_b3_operands(
            1280, M_SUB, 256, 4, 256, packed=False, alpha=alpha,
            masked=masked, seed=50 + i), "synthetic"))
        torch.cuda.empty_cache()
    # packed: residual rows (masked) and raw query rows (unmasked; the
    # caller adds ||q||^2), both alpha 2
    for i, (masked, scale) in enumerate([(True, 1.0), (False, 4.0)]):
        rows.append(_compare_b3(*_b3_operands(
            1280, 2 * M_SUB, 16, 2, 512, packed=True, alpha=2.0,
            masked=masked, seed=60 + i, rg_scale=scale), "synthetic"))
        torch.cuda.empty_cache()
    rows += _b3_edge_cases()
    rows.append(_compare_adc("adc", _adc_operands(512, 20, 16, packed=False,
                                                  seed=70), "synthetic"))
    rows.append(_compare_adc("adc_fs", _adc_operands(
        1280, 2 * M_SUB, 16, packed=True, seed=71), "synthetic"))
    torch.cuda.empty_cache()
    rows += _adc_edge_cases()
    rows.append(_compare_x1(*_x1_operands(80), "synthetic"))
    torch.cuda.empty_cache()
    rows += _x1_edge_cases()
    print("phase C kernels:", json.dumps(rows))
    return rows


# ---------------------------------------------------------------------
# D. the engine
# ---------------------------------------------------------------------

def _search(eng, q, topn=TOPK, **kw):
    from gamma_tpu_torch import Request, VectorQuery
    vq = VectorQuery("emb", q, min_score=kw.pop("min_score", -np.inf),
                     max_score=kw.pop("max_score", np.inf))
    resp = eng.search(Request(vec_fields=[vq], topn=topn, **kw))
    return resp.results


def _ids(results, k=TOPK):
    out = np.full((len(results), k), -1, np.int64)
    for i, sr in enumerate(results):
        ids = [it.docid for it in sr.result_items][:k]
        out[i, :len(ids)] = ids
    return out


def _exact_topk(base, queries, k):
    """Exact float64 ground truth on the card."""
    import torch
    dev = torch.device("cuda")
    q = torch.from_numpy(queries).to(dev, torch.float64)
    qn = (q * q).sum(1, keepdim=True)
    best_d = torch.full((q.shape[0], k), float("inf"), dtype=torch.float64,
                        device=dev)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=dev)
    for s in range(0, base.shape[0], 131072):
        x = torch.from_numpy(base[s:s + 131072]).to(dev, torch.float64)
        d = qn - 2.0 * q @ x.T + (x * x).sum(1)[None, :]
        ids = torch.arange(s, s + x.shape[0], device=dev).expand_as(d)
        d = torch.cat([best_d, d], 1)
        i = torch.cat([best_i, ids], 1)
        best_d, sel = torch.topk(d, k, dim=1, largest=False)
        best_i = torch.gather(i, 1, sel)
    return best_i.cpu().numpy()


def _recall(got, gt):
    return float(np.mean([len(set(g) & set(t)) / len(t)
                          for g, t in zip(got, gt)]))


def _qps(eng, queries, reps=5, **kw):
    import torch
    _search(eng, queries, **kw)                             # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _search(eng, queries, **kw)
        times.append(time.perf_counter() - t0)
    return queries.shape[0] / float(np.median(times))


def _breakdown(eng, model, queries, reps=5, **kw):
    """Where one batch-1024 engine search spends its time: the host clock
    inside IVFPQIndex.search (synchronized, so it holds the device work)
    against the whole GammaEngine.search, and the device time of each
    kernel of one search from torch.profiler's CUDA trace, with the
    kernel launches that search made."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    inner, outer = [], []
    model_search = model.search

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model_search(*a, **kw)
        torch.cuda.synchronize()
        inner.append(time.perf_counter() - t)
        return out

    model.search = timed
    try:
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _search(eng, queries, **kw)
            outer.append(time.perf_counter() - t)
    finally:
        del model.search
    before = _launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _search(eng, queries, **kw)
        torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _launch_counts().items()
                if v > before[k]}
    dev_ms = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            dev_ms[name] = dev_ms.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    engine_ms = 1e3 * float(np.median(outer))
    busy_ms = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:10]
    return {"engine_search_ms": engine_ms,
            "model_search_ms": 1e3 * float(np.median(inner)),
            "device_busy_ms": busy_ms if dev_ms else None,
            "device_idle_share": (1.0 - busy_ms / engine_ms) if dev_ms
            else None,
            "device_ms_by_kernel": dict(top),
            "launches_per_search": launched}


class _Recorder:
    """Wraps the kernel wrappers of ops/gsq.py, ops/gadc.py, ops/adc.py
    and ops/gather_rows.py while the engines run and keeps, per (kernel,
    form), the operands of its widest call (most groups, pairs or rows),
    so phase E can hold each kernel against its plain version on exactly
    what the main paths handed it (X1: only while `x1` is set, in
    D-dense).  It launches nothing."""

    def __init__(self):
        from gamma_tpu_torch.ops import adc, gadc, gather_rows, gsq
        self.mods = {"gsq": gsq, "gsq_fold": gsq, "gadc": gadc, "adc": adc,
                     "gather_rows": gather_rows}
        self.orig = {n: getattr(m, n) for n, m in self.mods.items()}
        self.calls = {}
        self.x1 = False

    @staticmethod
    def _key_size(name, ops, kw):
        if name == "gsq":
            return (name, kw.get("masked", True)), ops[4].shape[0]
        if name == "gsq_fold":
            return (name, True), ops[4].shape[0]
        if name == "gadc":
            bias = ops[6] if len(ops) > 6 else kw.get("bias")
            return (name, kw["packed"], bias is not None), ops[3].shape[0]
        return (name,), ops[1].numel()

    def _wrap(self, name):
        fn = self.orig[name]

        def wrapper(*ops, **kw):
            if name == "gather_rows" and not self.x1:
                return fn(*ops, **kw)
            key, size = self._key_size(name, ops, kw)
            old = self.calls.get(key)
            if old is None or size > old[2]:
                self.calls[key] = (ops, dict(kw), size)
            return fn(*ops, **kw)
        return wrapper

    def start(self):
        for name, mod in self.mods.items():
            setattr(mod, name, self._wrap(name))

    def stop(self):
        for name, mod in self.mods.items():
            setattr(mod, name, self.orig[name])


def _launch_modules():
    from gamma_tpu_torch.ops import adc, gadc, gather_rows, gsq
    return gsq, gadc, adc, gather_rows


def _zero_counts():
    for mod in _launch_modules():
        for key in mod.LAUNCHES:
            mod.LAUNCHES[key] = 0


def _launch_counts():
    return {k: v for mod in _launch_modules() for k, v in mod.LAUNCHES.items()}


def _data():
    """The TPU bench's corpus generator at 1M docs, 1024 queries at +0.5
    noise (the same for every engine)."""
    sys.path.insert(0, HERE)
    from bench import _make_corpus          # the TPU bench's generator
    rng = np.random.default_rng(0)
    corpus, _ = _make_corpus(N_DOCS, D, 1024, rng)
    queries = (corpus[rng.choice(N_DOCS, 1024, replace=False)]
               + 0.5 * rng.normal(size=(1024, D))).astype(np.float32)
    return corpus, queries, rng


def _open_engine(path, model, params):
    """A fresh engine (on the card: the port's default device)."""
    from gamma_tpu_torch import (EngineConfig, FieldInfo, GammaEngine,
                                 TableInfo, VectorInfo)
    from gamma_tpu_torch.config import DataType
    eng = GammaEngine(EngineConfig(path=path))
    eng.create_table(TableInfo(
        name="smoke",
        fields=[FieldInfo("price", DataType.FLOAT, is_index=True),
                FieldInfo("tag", DataType.STRING, is_index=True)],
        vectors=[VectorInfo("emb", D)],
        indexing_size=INDEXING_SIZE,
        retrieval_types=[model], retrieval_params=[params]))
    return eng


def _ingest(eng, rows, start):
    from gamma_tpu_torch import Doc
    docs = [Doc(key=f"k{start + i}",
                fields={"price": float((start + i) % 500),
                        "tag": f"t{(start + i) % 5}"},
                vectors={"emb": rows[i]})
            for i in range(rows.shape[0])]
    assert all(c == 0 for c in eng.add_or_update_docs(docs))
    eng.flush()                  # device ingest (the indexer pump)


def _ingest_all(eng, model, corpus, n, rec):
    """n docs in batches of 100,000 (auto-train fires on the third);
    records ingest rate and training time."""
    import torch
    train_s = []
    orig_train = model.train

    def timed_train(x, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        orig_train(x, *a, **kw)
        torch.cuda.synchronize()
        train_s.append(time.perf_counter() - t)

    model.train = timed_train
    t0 = time.perf_counter()
    step = 100_000
    for s in range(0, n, step):
        _ingest(eng, corpus[s:s + step], s)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    st = eng.engine_status()
    assert st.index_status.name == "INDEXED", st
    assert st.min_indexed_num == n, st
    rec.update(ingest_s=ingest_s, docs_per_s=n / ingest_s,
               train_s=train_s[0], cap_eff=model._cap_eff())


def _serve(eng, model, corpus, queries, gt, rec, n, rp=None):
    """Self-retrieval, recall@10 against exact f64, QPS and the time
    breakdown at batch 1024, range + term hybrid, score range, every
    search with the request's retrieval params `rp`.  Returns the docs
    of the self-retrieval check."""
    from gamma_tpu_torch import RangeFilter, TermFilter
    kw = {"retrieval_params": rp} if rp else {}
    sel = np.random.default_rng(1).choice(n, 1000, replace=False)
    top1 = _ids(_search(eng, corpus[sel], **kw), 1)[:, 0]
    rec["self_top1"] = float(np.mean(top1 == sel))
    rec["recall_at_10"] = _recall(_ids(_search(eng, queries[:1000], **kw)),
                                  gt)
    rec["qps_b1024"] = _qps(eng, queries, **kw)
    assert rec["self_top1"] >= 0.99, rec
    assert rec["recall_at_10"] >= 0.95, rec
    rec["breakdown_b1024"] = _breakdown(eng, model, queries, **kw)

    # range + term hybrid: every hit satisfies both predicates
    res = _search(eng, queries[:64], fields=["price", "tag"],
                  range_filters=[RangeFilter("price", 100.0, 300.0)],
                  term_filters=[TermFilter("tag", "t1")], **kw)
    hits = [it for sr in res for it in sr.result_items]
    assert hits and all(100.0 <= it.attributes["price"] <= 300.0
                        and it.attributes["tag"] == "t1"
                        for it in hits), "hybrid predicate violated"
    rec["hybrid_hits"] = len(hits)

    # score range (scans with the unmasked kernel): scores in range
    base = _search(eng, queries[:64], **kw)
    hi = float(np.median([sr.result_items[4].score for sr in base]))
    res = _search(eng, queries[:64], min_score=0.0, max_score=hi, **kw)
    scores = [it.score for sr in res for it in sr.result_items]
    assert scores and all(0.0 <= s <= hi for s in scores), "score range"
    rec["score_range_hits"] = len(scores)
    return sel


def _delete_reload(eng, path, engines, corpus, queries, victim):
    """A deleted doc vanishes from its own search; a fresh engine loads
    the dump and returns identical ids and distances."""
    from gamma_tpu_torch import EngineConfig, GammaEngine
    assert eng.delete(f"k{victim}") == 0
    got = _ids(_search(eng, corpus[victim:victim + 1]))[0]
    assert victim not in got, "deleted doc still returned"
    res_a = _search(eng, queries[:64])
    assert eng.dump() == 0
    eng2 = GammaEngine(EngineConfig(path=path))
    engines.append(eng2)
    assert eng2.load() == 0
    res_b = _search(eng2, queries[:64])
    for ra, rb in zip(res_a, res_b):
        assert [it.docid for it in ra.result_items] == \
            [it.docid for it in rb.result_items], "ids differ on load"
        assert [it.score for it in ra.result_items] == \
            [it.score for it in rb.result_items], "dists differ on load"


def phase_d(data, recorder):
    """IVFPQ over the residual-SQ8 sidecar (B1, and B2 past a hot list)."""
    import torch
    corpus, queries, rng = data
    n = N_DOCS
    rec = {"n": n}
    path = tempfile.mkdtemp(prefix="gamma_torch_smoke_")
    engines = []
    torch.cuda.reset_peak_memory_stats()
    try:
        eng = _open_engine(path, "IVFPQ", dict(GATHER, nsubvector=M_SUB))
        engines.append(eng)
        model = eng.vm.index_for("emb")
        # every kernel count starts at 0 for the engine's own run
        _zero_counts()
        recorder.start()
        _ingest_all(eng, model, corpus, n, rec)
        gt = _exact_topk(corpus, queries[:1000], TOPK)
        sel = _serve(eng, model, corpus, queries, gt, rec, n)

        # a hot list: 4096 near-duplicates of one doc push the live
        # watermark past 4096 slots, so the scan switches to B2
        hot = (corpus[7] + 1e-3 * rng.normal(size=(4096, D))).astype(
            np.float32)
        _ingest(eng, hot, n)
        rec["cap_eff_hot"] = model._cap_eff()
        assert rec["cap_eff_hot"] >= 4096, rec
        allx = np.concatenate([corpus, hot])
        gt_hot = _exact_topk(allx, queries[:1000], TOPK)
        rec["recall_at_10_hot"] = _recall(
            _ids(_search(eng, queries[:1000])), gt_hot)
        rec["qps_b1024_hot"] = _qps(eng, queries)
        assert rec["recall_at_10_hot"] >= 0.95, rec

        _delete_reload(eng, path, engines, corpus, queries, int(sel[0]))
        torch.cuda.synchronize()
        rec["launches"] = _launch_counts()
        assert rec["launches"]["gsq"] > 0, rec
        assert rec["launches"]["gsq_fold"] > 0, rec
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        recorder.stop()
        for e in engines:
            e.close()
        shutil.rmtree(path, ignore_errors=True)
    print("phase D engine:", json.dumps(rec))
    return rec, gt


def _b4_kernel_vs_plain(eng, queries, rec):
    """The same batch-1024 search with B4 and with its plain version."""
    from gamma_tpu_torch.ops import adc
    res_k = _search(eng, queries)
    kernel = adc.adc
    adc.adc = adc._adc_plain
    try:
        res_p = _search(eng, queries)
    finally:
        adc.adc = kernel
    ik, ip_ = _ids(res_k), _ids(res_p)
    sk = np.array([[it.score for it in sr.result_items] for sr in res_k])
    sp = np.array([[it.score for it in sr.result_items] for sr in res_p])
    rec["kernel_vs_plain_id_match"] = float(np.mean(ik == ip_))
    rec["kernel_vs_plain_max_score_diff"] = float(np.abs(sk - sp).max())
    assert rec["kernel_vs_plain_id_match"] >= 0.999, rec
    assert np.allclose(np.sort(sk, 1), np.sort(sp, 1), rtol=1e-5,
                       atol=1e-5), rec


def phase_adc_engine(tag, data, gt, recorder):
    """One engine of the ADC kernels (ADC_ENGINES[tag]).  Returns its
    record and, for FastScan, the B5 operands built from its own codes."""
    import torch
    from gamma_tpu_torch.ops import ivf_scan, pq
    model_name, params, n = ADC_ENGINES[tag]
    corpus, queries, _ = data
    rec = {"engine": tag, "model": model_name, "params": params, "n": n}
    path = tempfile.mkdtemp(prefix=f"gamma_torch_smoke_{tag}_")
    engines = []
    b5_ops = None
    torch.cuda.reset_peak_memory_stats()
    try:
        eng = _open_engine(path, model_name, params)
        engines.append(eng)
        model = eng.vm.index_for("emb")
        _zero_counts()
        recorder.start()
        _ingest_all(eng, model, corpus[:n], n, rec)
        assert not model.sq_active, "the PQ payload holds no SQ8 sidecar"
        if tag == "b4":
            # depth cut to N_B4 docs: the checks are the kernel's, and
            # recall is recorded, not gated (M 20 x 4 bits)
            _b4_kernel_vs_plain(eng, queries, rec)
            gt_b4 = _exact_topk(corpus[:n], queries[:1000], TOPK)
            rec["recall_at_10"] = _recall(
                _ids(_search(eng, queries[:1000])), gt_b4)
            rec["qps_b1024"] = _qps(eng, queries)
        else:
            sel = _serve(eng, model, corpus, queries, gt, rec, n)
            if tag == "fs":
                # the same engine holds the mirror: one dense request
                rec["dense_request_recall_at_10"] = _recall(_ids(_search(
                    eng, queries[:1000],
                    retrieval_params={"scan_mode": "dense"})), gt)
                assert rec["dense_request_recall_at_10"] >= 0.95, rec
            _delete_reload(eng, path, engines, corpus, queries, int(sel[0]))
        torch.cuda.synchronize()
        rec["launches"] = _launch_counts()
        kernel = "adc" if tag == "b4" else "gadc"
        assert rec["launches"][kernel] > 0, rec
        assert rec["launches"]["gather_rows"] > 0, rec     # the rerank
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if tag == "fs":
            qd = torch.from_numpy(queries).cuda()
            _, lids = ivf_scan.coarse_assign(qd, model.centroids,
                                             model.cent_norms, NPROBE, "l2")
            b5_ops = (model.state.codes[:, :model._cap_eff()], lids,
                      pq.l2_lut(model.pq, qd))
    finally:
        recorder.stop()
        for e in engines:
            e.close()
        shutil.rmtree(path, ignore_errors=True)
    print(f"phase D-{tag} engine:", json.dumps(rec))
    return rec, b5_ops


def phase_b5(ops):
    """B5 has no engine path: its own phase scans D-fs's codes with one
    table per raw query (as tests/test_fastscan.py:93-103 checks the TPU
    kernel) and counts its launches."""
    import torch
    from gamma_tpu_torch.ops import adc
    _zero_counts()
    out = adc.adc_fs(*ops)
    torch.cuda.synchronize()
    rec = {"launches": adc.LAUNCHES["adc_fs"], "shape": list(out.shape),
           "finite": bool(torch.isfinite(out).all())}
    assert rec["launches"] > 0 and rec["finite"], rec
    print("phase D-b5 op:", json.dumps(rec))
    return rec


def _dense_stages(model, queries):
    """Device time of the stages of one unfiltered batch-1024 dense
    search, each timed alone with CUDA events (X1 by its device time,
    `device_time`) on the operands the engine
    hands dense_scan_search_fast: the GEMM over every tile, the
    bias add (the GEMM with its bias less the GEMM alone), the per-tile
    top-r and merge (the select less both), X1's row gather,
    and the rerank's distances and top-k (the rerank less X1).  Its X1
    launches are timing launches and are made after the engine's counts
    were read."""
    import torch
    from gamma_tpu_torch.config import SearchParams
    from gamma_tpu_torch.ops import dense_scan as ds
    from gamma_tpu_torch.ops import gather_rows as x1
    sp = SearchParams()
    qd = torch.from_numpy(queries).cuda()
    q = model._rotate(qd)
    recon, bias, raw = model.recon, model.recon_bias, model.store.device
    r, k = max(sp.recall_num, TOPK), TOPK
    q2 = (-2.0 * q).to(recon.dtype)
    n, b = recon.shape[0], q2.shape[0]
    tile = ds._tile_rows(b, r)

    def score(s, e):
        return ds._scores(q2, recon[s:e]).add_(bias[s:e])

    def gemm():
        for s in range(0, n, tile):
            ds._scores(q2, recon[s:min(n, s + tile)])

    def gemm_bias():
        for s in range(0, n, tile):
            score(s, min(n, s + tile))

    def select():
        return ds._tiled_min_k(score, n, b, r)

    rd, rvid = select()
    rd = rd + (q.float() ** 2).sum(-1, keepdim=True)
    flat = rvid.reshape(-1)
    t = {"gemm": cuda_time(gemm, iters=5, warmup=1),
         "gemm_bias": cuda_time(gemm_bias, iters=5, warmup=1),
         "select": cuda_time(select, iters=5, warmup=1),
         "x1": device_time(lambda: x1.gather_rows(raw, flat)),
         "rerank": cuda_time(lambda: ds._exact_rerank(
             qd, raw, rd, rvid, None, k, "l2"), iters=10),
         "whole": cuda_time(lambda: ds.dense_scan_search_fast(
             recon, bias, q, qd, raw, model.indexed_count,
             recall_num=sp.recall_num, k=k), iters=5, warmup=1)}
    # 2·B·N·d for the GEMM at the bf16 rate, and its [B, N] f32 scores
    gemm_bound, _ = _roofline(recon.numel() * 2 + b * n * 4,
                              {"bf16": 2.0 * b * n * recon.shape[1]})
    return {"rows": n, "batch": b, "tiles": -(-n // tile),
            "recall_num": r, "gemm_ms": t["gemm"],
            "gemm_bound_ms": gemm_bound,
            "bias_add_ms": t["gemm_bias"] - t["gemm"],
            "tile_topk_merge_ms": t["select"] - t["gemm_bias"],
            "x1_gather_ms": t["x1"],
            "rerank_ms": t["rerank"] - t["x1"],
            "dense_search_ms": t["whole"]}


def phase_dense(tag, data, gt, recorder):
    """IVFPQ on its default scan mode, which resolves to the dense scan
    at 1M docs (the JAX package's rule): D-dense, and D-opq with OPQ,
    which also serves the gather tier (B1) by request."""
    import torch
    from gamma_tpu_torch.config import SearchParams
    corpus, queries, _ = data
    n = N_DOCS
    params = dict(DENSE, has_opq=True) if tag == "opq" else DENSE
    rec = {"engine": tag, "model": "IVFPQ", "params": params, "n": n}
    path = tempfile.mkdtemp(prefix=f"gamma_torch_smoke_{tag}_")
    engines = []
    torch.cuda.reset_peak_memory_stats()
    try:
        eng = _open_engine(path, "IVFPQ", params)
        engines.append(eng)
        model = eng.vm.index_for("emb")
        _zero_counts()
        recorder.x1 = tag == "dense"
        recorder.start()
        _ingest_all(eng, model, corpus, n, rec)
        rec["scan_mode"] = model.scan_mode(SearchParams())
        assert rec["scan_mode"] == "dense", rec
        assert (model.opq_rot is not None) == (tag == "opq"), rec
        sel = _serve(eng, model, corpus, queries, gt, rec, n)
        if tag == "opq":
            rec["gather"] = {}
            _serve(eng, model, corpus, queries, gt, rec["gather"], n,
                   rp={"scan_mode": "gather"})
        _delete_reload(eng, path, engines, corpus, queries, int(sel[0]))
        torch.cuda.synchronize()
        rec["launches"] = _launch_counts()
        assert rec["launches"]["gather_rows"] > 0, rec
        if tag == "opq":
            assert rec["launches"]["gsq"] > 0, rec
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        recorder.stop()
        recorder.x1 = False
        if tag == "dense":
            rec["dense_stages_b1024"] = _dense_stages(model, queries)
    finally:
        recorder.stop()
        recorder.x1 = False
        for e in engines:
            e.close()
        shutil.rmtree(path, ignore_errors=True)
    print(f"phase D-{tag} engine:", json.dumps(rec))
    return rec


# ---------------------------------------------------------------------
# E. kernels against their plain versions at the engines' widths
# ---------------------------------------------------------------------

def phase_e(rec, calls, b5_ops):
    """Synthetic operands at the scan widths the SQ8 engine reached (B1
    at cap_eff with 512-slot logical tiles, B2 at the hot cap_eff with
    fold_geometry's tile), then the very operands the engines' widest
    searches handed each kernel (X1: D-dense's rerank gather), and B5
    over D-fs's codes."""
    import torch
    want = [("gsq_fold", True), ("gadc", False, True), ("gadc", True, True),
            ("adc",), ("gather_rows",)]
    assert all(k in calls for k in want) and any(
        k[0] == "gsq" for k in calls), sorted(calls)
    rows = [_check_b1(rec["cap_eff"], "l2", True, 40),
            _check_b1(rec["cap_eff"], "l2", False, 41),
            _check_b2(rec["cap_eff_hot"], "l2", 42)]
    torch.cuda.empty_cache()
    for key, (ops, kw, _) in sorted(calls.items(), key=str):
        name = key[0]
        if name == "gsq":
            rows.append(_compare_b1(ops, kw, "engine"))
        elif name == "gsq_fold":
            rows.append(_compare_b2(ops, kw, "engine"))
        elif name == "gadc":
            rows.append(_compare_b3(ops, kw, "engine"))
        elif name == "gather_rows":
            rows.append(_compare_x1(*ops, "engine"))
        else:
            rows.append(_compare_adc("adc", ops, "engine"))
        torch.cuda.empty_cache()
    rows.append(_compare_adc("adc_fs", b5_ops, "engine"))
    print("phase E kernels:", json.dumps(rows))
    return rows


def _main_row(name, rows):
    """The row whose times stand for a kernel: its widest call on an
    engine's own operands (for B3, the 8-bit masked form of D-pq's
    unfiltered searches)."""
    mine = [r for r in rows if r["kernel"] == name
            and r["operands"] == "engine"]
    if name == "gadc":
        mine = [r for r in mine if not r["packed"] and r["masked"]]
    return max(mine, key=lambda r: r.get("groups", r.get("pairs",
                                                         r.get("k", 0))))


def main():
    if len(sys.argv) > 1:
        raise SystemExit("chip_smoke: takes no arguments")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, HERE)
    try:
        import gamma_tpu_torch  # noqa: F401
    except ImportError as exc:
        raise SystemExit(f"chip_smoke: run from a checkout of the repo "
                         f"({exc})")
    phase_a()
    phase_b()
    rows = phase_c()
    data = _data()
    recorder = _Recorder()
    rec, gt = phase_d(data, recorder)
    adc_recs, b5_ops = {}, None
    for tag in ADC_ENGINES:
        adc_recs[tag], ops = phase_adc_engine(tag, data, gt, recorder)
        b5_ops = ops if ops is not None else b5_ops
    b5 = phase_b5(b5_ops)
    dense_recs = {tag: phase_dense(tag, data, gt, recorder)
                  for tag in ("dense", "opq")}
    del data
    rows += phase_e(rec, recorder.calls, b5_ops)
    recorder.calls.clear()
    runs = [rec, *adc_recs.values(), *dense_recs.values()]
    launches = {
        "gsq": sum(r["launches"]["gsq"] for r in runs),
        "gsq_fold": rec["launches"]["gsq_fold"],
        "gadc": (adc_recs["pq"]["launches"]["gadc"]
                 + adc_recs["fs"]["launches"]["gadc"]),
        "adc": adc_recs["b4"]["launches"]["adc"],
        "adc_fs": b5["launches"],
        "gather_rows": sum(r["launches"]["gather_rows"] for r in runs)}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        main_row = _main_row(name, rows)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == name),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
