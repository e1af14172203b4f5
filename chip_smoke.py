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
  D-opq    the same with OPQ, searched dense and gather (B1);
  D-flat   IVFFLAT at 1M docs: the exact scan of raw bf16 payload rows
           through B1's bf16-row form, the checks of D, delete, dump and
           load;
  D-forms  B1's f32 form and B2's bf16-row and f32 forms, which no search
           path calls, driven through grouped_sq_scan on D's sidecar and
           on D-flat's rows;
  D-flat-exact  the FLAT engine at 262,144 docs;
  D-facade      faisslike.IndexFlat / IndexIVFFlat over 100,000 docs
           beside engines of the same models;
  D-disk   IVFPQ M 32 over the SQ8 sidecar on a RocksDB vector field (the
           disk tier: no device mirror, the host rows in a memmap) at 1M
           docs: before training the searches stream the host rows
           (exact), then B1, B2 past a hot list, the checks of D;
  D-disk-pq  the same over the PQ payload (B3) with float16 host rows:
           the exact rerank reads its candidates from the host through
           the row-block LRU (hits, misses and fetch time recorded),
           set_vector_cache_mb shrinks it;
  D-scann  SCANN M 32 (anisotropic PQ, inner product) at 1M docs, dense
           and gather (B3's inner-product form, X1 in the rerank),
           recall against exact inner-product neighbours;
  D-bivf   BINARYIVF at 1M docs (Hamming over sign bits, plain torch):
           tie-aware recall, every distance recomputed.
Before D, two trainings from one seed are compared (phase D-det).
D-pq, D-fs and D-b4 rerank through X1 as well; D-fs also answers one
dense request.
Every phase raises on a failed check, so the run exits non-zero and
prints no result line; the last stdout line is the device record.

Phases (one line each): A card, B kernel build (with the registers and
spills ptxas reports for each kernel of csrc/gsq.cu), C kernels vs plain
at the slices' nominal shapes and at the edge shapes of every kernel
(group widths 8 to 128, ragged tiles and caps, strided views, code rows,
codebooks and gathered rows of other widths, both index types; the f32
forms also at live lengths inside a unit, all-masked groups and hot
lists),
D.. engines (their searches also record the
operands they hand each kernel, and a time breakdown), E kernels vs
plain at the engines' own widths and on those recorded operands.  Each
kernel row carries its time, its plain version's, the least time the
card could take for the same work (`bound_ms`: bytes over 3.35 TB/s or
operations over the peak rate of their type, the larger) and, where one
PyTorch call computes the same function, that call's time (B1's
unfolded forms: torch.baddbmm over rows gathered per group beforehand;
X1: torch.index_select).  B3's rows
also carry `smem_floor_ms`, the least time its lookups could take as a
gather from a bf16 table in shared memory (information, not the bound).
"""

from __future__ import annotations

import json
import os
import re
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
    # the same two TPU kernels over raw bf16 rows (`_rows_as`) and with
    # the f32 product (precise=True)
    "gsq_bf16": ("gamma_tpu_torch/csrc/gsq.cu",
                 "gamma_tpu/ops/pallas_gsq.py:107"),
    "gsq_precise": ("gamma_tpu_torch/csrc/gsq.cu",
                    "gamma_tpu/ops/pallas_gsq.py:107"),
    "gsq_fold_bf16": ("gamma_tpu_torch/csrc/gsq.cu",
                      "gamma_tpu/ops/pallas_gsq.py:143"),
    "gsq_fold_precise": ("gamma_tpu_torch/csrc/gsq.cu",
                         "gamma_tpu/ops/pallas_gsq.py:143"),
    "gadc": ("gamma_tpu_torch/csrc/gadc.cu",
             "gamma_tpu/ops/pallas_gadc.py:148"),
    "adc": ("gamma_tpu_torch/csrc/adc.cu", "gamma_tpu/ops/pallas_adc.py:41"),
    "adc_fs": ("gamma_tpu_torch/csrc/adc.cu",
               "gamma_tpu/ops/pallas_adc.py:116"),
    "gather_rows": ("gamma_tpu_torch/csrc/gather_rows.cu",
                    "experiments/exp_rerank.py:38"),
}


# launch count (ops/*.LAUNCHES key) → the __global__ function it launches
KERNEL_FUNCTIONS = {
    "gsq": "gsq_kernel", "gsq_bf16": "gsq_kernel",
    "gsq_precise": "gsq_precise_kernel",
    "gsq_fold": "gsq_fold_kernel", "gsq_fold_bf16": "gsq_fold_kernel",
    "gsq_fold_precise": "gsq_fold_precise_kernel",
    "gadc": "gadc_kernel", "adc": "adc_kernel", "adc_fs": "adc_kernel",
    "gather_rows": "gather_rows_kernel",
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

def _kernel_label(mangled):
    """`gsq_precise_kernel<1,16>` from a mangled entry name."""
    m = re.search(r"\d([A-Za-z]\w*?_kernel)(I(?:L[ib]\d+E)+E)?", mangled)
    if m is None:
        return mangled
    name = re.sub(r"^.*\d", "", m.group(1))   # after the length prefix
    if not m.group(2):
        return name
    return f"{name}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"


def phase_b():
    """One nvcc per source, all started together; each kernel's
    registers and spills of csrc/gsq.cu as ptxas reports them."""
    from gamma_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    names = ["gsq", "gadc", "adc", "gather_rows"]
    cuda_build.load_all(names)
    ptxas = {_kernel_label(k): v for k, v in cuda_build.ptxas_report(
        cuda_build.BUILD_LOG.get("gsq", "")).items()}
    print("phase B build:", json.dumps({
        **{f"{n}_build_s": cuda_build.BUILD_SECONDS[n] for n in names},
        "load_s": time.perf_counter() - t0,
        "build_dir": os.path.relpath(cuda_build.BUILD_DIR, HERE),
        "gsq_ptxas": ptxas}))


# ---------------------------------------------------------------------
# C. kernels against their plain versions
# ---------------------------------------------------------------------

def _operands(cap, tile, metric, masked, seed, q_pad=64, b=1024, d=D,
              wide=0, rows="u8", precise=False, hot=False, dead_lists=False):
    """Grouped operands at the main path's shapes: nlist 2048, d_pad 128,
    B 1024 x P 64 probes grouped Q = 64 per list (the edge cases pass
    another q_pad, batch or width; `wide` more slots make codes and
    norms trimmed views of a wider sidecar, the list axis strided).
    rows "bf16": raw bf16 rows (standard normal, dead slots included, so
    every row is finite) with their own squared norms and unscaled
    queries, as the IVFFlat scan hands them; `precise`: f32 queries.
    `hot`: lists 0 and 1 are full (every tile live) and an eighth of the
    queries each probe them; `dead_lists` (masked): every slot of each
    fifth list is masked, so its groups scan tiles with nothing live."""
    import torch
    from gamma_tpu_torch.ops.gadc import build_groups, group_bound
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    p = NPROBE
    if rows == "bf16":
        codes = torch.randn((NLIST, cap + wide, d), generator=g,
                            device=dev).to(torch.bfloat16)
        norms = torch.cat([(codes[s:s + 256].float() ** 2).sum(-1)
                           for s in range(0, NLIST, 256)])[:, :cap]
        codes, q_scale = codes[:, :cap], 1.0
    else:
        codes = torch.randint(0, 256, (NLIST, cap + wide, d), generator=g,
                              device=dev, dtype=torch.uint8)[:, :cap]
        q_scale = 0.02
    lens = torch.randint(1, cap + 1, (NLIST,), generator=g, device=dev,
                         dtype=torch.int32)
    if rows != "bf16":
        norms = (100.0 + 900.0 * torch.rand((NLIST, cap + wide),
                                            generator=g, device=dev))[:, :cap]
    list_ids = torch.randint(0, NLIST, (b, p), generator=g, device=dev)
    if hot:
        lens[:2] = cap
        list_ids[0::8, 0] = 0
        list_ids[1::8, 0] = 1
    g_pad = group_bound(b, p, NLIST, q_pad)
    glist, ntiles, _, _, _ = build_groups(list_ids, lens, q_pad=q_pad,
                                          tile=tile, g_pad=g_pad)
    qs = (q_scale * torch.randn((g_pad, q_pad, d), generator=g, device=dev)
          ).to(torch.float32 if precise else torch.bfloat16)
    if masked:
        pos = torch.arange(cap, device=dev)[None, :]
        dead = (pos >= lens[:, None]) | (
            torch.rand((NLIST, cap), generator=g, device=dev) < 0.05)
        if dead_lists:
            dead[2::5] = True
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


def _unmasked_visits(nrm, glist, ntiles, tile):
    """Slot-visits of all groups whose norms operand is not masked
    (< 1e37): the products a masked scan's result depends on, a masked
    slot's being its norms operand whatever the product."""
    import torch
    cnt = torch.nn.functional.pad((nrm < 1e37).long().cumsum(1), (1, 0))
    end = (ntiles.long() * tile).clamp_max(nrm.shape[1])   # a ragged last tile
    return int(cnt[glist.long().clamp_min(0), end].sum())


def _grouped_bound(row, codes, glist, ntiles, tile, slot_floats, in_bytes,
                   out_bytes, ops_of_live, nrm=None):
    """Bound of a grouped scan (B1/B2/B3): the code row and the
    `slot_floats` f32 values (norm, bias) of each slot it reads, its
    other inputs, its output; ops from the slot-visits of all groups
    (with the masked norms operand `nrm`: of the unmasked slots only)."""
    slots, visits = _list_slots(glist, ntiles, tile, codes.shape[0])
    if nrm is not None:
        visits = _unmasked_visits(nrm, glist, ntiles, tile)
    nbytes = (slots * (codes.shape[2] * codes.element_size()
                       + 4 * slot_floats) + in_bytes + out_bytes)
    row["bound_ms"], row["bound_by"] = _roofline(nbytes,
                                                 ops_of_live(visits))
    row["library_ms"] = None           # no one PyTorch call computes it
    return visits


def _b1_library_call(ops, kw, precise):
    """One PyTorch call computing B1's function: torch.baddbmm of the
    queries with the rows gathered per group (`codes[glist]`) and widened
    beforehand, rows of skipped tiles zero, added to the norms operand
    (zero past the live length where unmasked, left out without norms),
    f32 out; for the default form bf16 operands with `out_dtype=float32`,
    for the f32 form f32 operands with TF32 off (phase A).  It differs
    from the kernel in the order of the sums only.  → the call (the
    gather and widening, done here, are not part of it)."""
    import torch
    codes, nrm, glist, ntiles, qs = ops
    cap, tile = codes.shape[1], kw["tile"]
    lst = glist.long()
    live = (torch.arange(cap, device=codes.device)[None, :]
            < ntiles.long()[:, None] * tile)                  # [G, cap]
    rows = codes[lst].to(torch.float32 if precise else torch.bfloat16)
    rows.mul_(live[:, :, None].to(rows.dtype))
    rows_t = rows.transpose(1, 2)
    if kw["with_norms"]:
        base = nrm[lst]
        if not kw["masked"]:
            base = base * live
        beta = 1.0
    else:
        base, beta = torch.zeros((lst.numel(), cap), device=codes.device), 0.0
    base = base[:, None, :]
    extra = {} if precise else {"out_dtype": torch.float32}
    return lambda: torch.baddbmm(base, qs, rows_t, beta=beta,
                                 alpha=-kw["alpha"], **extra)


def _compare_b1(ops, kw, origin):
    """B1 against its plain version on operands `ops` = (codes, nrm,
    glist, ntiles, qs) with the wrapper's keywords `kw`; beside it the
    library call of `_b1_library_call`, timed, its error against the
    plain version reported (not gated)."""
    import torch
    from gamma_tpu_torch.ops import gsq
    precise = bool(kw.get("precise", False))
    kw = {k: v for k, v in kw.items() if k != "precise"}
    codes, _, _, ntiles, _ = ops
    cap, tile = codes.shape[1], kw["tile"]
    name = gsq.launch_key("gsq", codes, precise)
    kernel = lambda: gsq.gsq(*ops, precise=precise, **kw)  # noqa: E731
    got = kernel()
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
    assert torch.equal(kernel(), got), "B1 launches differ"
    row = dict(kernel=name, operands=origin, cap=cap, tile=tile,
               metric=_metric(kw["alpha"]), masked=kw["masked"],
               groups=int(ref.shape[0]), q=int(ref.shape[1]),
               d_pad=int(codes.shape[2]),
               max_abs_err=max_abs, max_rel_err=rel, bound=tol)
    assert torch.isfinite(got).all(), ("non-finite B1 output", row)
    assert max_abs <= tol, row
    assert dead_exact, ("skipped/masked B1 slots differ from plain", row)
    qs = ops[4]
    g_n, q_n = int(ref.shape[0]), int(ref.shape[1])
    if precise:
        # the f32 form must beat the default one on the same operands
        # (its queries rounded to bf16), both against the f32 plain version
        dflt = gsq.gsq(*ops[:4], qs.to(torch.bfloat16), **kw)
        row["default_form_err"] = float((dflt - ref).abs()[live].max())
        assert max_abs < row["default_form_err"], row
        del dflt
    del got, err
    library = _b1_library_call(ops, kw, precise)
    row["library_max_abs_err"] = float((library() - ref).abs()[live].max())
    row["library_call"] = ("torch.baddbmm f32, allow_tf32="
                           f"{torch.backends.cuda.matmul.allow_tf32}"
                           if precise else
                           "torch.baddbmm bf16, out_dtype=float32")
    op_type = "f32" if precise else "bf16"
    _grouped_bound(row, codes, ops[2], ntiles, tile, 1,
                   qs.numel() * qs.element_size(), ref.numel() * 4,
                   lambda v: {op_type: 2.0 * q_n * v * qs.shape[2]},
                   nrm=ops[1] if kw["masked"] else None)
    del ref, live
    row["ms"] = cuda_time(kernel, iters=20)
    row["plain_ms"] = cuda_time(lambda: gsq._gsq_plain(*ops, **kw),
                                iters=3, warmup=1)
    row["library_ms"] = cuda_time(library, iters=5)
    del library
    return row


def _compare_b2(ops, kw, origin):
    """B2 against its plain version (values, then argmins outside
    near-ties) on operands `ops` with the wrapper's keywords `kw`."""
    import torch
    from gamma_tpu_torch.ops import gsq
    precise = bool(kw.get("precise", False))
    kw = {k: v for k, v in kw.items() if k != "precise"}
    codes, _, _, ntiles, _ = ops
    cap, tile, fold = codes.shape[1], kw["tile"], kw["fold"]
    nt, lb = cap // tile, tile // fold
    name = gsq.launch_key("gsq_fold", codes, precise)
    kernel = lambda: gsq.gsq_fold(*ops, precise=precise, **kw)  # noqa: E731
    vals, args = kernel()
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
    v2, a2 = kernel()
    assert torch.equal(v2, vals) and torch.equal(a2, args), (
        "B2 launches differ")
    del v2, a2
    row = dict(kernel=name, operands=origin, cap=cap, tile=tile,
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
    if precise:
        # the f32 form must beat the default one on the same operands
        dv, _ = gsq.gsq_fold(*ops[:4], qs.to(torch.bfloat16), **kw)
        row["default_form_err"] = float((dv - pv).abs()[live].max())
        assert max_abs < row["default_form_err"], row
        del dv
    op_type = "f32" if precise else "bf16"
    _grouped_bound(row, codes, ops[2], ntiles, tile, 1,
                   qs.numel() * qs.element_size(), pv.numel() * 8,
                   lambda v: {op_type: 2.0 * q_n * v * qs.shape[2]},
                   nrm=ops[1])
    if differ.any():
        gap = float((picked[differ] - pv[differ]).abs().max())
        assert gap <= tol, ("B2 argmin is not a near-tie", gap, row)
    del full, picked, vals, args, pv, pa, live, err
    row["ms"] = cuda_time(kernel, iters=20)
    row["plain_ms"] = cuda_time(lambda: gsq._gsq_fold_plain(*ops, **kw),
                                iters=3, warmup=1)
    return row


def _check_b1(cap, metric, masked, seed, tile=None, **shape):
    tile = tile or min(512, cap)
    ops = _operands(cap, tile, metric, masked, seed, **shape)
    return _compare_b1(ops, dict(
        tile=tile, alpha=2.0 if metric == "l2" else 1.0, masked=masked,
        with_norms=masked or metric == "l2",
        precise=shape.get("precise", False)), "synthetic")


def _check_b2(cap, metric, seed, fold=8, **shape):
    from gamma_tpu_torch.ops import gsq
    tile, _ = gsq.fold_geometry(cap, 4096, fold)
    ops = _operands(cap, tile, metric, True, seed, **shape)
    return _compare_b2(ops, dict(
        tile=tile, alpha=2.0 if metric == "l2" else 1.0, fold=fold,
        precise=shape.get("precise", False)), "synthetic")


def _row_form_cases():
    """The bf16-row and f32 forms of B1/B2.  bf16 rows (B-k1a, the
    IVFFlat scan) at the nominal shape (cap 1024, d 128, G x Q 64: L2
    masked and not, IP without norms and masked) and at B1's edge shapes
    (Q 8 and 128, d_pad 48: the 16-dim chunks, cap 1000 and 999, a
    strided list view); the f32 form (B-k1b) on u8 and on bf16 rows at
    the nominal shape and at a ragged one; the folded kernel (B-k2) in
    both forms at cap 4864 / lb 608 and at a small ragged shape.
    Tolerance, every form: 1e-4 of the median magnitude of the live
    values (only the order of the f32 sums differs: u8 codes and bf16
    rows are exact operands), skipped and masked slots bit-equal, two
    launches the same bits; the f32 form's error is also below the
    default form's on the same operands."""
    import torch
    bf = dict(rows="bf16")
    rows = [_check_b1(1024, "l2", True, 110, **bf),
            _check_b1(1024, "l2", False, 111, **bf),
            _check_b1(1024, "ip", False, 112, **bf),
            _check_b1(1024, "ip", True, 113, **bf)]
    torch.cuda.empty_cache()
    rows += [_check_b1(1280, "l2", True, 114, q_pad=8, b=256, **bf),
             _check_b1(1280, "l2", False, 115, q_pad=128, b=256, **bf),
             _check_b1(1024, "l2", True, 116, q_pad=16, b=256, d=48, **bf),
             _check_b1(1000, "l2", True, 117, b=256, **bf),
             _check_b1(1000, "ip", False, 118, b=256, **bf),
             _check_b1(1280, "l2", True, 119, b=256, wide=768, **bf),
             _check_b1(999, "l2", True, 120, q_pad=32, b=256, **bf)]
    torch.cuda.empty_cache()
    rows += [_check_b1(1024, "l2", True, 121, precise=True),
             _check_b1(1024, "l2", True, 122, precise=True, **bf),
             _check_b1(999, "ip", False, 123, q_pad=32, b=256, d=48,
                       precise=True),
             _check_b1(1000, "l2", False, 124, q_pad=16, b=256, d=48,
                       precise=True, **bf)]
    torch.cuda.empty_cache()
    rows += [_check_b2(4864, "l2", 125, **bf),
             _check_b2(4864, "ip", 126, b=256, **bf),
             _check_b2(800, "l2", 127, q_pad=16, b=256, d=48, **bf),
             _check_b2(4864, "l2", 128, b=256, precise=True),
             _check_b2(4864, "l2", 129, b=256, precise=True, **bf),
             _check_b2(800, "ip", 130, q_pad=16, b=256, d=48, precise=True,
                       **bf)]
    torch.cuda.empty_cache()
    return rows


def _precise_edge_cases():
    """The f32 forms (B-k1b, B-k2 f32) at the shapes their walk must get
    right, a quarter of the batch each, u8 codes and bf16 rows both: a
    cap no span divides (999, 1000), a live length inside a 32-slot unit
    (tile 200), groups whose every slot is masked (`dead_lists`), hot
    lists with 10 live tiles (cap 4864 under tile 512), Q 8 to 128,
    d_pad 48, IP unmasked with skipped tiles, and folds over lb 200 and
    100 (no multiple of 16 divides them: a ragged last unit).  The
    checks of _compare_b1 / _compare_b2, the error also below the
    default form's."""
    import torch
    bf = dict(rows="bf16")
    rows = [_check_b1(999, "l2", True, 150, q_pad=8, b=256, precise=True),
            _check_b1(1000, "ip", False, 151, q_pad=16, b=256, precise=True,
                      **bf),
            _check_b1(1280, "l2", True, 152, tile=200, q_pad=32, b=256,
                      dead_lists=True, precise=True),
            _check_b1(4864, "l2", True, 153, b=256, hot=True, precise=True,
                      **bf),
            _check_b1(1024, "l2", False, 154, q_pad=128, b=256, d=48,
                      precise=True),
            _check_b1(1024, "ip", True, 155, q_pad=128, b=256, hot=True,
                      dead_lists=True, precise=True, **bf)]
    torch.cuda.empty_cache()
    rows += [_check_b2(1600, "l2", 156, b=256, precise=True),
             _check_b2(4864, "l2", 157, q_pad=8, b=256, hot=True,
                       dead_lists=True, precise=True),
             _check_b2(4864, "ip", 158, q_pad=128, b=256, hot=True,
                       precise=True, **bf),
             _check_b2(800, "l2", 159, q_pad=32, b=256, d=48,
                       dead_lists=True, precise=True),
             _check_b2(1600, "ip", 160, q_pad=16, b=256, precise=True, **bf)]
    torch.cuda.empty_cache()
    return rows


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
    rows += _row_form_cases()
    rows += _precise_edge_cases()
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


def _exact_topk(base, queries, k, metric="l2"):
    """Exact float64 ground truth on the card (largest inner product
    first for metric "ip")."""
    import torch
    dev = torch.device("cuda")
    q = torch.from_numpy(queries).to(dev, torch.float64)
    qn = (q * q).sum(1, keepdim=True)
    best_d = torch.full((q.shape[0], k), float("inf"), dtype=torch.float64,
                        device=dev)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=dev)
    for s in range(0, base.shape[0], 131072):
        x = torch.from_numpy(base[s:s + 131072]).to(dev, torch.float64)
        if metric == "ip":
            d = -(q @ x.T)
        else:
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
    inside the model's search (synchronized, so it holds the device work)
    against the whole GammaEngine.search, and the device time of each
    kernel of one search from torch.profiler's CUDA trace, with the
    kernel launches that search made.  `trace_short` says that the trace
    stayed short of those launches after three searches, so its sums
    read low; `trace_clock_ratio` is the trace's time of a marker kernel
    (atan over 1 GiB, launched after the search and left out of the
    sums) over its time by CUDA events outside the trace, and
    `trace_clock_off` says that it stayed more than 10% from 1, so the
    trace's times are scaled by about that much."""
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
    # a trace can lose events, and a sum over a trace with holes reads
    # low: a trace is whole when it holds every launch the wrappers
    # counted (LAUNCHES) and as many device kernels as the host made
    # launch calls, and its clock is right when it times a marker kernel
    # as CUDA events did before it (events inside a trace also time the
    # tracer's launch overhead); a short or mistimed one is taken again,
    # three times at most.  What a trace loses is its first events, so
    # each starts with a few small kernels that are not counted either.
    best = None
    marker = torch.zeros(1 << 28, device="cuda")
    marker_events_ms = cuda_time(marker.atan_, iters=10)
    lead, n_lead = torch.zeros(1024, device="cuda"), 32
    for attempt in range(1, 4):
        before = _launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_lead):
                lead.asinh_()
            torch.cuda.synchronize()
            _search(eng, queries, **kw)
            marker.atan_()
            torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _launch_counts().items()
                    if v > before[k]}
        dev_ms, seen, n_dev = {}, {}, 0
        n_calls = -(n_lead + 1)            # less the lead's and the marker's
        marker_ms = None
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and "atan_kernel" in e.name:
                marker_ms = e.time_range.elapsed_us() / 1e3
            elif (e.device_type == DeviceType.CUDA
                  and "asinh_kernel" not in e.name):
                dev_ms[e.name[:60]] = (dev_ms.get(e.name[:60], 0.0)
                                       + e.time_range.elapsed_us() / 1e3)
                if not e.name.startswith(("Memcpy", "Memset")):
                    n_dev += 1
                for fn in set(KERNEL_FUNCTIONS.values()):
                    if re.search(rf"(?<![A-Za-z_]){fn}[<(]", e.name):
                        seen[fn] = seen.get(fn, 0) + 1
            elif e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
                n_calls += 1
        want = {}
        for key, n in launched.items():
            fn = KERNEL_FUNCTIONS[key]
            want[fn] = want.get(fn, 0) + n
        short = n_dev < n_calls or any(seen.get(fn, 0) < n
                                       for fn, n in want.items())
        ratio = marker_ms / marker_events_ms if marker_ms else None
        off = ratio is None or abs(ratio - 1.0) > 0.1
        trace = dict(dev_ms=dev_ms, launched=launched, seen=seen,
                     n_dev=n_dev, n_calls=n_calls, short=short,
                     ratio=ratio, off=off)
        # a right clock first, then the fuller trace
        if best is None or (off, -n_dev) < (best["off"], -best["n_dev"]):
            best = trace
        if not short and not off:
            break
    del marker, lead
    dev_ms = best["dev_ms"]
    engine_ms = 1e3 * float(np.median(outer))
    busy_ms = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:10]
    return {"engine_search_ms": engine_ms,
            "model_search_ms": 1e3 * float(np.median(inner)),
            "device_busy_ms": busy_ms if dev_ms else None,
            "device_idle_share": (1.0 - busy_ms / engine_ms) if dev_ms
            else None,
            "device_ms_by_kernel": dict(top),
            "launches_per_search": best["launched"],
            "kernels_in_trace": best["seen"],
            "device_kernels_in_trace": best["n_dev"],
            "host_launch_calls": best["n_calls"],
            "trace_attempts": attempt,
            "trace_short": best["short"],
            "trace_clock_ratio": best["ratio"],
            "trace_clock_off": best["off"]}


class _Recorder:
    """Wraps the kernel wrappers of ops/gsq.py, ops/gadc.py, ops/adc.py
    and ops/gather_rows.py while the engines run and keeps, per (kernel,
    form: row type and product of B1/B2, masked or not, packed or not,
    and B3's table scale alpha, which tells L2 from inner product),
    the operands of its widest call (most groups, pairs or rows),
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
        if name in ("gsq", "gsq_fold"):
            from gamma_tpu_torch.ops.gsq import launch_key
            form = launch_key(name, ops[0], kw.get("precise", False))
            return (form, kw.get("masked", True)), ops[4].shape[0]
        if name == "gadc":
            bias = ops[6] if len(ops) > 6 else kw.get("bias")
            return ((name, kw["packed"], bias is not None, kw["alpha"]),
                    ops[3].shape[0])
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


def _open_engine(path, model, params, indexing_size=None,
                 store_type="MemoryOnly", store_param=None):
    """A fresh engine (on the card: the port's default device)."""
    from gamma_tpu_torch import (EngineConfig, FieldInfo, GammaEngine,
                                 TableInfo, VectorInfo)
    from gamma_tpu_torch.config import DataType
    eng = GammaEngine(EngineConfig(path=path))
    eng.create_table(TableInfo(
        name="smoke",
        fields=[FieldInfo("price", DataType.FLOAT, is_index=True),
                FieldInfo("tag", DataType.STRING, is_index=True)],
        vectors=[VectorInfo("emb", D, store_type=store_type,
                            store_param=dict(store_param or {}))],
        indexing_size=indexing_size or INDEXING_SIZE,
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


def _ingest_all(eng, model, corpus, n, rec, start=0):
    """Docs [start, n) in batches of 100,000 (auto-train fires on the
    third); records ingest rate and training time."""
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
    for s in range(start, n, step):
        _ingest(eng, corpus[s:min(n, s + step)], s)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    st = eng.engine_status()
    assert st.index_status.name == "INDEXED", st
    assert st.min_indexed_num == n, st
    rec.update(ingest_s=ingest_s, docs_per_s=(n - start) / ingest_s,
               train_s=train_s[0] if train_s else None,   # FLAT trains nothing
               cap_eff=getattr(model, "_cap_eff", lambda: None)())


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


def _delete_reload(eng, path, engines, corpus, queries, victim, rp=None):
    """A deleted doc vanishes from its own search; a fresh engine loads
    the dump and returns identical ids and distances (every search with
    the request's retrieval params `rp`, or with each of a list of
    them)."""
    from gamma_tpu_torch import EngineConfig, GammaEngine
    kws = [{"retrieval_params": r} if r else {}
           for r in (rp if isinstance(rp, list) else [rp])]
    assert eng.delete(f"k{victim}") == 0
    for kw in kws:
        got = _ids(_search(eng, corpus[victim:victim + 1], **kw))[0]
        assert victim not in got, "deleted doc still returned"
    res_a = [_search(eng, queries[:64], **kw) for kw in kws]
    assert eng.dump() == 0
    eng2 = GammaEngine(EngineConfig(path=path))
    engines.append(eng2)
    assert eng2.load() == 0
    res_b = [_search(eng2, queries[:64], **kw) for kw in kws]
    for ra, rb in zip(sum(res_a, []), sum(res_b, [])):
        assert [it.docid for it in ra.result_items] == \
            [it.docid for it in rb.result_items], "ids differ on load"
        assert [it.score for it in ra.result_items] == \
            [it.score for it in rb.result_items], "dists differ on load"


def phase_determinism(data):
    """Two builds of phase D's model from one seed: train on the same
    262,144 rows, ingest the same 300,000, then compare what a search
    reads.  Reports which parts differ (nothing is gated on it): an
    unordered accumulation in training would show in the centroids and
    in everything fit or placed after them.  Also times one centroid
    update's sums by index_add_ and by the ordered _cluster_sums, each
    twice, and says whether the two results of each are the same bits
    (the ordered ones must be)."""
    import torch
    from gamma_tpu_torch.index import create_model
    from gamma_tpu_torch.ops import kmeans as km
    from gamma_tpu_torch.vector.raw_store import RawVectorStore
    corpus = data[0]
    n_add, builds, train_s = 300_000, [], []
    for _ in range(2):
        store = RawVectorStore("emb", D)
        store.add(corpus[:n_add])
        store.flush_device()
        m = create_model("IVFPQ", store, dict(GATHER, nsubvector=M_SUB))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.train(corpus[:INDEXING_SIZE])
        torch.cuda.synchronize()
        train_s.append(time.perf_counter() - t0)
        for s in range(0, n_add, 65536):
            e = min(n_add, s + 65536)
            ids = np.arange(s, e, dtype=np.int64)
            m.add(store.device_rows(s, e), ids, ids)
        st = m.state
        builds.append({
            "centroids": m.centroids, "codebooks": m.pq.codebooks,
            "sq_scale": m.sq_scale, "sq_off": m.sq_off, "lens": st.lens,
            "vids": st.vids, "codes": st.codes, "sq_codes": m.sq_codes,
            "sq_norms": m.sq_norms})
        del m, store
    a, b = builds
    rec = {"n_train": INDEXING_SIZE, "n_add": n_add, "train_s": train_s,
           "differ": [k for k in a if not torch.equal(a[k], b[k])],
           "max_abs_diff": {k: float((a[k].float() - b[k].float()).abs()
                                     .max()) for k in a}}
    # one centroid update's sums both ways: index_add_ adds with atomics,
    # in an order of the device's choosing; training uses _cluster_sums
    x = torch.from_numpy(corpus[:INDEXING_SIZE]).cuda()
    cents = a["centroids"]
    assign = km.assign_nearest(x, cents)

    def unordered():
        return torch.zeros_like(cents).index_add_(0, assign, x)

    def ordered():
        return km._cluster_sums(x, assign, cents.shape[0])[0]

    rec["sums"] = {
        "index_add_twice_equal": bool(torch.equal(unordered(), unordered())),
        "index_add_twice_max_abs_diff": float(
            (unordered() - unordered()).abs().max()),
        "index_add_ms": cuda_time(unordered, iters=5),
        "cluster_sums_twice_equal": bool(torch.equal(ordered(), ordered())),
        "cluster_sums_ms": cuda_time(ordered, iters=5)}
    assert rec["sums"]["cluster_sums_twice_equal"], rec
    del a, b, builds, x, cents, assign
    torch.cuda.empty_cache()
    print("phase D-det determinism:", json.dumps(rec))
    return rec


def _memory(eng):
    """What engine_status counts (the disk tier: no host bytes, an 8-row
    store mirror) beside what the card holds."""
    import torch
    st = eng.engine_status()
    return {"vector_mem_bytes": st.vector_mem_bytes,
            "index_mem_bytes": st.index_mem_bytes,
            "device_allocated_gb": torch.cuda.memory_allocated() / 2 ** 30}


def _hot_list(eng, model, corpus, queries, rng, rec, n):
    """A hot list: 4096 near-duplicates of one doc push the live
    watermark past 4096 slots, so the SQ8 scan switches to B2."""
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

        rec["memory"] = _memory(eng)
        _hot_list(eng, model, corpus, queries, rng, rec, n)
        _delete_reload(eng, path, engines, corpus, queries, int(sel[0]))
        torch.cuda.synchronize()
        rec["launches"] = _launch_counts()
        assert rec["launches"]["gsq"] > 0, rec
        assert rec["launches"]["gsq_fold"] > 0, rec
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        # the f32 product over u8 codes, on this engine's sidecar
        snap = model._snapshot()
        eff = min(snap.cap_eff, snap.sq_codes.shape[1])
        rec["forms"] = _drive_forms(
            "sq8", snap.sq_codes[:, :eff], snap.sq_norms[:, :eff],
            snap.state.lens, snap.state.docids, queries, model.centroids,
            model.cent_norms, model.sq_scale, model.sq_off, model.centroids)
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


def _drive_forms(tag, codes, norms, lens, docids, queries, centroids,
                 cent_norms, scale, off, res_cents):
    """B1's f32 form and B2's bf16-row and f32 forms have no caller on a
    search path (the IVFFlat scan runs B1 with fold 1, the SQ8 scan the
    default product): drive their wrappers through grouped_sq_scan on an
    engine's own rows (`codes`: its SQ8 sidecar, or its bf16 payload rows
    with scale/off None) for the masked L2 scan of its batch-1024 search,
    count their launches from 0 and hold the results together: the f32
    product within the bf16 query rounding of the default one, each
    folded result equal to the strided min of its unfolded one (to the
    order of the sums)."""
    import torch
    from gamma_tpu_torch.ops import gsq, ivf_scan
    qd = torch.from_numpy(queries).cuda()
    _, lids = ivf_scan.coarse_assign(qd, centroids, cent_norms, NPROBE,
                                     "l2")
    cap = codes.shape[1]
    bias = ivf_scan.list_bias(docids[:, :cap], lens, cap,
                              live_n=N_DOCS + 8192)
    fold = 8
    tile, lb = gsq.fold_geometry(cap, 4096, fold)
    _zero_counts()

    def scan(**kw):
        return gsq.grouped_sq_scan(codes, norms, lens, lids, qd, scale, off,
                                   res_cents, metric="l2", bias=bias, **kw)

    rec = {"engine": tag, "rows": str(codes.dtype).split(".")[-1],
           "cap": cap, "fold_tile": tile, "lb": lb}
    base = scan()
    live = base < 1e37
    med = float(base[live].abs().median())
    b, p = lids.shape
    for name, kw in (("default", {}), ("precise", {"precise": True})):
        full = scan(**kw) if kw else base
        assert torch.equal(full < 1e37, live), (name, "mask differs")
        if kw:
            # the default form rounds the query to bf16 (2^-9 relative on
            # q.x, which is of the distances' magnitude)
            rec["precise_vs_default_max"] = float(
                (full - base)[live].abs().max())
            assert rec["precise_vs_default_max"] <= 3e-2 * med, rec
        fv, fa = scan(fold=fold, tile=tile, **kw)
        strided = torch.clamp_max(full, BIG).reshape(
            b, p, cap // tile, fold, lb).amin(3).reshape(b, p, -1)
        ok = strided < 1e37
        err = float((fv - strided)[ok].abs().max())
        rec[f"fold_vs_strided_min_{name}"] = err
        assert err <= 1e-4 * max(1.0, med), rec
        assert bool((fv[~ok] >= 1e37).all()), rec
        assert int(fa.min()) >= 0 and int(fa.max()) < fold, rec
        del full, fv, fa, strided, ok
    torch.cuda.synchronize()
    rec["launches"] = {k: v for k, v in _launch_counts().items() if v}
    print(f"phase D-forms {tag}:", json.dumps(rec))
    return rec


def phase_ivfflat(data, gt, recorder):
    """D-flat: the IVFFLAT engine at 1M docs.  Its scan is B1 over the
    raw bf16 payload rows (B-k1a); nprobe comes with every request, as
    the model takes it from nowhere else."""
    import torch
    from gamma_tpu_torch.ops import ivf_scan
    corpus, queries, _ = data
    n = N_DOCS
    params, rp = {"ncentroids": NLIST}, {"nprobe": NPROBE}
    rec = {"engine": "flat", "model": "IVFFLAT", "params": params,
           "request_params": rp, "n": n}
    path = tempfile.mkdtemp(prefix="gamma_torch_smoke_flat_")
    engines = []
    torch.cuda.reset_peak_memory_stats()
    try:
        eng = _open_engine(path, "IVFFLAT", params)
        engines.append(eng)
        model = eng.vm.index_for("emb")
        _zero_counts()
        recorder.start()
        _ingest_all(eng, model, corpus, n, rec)
        rec["payload_gb"] = model.state.codes.numel() / 2 ** 30
        sel = _serve(eng, model, corpus, queries, gt, rec, n, rp=rp)
        _delete_reload(eng, path, engines, corpus, queries, int(sel[0]),
                       rp=rp)
        torch.cuda.synchronize()
        rec["launches"] = _launch_counts()
        assert rec["launches"]["gsq_bf16"] > 0, rec
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        st = ivf_scan._trim_state(model.state, model._cap_eff())
        rows = ivf_scan.payload_rows(st.codes, D)
        forms = _drive_forms("flat", rows, ivf_scan._row_norms(rows),
                             st.lens, st.docids, queries, model.centroids,
                             model.cent_norms, None, None, None)
    finally:
        recorder.stop()
        for e in engines:
            e.close()
        shutil.rmtree(path, ignore_errors=True)
    print("phase D-flat engine:", json.dumps(rec))
    return rec, forms


N_FLAT = INDEXING_SIZE         # what a brute-force fallback scans at most
N_FACADE = 100_000


def phase_flat_engine(data):
    """The FLAT engine at 262,144 docs (an exact scan of the store
    mirror, no kernel of the port), through the same gates."""
    import torch
    corpus, queries, _ = data
    n = N_FLAT
    rec = {"engine": "flat-exact", "model": "FLAT", "n": n}
    path = tempfile.mkdtemp(prefix="gamma_torch_smoke_flatx_")
    engines = []
    try:
        eng = _open_engine(path, "FLAT", {})
        engines.append(eng)
        model = eng.vm.index_for("emb")
        _ingest_all(eng, model, corpus[:n], n, rec)
        gt = _exact_topk(corpus[:n], queries[:1000], TOPK)
        sel = _serve(eng, model, corpus, queries, gt, rec, n)
        _delete_reload(eng, path, engines, corpus, queries, int(sel[0]))
        torch.cuda.synchronize()
    finally:
        for e in engines:
            e.close()
        shutil.rmtree(path, ignore_errors=True)
    print("phase D-flat-exact engine:", json.dumps(rec))
    return rec


def phase_facade(data):
    """faisslike.IndexFlat and IndexIVFFlat over a 100k slice, beside
    engines of the same models over the same docs (both trained on the
    first 50,000): D, I of the facade against the engines' scores and
    ids, and against the exact f64 neighbours."""
    import torch
    from gamma_tpu_torch import faisslike
    corpus, queries, _ = data
    n, k, nlist, nprobe = N_FACADE, TOPK, 256, 64
    x = corpus[:n]
    gt = _exact_topk(x, queries, k)
    rec = {"n": n, "nlist": nlist, "nprobe": nprobe}
    for name, cls, kw, rp in (
            ("FLAT", faisslike.IndexFlat, {}, {}),
            ("IVFFLAT", faisslike.IndexIVFFlat, {"nlist": nlist},
             {"nprobe": nprobe})):
        idx = cls(D, **kw)
        assert idx.device.type == "cuda", idx.device
        idx.train(x[:n // 2])
        t0 = time.perf_counter()
        idx.add(x)
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t0
        dist, ids = idx.search(queries, k, **rp)
        path = tempfile.mkdtemp(prefix="gamma_torch_smoke_facade_")
        eng = _open_engine(path, name, {"ncentroids": nlist} if kw else {},
                           indexing_size=n // 2)
        try:
            for s in range(0, n, n // 2):
                _ingest(eng, x[s:s + n // 2], s)
            res = _search(eng, queries, **(
                {"retrieval_params": rp} if rp else {}))
        finally:
            eng.close()
            shutil.rmtree(path, ignore_errors=True)
        eids = _ids(res)
        escore = np.array([[it.score for it in sr.result_items][:k]
                           for sr in res], np.float32)
        r = {"facade_add_docs_per_s": n / add_s,
             "recall_at_10": _recall(ids, gt),
             "ids_equal_engine": float(np.mean(ids == eids)),
             "overlap_engine": _recall(ids, eids),
             "max_score_diff": float(np.abs(np.sort(dist, 1)
                                            - np.sort(escore, 1)).max())}
        rec[name] = r
        assert ids.dtype == np.int64 and dist.dtype == np.float32, r
        assert r["recall_at_10"] >= (0.99 if name == "FLAT" else 0.95), r
        assert r["overlap_engine"] >= 0.99, r
        assert r["max_score_diff"] <= 1e-2 * float(np.median(dist)), r
        gone = int(ids[0, 0])
        idx.remove_ids(np.array([gone]))
        assert gone not in idx.search(queries[:1], k, **rp)[1], r
        del idx
        torch.cuda.empty_cache()
    print("phase D-facade:", json.dumps(rec))
    return rec


# ---------------------------------------------------------------------
# D-disk.. the disk tier, SCANN and BINARYIVF
# ---------------------------------------------------------------------

N_PRETRAIN = 100_000     # docs the disk engines hold before they train


def _stream_check(eng, base, queries):
    """Before training, a disk engine's searches stream the host rows
    through the card (flat_search_streaming).  Each query's ids are the
    exact f64 top-10 of `base` (the rows as stored), an id swapped only
    for one whose f64 distance ties the 10th within 1e-5 relative, and
    each score is its id's f64 distance within f32 round-off of the norm
    expansion: 2e-5 x (||q||^2 + ||x||^2), about twice the textbook
    bound d * u * 2|q||x| of the f32 product at d 128."""
    import torch
    dev = torch.device("cuda")
    res = _search(eng, queries)
    got = _ids(res)
    assert (got >= 0).all(), "the streaming scan left slots empty"
    score = np.array([[it.score for it in sr.result_items][:TOPK]
                      for sr in res], np.float64)
    q = torch.from_numpy(queries).to(dev, torch.float64)
    x = torch.from_numpy(base).to(dev, torch.float64)
    d = ((q * q).sum(1, keepdim=True) - 2.0 * q @ x.T
         + (x * x).sum(1)[None, :])
    td, ti = torch.topk(d, TOPK + 1, dim=1, largest=False)
    td, ti = td.cpu().numpy(), ti.cpu().numpy()
    got_d = ((q[:, None, :] - x[torch.from_numpy(got).to(dev)]) ** 2).sum(
        -1).cpu().numpy()
    same, swapped_ties = 0, 0
    for i in range(queries.shape[0]):
        extra = set(got[i]) - set(ti[i, :TOPK])
        if not extra:
            same += 1
            continue
        tol = 1e-5 * max(1.0, td[i, TOPK - 1])
        ok = all(abs(got_d[i][list(got[i]).index(e)] - td[i, TOPK - 1])
                 <= tol for e in extra)
        assert ok, ("streamed ids are not an exact top-10", i, got[i],
                    ti[i])
        swapped_ties += 1
    err = np.abs(score - got_d)
    scale = ((q * q).sum(1)[:, None] + (x * x).sum(1)[
        torch.from_numpy(got).to(dev)]).cpu().numpy()
    rec = {"queries": int(queries.shape[0]), "rows": int(base.shape[0]),
           "ids_equal_f64": same / queries.shape[0],
           "swapped_at_ties": swapped_ties,
           "max_abs_dist_err": float(err.max()),
           "max_err_over_norms": float((err / scale).max())}
    assert (err <= 2e-5 * scale).all(), rec
    return rec


def _lru_probe(eng, model, store, queries):
    """One batch-1024 search of a disk engine over the PQ payload, with
    the host fetch inside the model search timed (store.get_padded, the
    rerank's read-through) and the row-block LRU's hits and misses in
    it."""
    import torch
    cache = store._row_cache
    fetch, inner = [], []
    get_padded, model_search = store.get_padded, model.search

    def timed_fetch(v):
        t = time.perf_counter()
        out = get_padded(v)
        fetch.append((time.perf_counter() - t, int(np.asarray(v).size)))
        return out

    def timed_search(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model_search(*a, **kw)
        torch.cuda.synchronize()
        inner.append(time.perf_counter() - t)
        return out

    store.get_padded, model.search = timed_fetch, timed_search
    try:
        h0, m0 = cache.hits, cache.misses
        _search(eng, queries)
    finally:
        del store.get_padded, model.search
    return {"model_search_ms": 1e3 * sum(inner),
            "host_fetch_ms": 1e3 * sum(t for t, _ in fetch),
            "host_fetch_share": sum(t for t, _ in fetch) / sum(inner),
            "rows_fetched": sum(r for _, r in fetch),
            "lru_hits": cache.hits - h0, "lru_misses": cache.misses - m0,
            "cache_mem_bytes": store.cache_mem_bytes(),
            "cache_capacity_bytes": cache._capacity,
            "block_bytes": cache._block_bytes}


def phase_disk(tag, data, gt, recorder):
    """The disk tier (store_type RocksDB / Disk): no device mirror, the
    host rows in a memmap.  D-disk ("disk"): IVFPQ M 32 over the SQ8
    sidecar (B1, B2 past a hot list; no rerank).  D-disk-pq
    ("disk-pq"): IVFPQ M 32 x 8 bit over the PQ payload (B3), float16
    host rows, the exact rerank of recall_num 100 over candidate rows
    read from the host through the row-block LRU."""
    import torch
    corpus, queries, rng = data
    n = N_DOCS
    pq = tag == "disk-pq"
    params = dict(GATHER, nsubvector=M_SUB,
                  **({"gather_payload": "pq"} if pq else {}))
    store_type, store_param = (("Disk", {"host_dtype": "float16"}) if pq
                               else ("RocksDB", {}))
    rec = {"engine": tag, "model": "IVFPQ", "params": params,
           "store_type": store_type, "store_param": store_param, "n": n}
    path = tempfile.mkdtemp(prefix=f"gamma_torch_smoke_{tag}_")
    engines = []
    torch.cuda.reset_peak_memory_stats()
    try:
        eng = _open_engine(path, "IVFPQ", params, store_type=store_type,
                           store_param=store_param)
        engines.append(eng)
        model, store = eng.vm.index_for("emb"), eng.vm.stores["emb"]
        assert store.tier == "disk", store.tier
        _zero_counts()
        recorder.start()
        _ingest(eng, corpus[:N_PRETRAIN], 0)
        assert not model.trained()
        stored = corpus[:N_PRETRAIN].astype(store.host_dtype).astype(
            np.float32)
        rec["pretrain_streaming"] = _stream_check(eng, stored,
                                                  queries[:256])
        assert not any(_launch_counts().values()), _launch_counts()
        _ingest_all(eng, model, corpus, n, rec, start=N_PRETRAIN)
        rec["store_device_rows"] = int(store.device.shape[0])
        rec["recon_rows"] = int(model.recon.shape[0])
        assert rec["store_device_rows"] == 8 and rec["recon_rows"] == 8, rec
        assert model.sq_active != pq, rec
        rec["memory"] = _memory(eng)
        sel = _serve(eng, model, corpus, queries, gt, rec, n)
        if pq:
            # the default 64 MB cache, then one that holds every block
            # (warmed by one search), then 8 MB: set_vector_cache_mb
            # must shrink what the cache holds
            lru = rec["lru"] = {"64mb": _lru_probe(eng, model, store,
                                                   queries)}
            eng.set_vector_cache_mb(1024)
            _search(eng, queries)
            lru["1024mb_warm"] = _lru_probe(eng, model, store, queries)
            held = store.cache_mem_bytes()
            eng.set_vector_cache_mb(8)
            lru["shrunk_from_bytes"] = held
            lru["8mb"] = _lru_probe(eng, model, store, queries)
            assert store.cache_mem_bytes() <= 8 << 20 < held, lru
        else:
            _hot_list(eng, model, corpus, queries, rng, rec, n)
        _delete_reload(eng, path, engines, corpus, queries, int(sel[0]))
        torch.cuda.synchronize()
        rec["launches"] = _launch_counts()
        if pq:
            assert rec["launches"]["gadc"] > 0, rec
        else:
            assert rec["launches"]["gsq"] > 0, rec
            assert rec["launches"]["gsq_fold"] > 0, rec
        # the disk tier reranks host rows: no gather from a mirror
        assert rec["launches"]["gather_rows"] == 0, rec
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        recorder.stop()
        for e in engines:
            e.close()
        shutil.rmtree(path, ignore_errors=True)
    print(f"phase D-{tag} engine:", json.dumps(rec))
    return rec


def phase_scann(data, recorder):
    """D-scann: SCANN M 32 (anisotropic PQ, inner product) at 1M docs on
    its default scan mode (dense while the mirror fits), then gather
    with the exact rerank (B3's inner-product form, X1), recall_num 256
    as bench.py's secondary section; recall against exact f64
    inner-product neighbours in both modes."""
    import torch
    from gamma_tpu_torch.config import SearchParams
    corpus, queries, _ = data
    n = N_DOCS
    params = dict(DENSE, metric_type="InnerProduct")
    rps = {"dense": {"recall_num": 256},
           "gather": {"scan_mode": "gather", "has_rank": True,
                      "recall_num": 256}}
    rec = {"engine": "scann", "model": "SCANN", "params": params,
           "request_params": rps, "n": n}
    path = tempfile.mkdtemp(prefix="gamma_torch_smoke_scann_")
    engines = []
    torch.cuda.reset_peak_memory_stats()
    try:
        eng = _open_engine(path, "SCANN", params)
        engines.append(eng)
        model = eng.vm.index_for("emb")
        _zero_counts()
        recorder.start()
        _ingest_all(eng, model, corpus, n, rec)
        rec["scan_mode"] = model.scan_mode(SearchParams())
        assert rec["scan_mode"] == "dense", rec
        gt_ip = _exact_topk(corpus, queries[:1000], TOPK, metric="ip")
        for mode, rp in rps.items():
            r = rec[mode] = {}
            r["recall_at_10"] = _recall(_ids(_search(
                eng, queries[:1000], retrieval_params=rp)), gt_ip)
            r["qps_b1024"] = _qps(eng, queries, retrieval_params=rp)
            r["breakdown_b1024"] = _breakdown(eng, model, queries,
                                              retrieval_params=rp)
            assert r["recall_at_10"] >= 0.95, rec
        _delete_reload(eng, path, engines, corpus, queries,
                       int(gt_ip[0, 0]), rp=list(rps.values()))
        torch.cuda.synchronize()
        rec["launches"] = _launch_counts()
        assert rec["launches"]["gadc"] > 0, rec
        assert rec["launches"]["gather_rows"] > 0, rec
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        recorder.stop()
        for e in engines:
            e.close()
        shutil.rmtree(path, ignore_errors=True)
    print("phase D-scann engine:", json.dumps(rec))
    return rec


def _hamming_to(corpus, queries, k):
    """Exact Hamming distances of the sign bits, computed apart from the
    port's popcount: with s = +1 where x > 0 else -1 over D dims, the
    Hamming distance is (D - s_q . s_x) / 2, an integer the f32 product
    of +-1 rows holds exactly.  → (kth [nq] f32: each query's k-th
    smallest distance over the corpus, dist(i, ids) → f32 distances of
    query i to the rows ids)."""
    import torch
    dev = torch.device("cuda")
    sq = torch.where(torch.from_numpy(queries).to(dev) > 0, 1.0, -1.0)
    best = torch.full((queries.shape[0], k), float(D), device=dev)
    for s in range(0, corpus.shape[0], 131072):
        sx = torch.where(torch.from_numpy(corpus[s:s + 131072]).to(dev) > 0,
                         1.0, -1.0)
        h = (D - sq @ sx.T) / 2.0
        best = torch.topk(torch.cat([best, h], 1), k, dim=1,
                          largest=False).values
    kth = best[:, k - 1].cpu().numpy()

    def dist(i, ids):
        x = torch.from_numpy(corpus[ids]).to(dev)
        return ((D - torch.where(x > 0, 1.0, -1.0) @ sq[i]) / 2.0
                ).cpu().numpy()
    return kth, dist


def phase_bivf(data, recorder):
    """D-bivf: BINARYIVF (Hamming over the sign bits; XOR and a
    population count in plain torch, no kernel) at 1M docs, nlist 2048,
    nprobe 64 with each request.  Recall is bench.py's tie-aware one:
    found ids whose distance is <= the exact 10th (Hamming distances are
    small integers, so the top-10 boundary is a plateau of ties)."""
    import torch
    corpus, queries, _ = data
    n = N_DOCS
    params, rp = {"ncentroids": NLIST}, {"nprobe": NPROBE}
    rec = {"engine": "bivf", "model": "BINARYIVF", "params": params,
           "request_params": rp, "n": n}
    path = tempfile.mkdtemp(prefix="gamma_torch_smoke_bivf_")
    engines = []
    torch.cuda.reset_peak_memory_stats()
    try:
        eng = _open_engine(path, "BINARYIVF", params)
        engines.append(eng)
        model = eng.vm.index_for("emb")
        _zero_counts()
        recorder.start()
        _ingest_all(eng, model, corpus, n, rec)
        rec["list_cap"] = int(model.state.cap)
        kth, dist = _hamming_to(corpus, queries[:1000], TOPK)
        res = _search(eng, queries[:1000], retrieval_params=rp)
        hits, worst = 0, 0.0
        for i, sr in enumerate(res):
            ids = np.array([it.docid for it in sr.result_items], np.int64)
            score = np.array([it.score for it in sr.result_items],
                             np.float32)
            exact = dist(i, ids)
            worst = max(worst, float(np.abs(score - exact).max()))
            hits += int((exact <= kth[i]).sum())
        rec["recall_at_10_tie_aware"] = hits / (TOPK * len(res))
        rec["max_dist_err"] = worst
        assert worst == 0.0, "a returned distance is not its Hamming distance"
        assert rec["recall_at_10_tie_aware"] >= 0.95, rec
        rec["qps_b1024"] = _qps(eng, queries, retrieval_params=rp)
        rec["breakdown_b1024"] = _breakdown(eng, model, queries,
                                            retrieval_params=rp)
        # the victim: a doc its own search returns (the coarse step ranks
        # lists by the Hamming distance to binarized centroids, ingest by
        # the distance to the float ones, so a doc's list may be missed)
        cand = np.arange(1000, 1016)
        own = _ids(_search(eng, corpus[cand], retrieval_params=rp))
        found = [int(c) for c, row in zip(cand, own) if c in row]
        rec["self_found_share"] = len(found) / cand.size
        assert found, rec
        victim = found[0]
        _delete_reload(eng, path, engines, corpus, queries, victim, rp=rp)
        torch.cuda.synchronize()
        rec["launches"] = _launch_counts()
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        recorder.stop()
        for e in engines:
            e.close()
        shutil.rmtree(path, ignore_errors=True)
    print("phase D-bivf engine:", json.dumps(rec))
    return rec


# ---------------------------------------------------------------------
# E. kernels against their plain versions at the engines' widths
# ---------------------------------------------------------------------

def phase_e(rec, flat_rec, calls, b5_ops):
    """Synthetic operands at the scan widths the SQ8 engine reached (B1
    at cap_eff with 512-slot logical tiles, B2 at the hot cap_eff with
    fold_geometry's tile), then the very operands the engines' widest
    searches handed each kernel (X1: D-dense's rerank gather; B1 over
    bf16 rows: D-flat's scan, at its width also on synthetic rows; the
    f32 and folded forms: the D-forms runs; B3 in its L2 forms from D-pq
    and D-fs and in its inner-product form from D-scann's gather
    searches), and B5 over D-fs's codes."""
    import torch
    want = [("gsq_fold", True), ("gadc", False, True, 2.0),
            ("gadc", True, True, 2.0), ("gadc", False, True, 1.0),
            ("adc",), ("gather_rows",), ("gsq_bf16", True),
            ("gsq_bf16", False), ("gsq_precise", True),
            ("gsq_fold_bf16", True), ("gsq_fold_precise", True)]
    assert all(k in calls for k in want) and any(
        k[0] == "gsq" for k in calls), sorted(calls, key=str)
    rows = [_check_b1(rec["cap_eff"], "l2", True, 40),
            _check_b1(rec["cap_eff"], "l2", False, 41),
            _check_b2(rec["cap_eff_hot"], "l2", 42),
            _check_b1(flat_rec["cap_eff"], "l2", True, 140, rows="bf16")]
    torch.cuda.empty_cache()
    for key, (ops, kw, _) in sorted(calls.items(), key=str):
        name = key[0]
        if name.startswith("gsq_fold"):
            rows.append(_compare_b2(ops, kw, "engine"))
        elif name.startswith("gsq"):
            rows.append(_compare_b1(ops, kw, "engine"))
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
    engine's own operands (for B3, the 8-bit masked L2 form of D-pq's
    unfiltered searches; D-scann's inner-product form is a row of its
    own in phase E)."""
    mine = [r for r in rows if r["kernel"] == name
            and r["operands"] == "engine"]
    assert mine, f"no engine operands were recorded for {name}"
    if name == "gadc":
        mine = [r for r in mine if not r["packed"] and r["masked"]
                and r["metric"] == "l2"]
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
    phase_determinism(data)
    rec, gt = phase_d(data, recorder)
    adc_recs, b5_ops = {}, None
    for tag in ADC_ENGINES:
        adc_recs[tag], ops = phase_adc_engine(tag, data, gt, recorder)
        b5_ops = ops if ops is not None else b5_ops
    b5 = phase_b5(b5_ops)
    dense_recs = {tag: phase_dense(tag, data, gt, recorder)
                  for tag in ("dense", "opq")}
    flat_rec, flat_forms = phase_ivfflat(data, gt, recorder)
    phase_flat_engine(data)
    phase_facade(data)
    disk_recs = {tag: phase_disk(tag, data, gt, recorder)
                 for tag in ("disk", "disk-pq")}
    scann_rec = phase_scann(data, recorder)
    phase_bivf(data, recorder)
    del data
    rows += phase_e(rec, flat_rec, recorder.calls, b5_ops)
    recorder.calls.clear()
    runs = [rec, *adc_recs.values(), *dense_recs.values(),
            *disk_recs.values(), scann_rec]
    forms = [rec["forms"]["launches"], flat_forms["launches"]]
    launches = {
        "gsq": sum(r["launches"]["gsq"] for r in runs),
        "gsq_fold": (rec["launches"]["gsq_fold"]
                     + disk_recs["disk"]["launches"]["gsq_fold"]),
        "gsq_bf16": flat_rec["launches"]["gsq_bf16"],
        "gsq_precise": sum(f.get("gsq_precise", 0) for f in forms),
        "gsq_fold_bf16": flat_forms["launches"].get("gsq_fold_bf16", 0),
        "gsq_fold_precise": sum(f.get("gsq_fold_precise", 0)
                                for f in forms),
        "gadc": (adc_recs["pq"]["launches"]["gadc"]
                 + adc_recs["fs"]["launches"]["gadc"]
                 + disk_recs["disk-pq"]["launches"]["gadc"]
                 + scann_rec["launches"]["gadc"]),
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
