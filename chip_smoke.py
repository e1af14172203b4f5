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
  D-store  D-dense's engine over gamma_tpu's store options: the fp8
           (e4m3) store mirror, zstd-compressed vector segments and
           table columns, native incremental persistence; 1M docs in
           two halves with a dump after each, searched dense (X1 over
           fp8 rows) and gather (B1), loaded by a fresh engine; gates
           (one line each): the mirror at half D-dense's bytes, recall
           at the tier's floor, X1 bit for bit on the engine's own fp8
           rows, the second dump a delta over sealed zstd frames, the
           load answering alike;
  D-store-sweep  FLAT, IVFFLAT, HNSW, SCANN, IVFPQ_FASTSCAN and BINARYIVF
           over an fp8 mirror at 50,000 docs, recall at the tier's floor;
  D-crash  a child process commits 100,000 docs to a FLAT engine (zstd,
           native persistence), flushes 10,000 more and exits before a
           second dump; a fresh engine here finds exactly the committed
           docs and the answers the child printed;
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
           tie-aware recall, every distance recomputed;
  D-hnsw   HNSW (nlinks 32, efSearch 64, plain torch) at 1M docs: the
           graph rebuilt at each 1.25x growth (from two k-means
           partitions past 300,000 rows), the checks of D, a realtime
           tail below the next rebuild, delete, dump and load;
  D-hnsw-200k  HNSWIndex alone at the TPU bench's 200k secondary
           geometry (the exact kNN build), beside the TPU's figure;
  D-serve  the port's socket server in this process and a GammaClient
           over TCP: IVFPQ M 32 at 1M docs ingested over the wire,
           dense (X1) and gather (B1) requests held against an
           in-process engine fed alike, the wire's share of a request;
           then a GammaRouter over two local partition servers at
           262,144 docs, and its failover when one server stops.
  D-rt     at the end of D and D-pq, before their D-shard: search during
           ingest.  tools/perf_torch.py's batch and 8-caller sweeps,
           quiescent; then 65,536 docs of the corpus's distribution
           ingested beside 8 caller threads (batch 1, batch 64,
           filtered) and the background indexer, the script's own
           flush() beside it, the sharded search turned on halfway;
           gates: no docid twice, filters hold, one live slot a vid,
           self top-1 of the new docs single and sharded, recall@10
           within 0.002 of before (ground truth over the grown corpus);
  D-shard  at the end of D, D-pq, D-fs and D-dense, the same engine's
           multi-device serving (enable_sharded_search): a 1 x 1 mesh of
           the card, and a 2 x 4 mesh of eight shards on it (B1 / B3
           and X1 once a shard): recall against the single search, the
           single engine's distances at local_probe = nprobe, a delete
           after the snapshot, a realtime tail, snapshot memory, and the
           shard bodies' kernels against their plain versions.
  D-10M    after phase E, once the 1M corpus is freed: bench.py's 10M
           capacity tiers at the model level (a RawVectorStore and an
           IVFPQIndex): 10M x 128 over a bf16 store mirror, M 32 on the
           PQ payload with 6 rebalance rounds; the dense scan, a gather
           over the PQ codes (B3), release_recon(), build_sq_sidecar()
           and the SQ8 folded scan (B2) with sq_rerank; peak device
           memory after every step;
  D-vgg    bench.py's VGG-1M: 1M x 512 over an f32 store mirror, M 64 on
           the SQ8 payload; the dense scan (X1 on 2 KB f32 rows) and an
           SQ8 gather (B1 at d_pad 512).  Both hold their kernels
           against the plain versions on their own operands.
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

import gc
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
INGEST_BATCH = 100_000         # docs a phase adds before each flush
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
# the corpus generator's geometry, set by _data()
GEOM = {"basis_centers": None}
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
    ok = (idx >= 0) & (idx < n)
    valid = int(ok.sum())
    # the rows a gather must read: each distinct valid index once (a
    # batch of repeated queries repeats its candidates)
    distinct = int(torch.unique(idx[ok]).numel())
    row = dict(kernel="gather_rows", operands=origin, n=n, d=d,
               k=int(idx.numel()), dtype=str(table.dtype).split(".")[-1],
               idx_dtype=str(idx.dtype).split(".")[-1], valid_rows=valid,
               distinct_rows=distinct,
               bitexact=bool(torch.equal(got.view(torch.uint8),
                                         ref.view(torch.uint8))),
               max_abs_err=float((got.float() - ref.float()).abs().max()))
    assert row["bitexact"], row
    row.update(_index_stats(idx, n))
    row["bound_ms"], row["bound_by"] = _x1_bound(
        distinct, idx.numel(), d * table.element_size(), idx.element_size())
    del got, ref
    clamped = idx.clamp(0, n - 1)
    row["ms"] = device_time(lambda: x1.gather_rows(table, idx))
    row["events_ms"] = cuda_time(lambda: x1.gather_rows(table, idx),
                                 iters=50)
    row["plain_ms"] = device_time(lambda: x1._gather_rows_plain(table, idx))
    row["library_ms"] = device_time(
        lambda: torch.index_select(table, 0, clamped))
    return row


def _x1_bound(distinct, k, row_bytes, idx_bytes):
    """X1's least time: each distinct valid row read once, every output
    row written once, the index read once."""
    return _roofline(distinct * row_bytes + k * (row_bytes + idx_bytes), {})


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
    kernel of one search (`_trace`)."""
    import torch
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
    engine_ms = 1e3 * float(np.median(outer))
    return {"engine_search_ms": engine_ms,
            "model_search_ms": 1e3 * float(np.median(inner)),
            **_trace(lambda: _search(eng, queries, **kw), engine_ms)}


def _trace(call, host_ms):
    """The device time of each kernel of one `call` from torch.profiler's
    CUDA trace, with the kernel launches it made, and the device's idle
    share of `host_ms`.  `trace_short` says that the trace stayed short
    of those launches after three calls, so its sums read low;
    `trace_clock_ratio` is the trace's time of a marker kernel (atan
    over 1 GiB, launched after the call and left out of the sums) over
    its time by CUDA events outside the trace, and `trace_clock_off`
    says that it stayed more than 10% from 1, so the trace's times are
    scaled by about that much."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
            call()
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
    busy_ms = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:10]
    return {"device_busy_ms": busy_ms if dev_ms else None,
            "device_idle_share": (1.0 - busy_ms / host_ms) if dev_ms
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
    D-dense and D-store, and by its row type beyond bf16).  It launches
    nothing."""

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
        if name == "gather_rows":
            # X1 by its row type beyond bf16 (D-store's fp8 mirror)
            dtype = str(ops[0].dtype).split(".")[-1]
            if dtype != "bfloat16":
                return (name, dtype), ops[1].numel()
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
    noise (the same for every engine).  Its geometry (basis, centers)
    stays in GEOM for D-rt's inserts."""
    sys.path.insert(0, HERE)
    from bench import _make_corpus          # the TPU bench's generator
    rng = np.random.default_rng(0)
    corpus, GEOM["basis_centers"] = _make_corpus(N_DOCS, D, 1024, rng)
    queries = (corpus[rng.choice(N_DOCS, 1024, replace=False)]
               + 0.5 * rng.normal(size=(1024, D))).astype(np.float32)
    return corpus, queries, rng


def _table(model, params, indexing_size=None, store_type="MemoryOnly",
           store_param=None):
    """The table every engine of the script holds: two indexed scalar
    fields and one vector field "emb"."""
    from gamma_tpu_torch import FieldInfo, TableInfo, VectorInfo
    from gamma_tpu_torch.config import DataType
    return TableInfo(
        name="smoke",
        fields=[FieldInfo("price", DataType.FLOAT, is_index=True),
                FieldInfo("tag", DataType.STRING, is_index=True)],
        vectors=[VectorInfo("emb", D, store_type=store_type,
                            store_param=dict(store_param or {}))],
        indexing_size=indexing_size or INDEXING_SIZE,
        retrieval_types=[model], retrieval_params=[params])


def _open_engine(path, model, params, indexing_size=None,
                 store_type="MemoryOnly", store_param=None):
    """A fresh engine (on the card: the port's default device)."""
    from gamma_tpu_torch import EngineConfig, GammaEngine
    eng = GammaEngine(EngineConfig(path=path))
    eng.create_table(_table(model, params, indexing_size, store_type,
                            store_param))
    return eng


def _docs(rows, start):
    """Docs k{start}.. with the scalar fields every phase filters on."""
    from gamma_tpu_torch import Doc
    return [Doc(key=f"k{start + i}",
                fields={"price": float((start + i) % 500),
                        "tag": f"t{(start + i) % 5}"},
                vectors={"emb": rows[i]})
            for i in range(rows.shape[0])]


def _ingest(eng, rows, start):
    assert all(c == 0 for c in eng.add_or_update_docs(_docs(rows, start)))
    eng.flush()                  # device ingest (the indexer pump)


def _ingest_all(eng, model, corpus, n, rec, start=0):
    """Docs [start, n) in batches of INGEST_BATCH (auto-train fires on
    the third); records ingest rate and training time."""
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
    for s in range(start, n, INGEST_BATCH):
        _ingest(eng, corpus[s:min(n, s + INGEST_BATCH)], s)
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
    them).  → whether the dump was native (segments + commit marker):
    the engine falls back to whole-corpus dumps when the native library
    does not load, as gamma_tpu's does."""
    from gamma_tpu_torch import EngineConfig, GammaEngine
    kws = _request_kws(rp)
    assert eng.delete(f"k{victim}") == 0
    for kw in kws:
        got = _ids(_search(eng, corpus[victim:victim + 1], **kw))[0]
        assert victim not in got, "deleted doc still returned"
    res_a = [_search(eng, queries[:64], **kw) for kw in kws]
    assert eng.dump() == 0
    eng2 = GammaEngine(EngineConfig(path=path))
    engines.append(eng2)
    assert eng2.load() == 0
    _same_results(res_a, [_search(eng2, queries[:64], **kw) for kw in kws])
    return eng._native_persist


def _request_kws(rp):
    """Search kwargs for the request's retrieval params `rp`, or for each
    of a list of them."""
    return [{"retrieval_params": r} if r else {}
            for r in (rp if isinstance(rp, list) else [rp])]


def _same_results(res_a, res_b):
    """Two lists of searches' results hold identical ids and scores."""
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
    return gt_hot, allx


# ---------------------------------------------------------------------
# D-rt: search during ingest, several callers at once
# ---------------------------------------------------------------------

RT_ENGINES = ("d", "pq")   # the engines D-rt runs on, at their phases' end
N_RT = 65_536              # docs ingested beside the callers
RT_BATCH = 4096            # docs an add_or_update_docs call
RT_CALLERS = 8
RT_RANGE = (100.0, 300.0)  # the filtered requests' price range
RT_RECS = []               # each D-rt run's record


def _rt_rows():
    """N_RT docs more of the corpus generator's data (its geometry, a
    seed of their own): inserts that land in the trained lists."""
    from bench import _make_corpus
    rows, _ = _make_corpus(N_RT, D, 0, np.random.default_rng(11),
                           geom=GEOM["basis_centers"])
    return rows


def _filtered(eng, q):
    from gamma_tpu_torch import RangeFilter
    return _search(eng, q, fields=["price"],
                   range_filters=[RangeFilter("price", *RT_RANGE)])


class _Callers:
    """RT_CALLERS threads searching without pause until stopped, each in
    turn: one doc of the corpus by its own vector (batch 1, through the
    batcher while the search is single), 64 of the phase's queries, 16
    of them filtered on price.  Every result is checked for a docid twice, every
    filtered hit for its range; a thread's exception is kept and raised
    by join()."""

    KINDS = ("b1", "b64", "filtered")

    def __init__(self, eng, corpus, queries):
        import threading
        self.eng, self.corpus, self.queries = eng, corpus, queries
        self.stop = threading.Event()
        self.errors, self.logs = [], []
        self.threads = [threading.Thread(target=self._run, args=(i,),
                                         daemon=True)
                        for i in range(RT_CALLERS)]

    def _run(self, tid):
        # a search: (kind, mode, ms); mode "single", "sharded" or, for
        # this caller's first sharded one (which may wait for the
        # snapshot's build), "first_sharded"
        log = {"searches": [], "results": 0, "dups": [], "self": [0, 0],
               "filter_bad": 0, "sharded": 0, "queries": 0}
        self.logs.append(log)
        rng = np.random.default_rng(100 + tid)
        turn = tid
        try:
            while not self.stop.is_set():
                kind = self.KINDS[turn % 3]
                turn += 1
                sharded = self.eng._sharded is not None
                t0 = time.perf_counter()
                if kind == "b1":
                    doc = int(rng.integers(self.corpus.shape[0]))
                    res = _search(self.eng, self.corpus[doc:doc + 1])
                elif kind == "b64":
                    s0 = int(rng.integers(self.queries.shape[0] - 64))
                    res = _search(self.eng, self.queries[s0:s0 + 64])
                else:
                    s0 = int(rng.integers(self.queries.shape[0] - 16))
                    res = _filtered(self.eng, self.queries[s0:s0 + 16])
                mode = ("single" if not sharded else "sharded"
                        if log["sharded"] else "first_sharded")
                log["searches"].append(
                    (kind, mode, 1e3 * (time.perf_counter() - t0)))
                log["sharded"] += sharded
                log["queries"] += len(res)
                for sr in res:
                    ids = [it.docid for it in sr.result_items]
                    log["results"] += 1
                    if len(ids) != len(set(ids)):
                        log["dups"].append(ids)
                    if kind == "filtered":
                        log["filter_bad"] += sum(
                            not RT_RANGE[0] <= it.attributes["price"]
                            <= RT_RANGE[1] for it in sr.result_items)
                if kind == "b1":
                    log["self"][0] += bool(res[0].result_items
                                           and res[0].result_items[0].docid
                                           == doc)
                    log["self"][1] += 1
        except Exception as exc:           # noqa: BLE001 - join() raises
            self.errors.append(exc)

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def sharded(self):
        """Sharded searches done so far."""
        return sum(lg["sharded"] for lg in list(self.logs))

    def halt(self):
        self.stop.set()
        for t in self.threads:
            t.join(120)

    def join(self):
        self.halt()
        assert not any(t.is_alive() for t in self.threads), "callers hang"
        if self.errors:
            raise self.errors[0]

    def record(self, wall_s):
        logs = self.logs
        searches = [x for lg in logs for x in lg["searches"]]

        def total(key):
            return sum(lg[key] for lg in logs)

        def spread(sel):
            ms = [x[2] for x in searches if sel(x)]
            return {"searches": len(ms),
                    "p50_ms": float(np.percentile(ms, 50)),
                    "p99_ms": float(np.percentile(ms, 99)),
                    "max_ms": float(np.max(ms))} if ms else None

        return {
            "queries": total("queries"),
            "caller_qps": total("queries") / wall_s,
            "all": spread(lambda x: True),
            "by_kind": {k: spread(lambda x, k=k: x[0] == k)
                        for k in self.KINDS},
            "by_mode": {m: spread(lambda x, m=m: x[1] == m)
                        for m in ("single", "sharded", "first_sharded")},
            "sharded_searches": total("sharded"),
            "results": total("results"),
            "results_with_a_docid_twice": sum(len(lg["dups"])
                                              for lg in logs),
            "dup_examples": [d for lg in logs for d in lg["dups"]][:3],
            "filtered_hits_out_of_range": total("filter_bad"),
            "self_top1": (sum(lg["self"][0] for lg in logs)
                          / max(1, sum(lg["self"][1] for lg in logs))),
            "self_searches": sum(lg["self"][1] for lg in logs)}


def _self_top1(eng, rows, first):
    """Share of rows[i] whose own search answers doc first + i at top-1
    (batch 1024), and whether the last row's does."""
    hits = 0
    for s0 in range(0, rows.shape[0], 1024):
        top = _ids(_search(eng, rows[s0:s0 + 1024]), 1)[:, 0]
        hits += int(np.sum(top == first + s0 + np.arange(top.shape[0])))
    last = _ids(_search(eng, rows[-1:]), 1)[0, 0]
    return hits / rows.shape[0], bool(last == first + rows.shape[0] - 1)


def phase_rt(tag, eng, model, held, queries, gt):
    """D-rt on one engine at the end of its phase (before its D-shard):
    search during ingest with several callers at once.

    (a) quiescent: tools/perf_torch.py's batch sweep over the phase's
    1024 queries, filtered on price, and its thread sweep at 8 callers;
    (b) the background indexer every 0.05 s while 8 caller threads
    search without pause (_Callers) and this thread ingests N_RT docs of
    the corpus's distribution in batches of RT_BATCH, calling flush()
    itself after every second batch (its pump beside the background
    one); (c) halfway, enable_sharded_search on a 2 x 4 mesh of eight
    shards on the card, so the callers' searches take snapshots while
    rows are indexed and not yet mirrored; (d) the indexer stopped, a
    last flush, then the gates: no docid twice in any caller's result,
    every filtered hit in range, the callers' batch-1 searches find
    their own doc (>= 0.99), indexed_count == store.n, live posted slots
    == indexed vids less the deleted ones (each vid once), self top-1
    >= 0.99 over the new docs and the last one found, sharded and
    single, and recall@10 of the phase's 1000 queries no lower than
    before it by more than 0.002, the ground truth recomputed over the
    grown corpus (`held`, the rows the engine held before, in docid
    order, then the new ones).  Returns that ground truth."""
    import threading
    import torch
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import perf_torch
    from gamma_tpu_torch import RangeFilter, Request, VectorQuery
    t_phase = time.perf_counter()
    rec = {"engine": tag}
    store = model.store
    base = eng.table.n
    assert base == held.shape[0], (base, held.shape)
    new = _rt_rows()
    q1k = queries[:1000]
    rec["recall_at_10_before"] = _recall(_ids(_search(eng, q1k)), gt)
    _zero_counts()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def make_req(qb):
        return Request(topn=TOPK, vec_fields=[VectorQuery("emb", qb)],
                       range_filters=[RangeFilter("price", *RT_RANGE)])

    def quiet(line):
        pass

    rec["quiescent"] = {
        "batch_sweep": perf_torch.batch_sweep(eng, queries, make_req,
                                              log=quiet),
        "threads_8": perf_torch.thread_sweep(eng, queries, make_req,
                                             RT_CALLERS, log=quiet)}

    # every pump counted: by whom, whether it moved rows (a call that
    # waited for the other's lock finds none left), host ms
    pumps = {"background": 0, "caller": 0, "ms": [], "calls": [],
             "empty_ms": []}
    lock = threading.Lock()
    real_pump = eng.vm.add_rt_vecs_to_index

    def counted_pump():
        t0 = time.perf_counter()
        moved = real_pump()
        ms = 1e3 * (time.perf_counter() - t0)
        who = ("background" if threading.current_thread()
               is eng._indexer_thread else "caller")
        with lock:
            pumps["calls"].append(who)
            if moved:
                pumps[who] += 1
                pumps["ms"].append(ms)
            else:
                pumps["empty_ms"].append(ms)
        return moved

    eng.vm.add_rt_vecs_to_index = counted_pump
    callers = _Callers(eng, held[:N_DOCS], queries)
    n_batches = N_RT // RT_BATCH
    try:
        eng.start_background_indexer(interval_s=0.05)
        callers.start()
        t0, wait_s = time.perf_counter(), 0.0
        for b in range(n_batches):
            s0 = b * RT_BATCH
            assert all(c == 0 for c in eng.add_or_update_docs(
                _docs(new[s0:s0 + RT_BATCH], base + s0)))
            if b % 2 == 1:
                eng.flush()
            if b == n_batches // 2 - 1:
                eng.enable_sharded_search(
                    n_list_shards=SHARD_MESH[0],
                    n_query_shards=SHARD_MESH[1],
                    devices=[eng.device] * 8)
                # the second half starts once every caller has searched
                # sharded (its snapshot taken beside the pumps); the wait
                # is not ingest time
                tw = time.perf_counter()
                while (callers.sharded() < RT_CALLERS
                       and not callers.errors
                       and time.perf_counter() - tw < 60):
                    time.sleep(0.005)
                wait_s += time.perf_counter() - tw
        eng.stop_background_indexer()
        eng.flush()
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0 - wait_s
        callers.join()
        wall_s = time.perf_counter() - t0
    finally:
        callers.halt()
        eng.stop_background_indexer()
        del eng.vm.add_rt_vecs_to_index            # the bound method again
    under = callers.record(wall_s)
    rec["ingest_docs_per_s"] = N_RT / ingest_s
    rec["ingest_s"] = ingest_s
    rec["wait_for_sharded_s"] = wait_s
    rec["under_ingest"] = under
    rec["pumps"] = {"background": pumps["background"],
                    "caller": pumps["caller"],
                    "calls_background": pumps["calls"].count("background"),
                    "calls_caller": pumps["calls"].count("caller"),
                    "p50_ms": float(np.percentile(pumps["ms"], 50)),
                    "max_ms": float(np.max(pumps["ms"])),
                    "empty_max_ms": max(pumps["empty_ms"], default=0.0)}
    rec["peak_gb_over_before"] = (torch.cuda.max_memory_allocated()
                                  - mem0) / 2 ** 30
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    assert under["results_with_a_docid_twice"] == 0, rec
    assert under["filtered_hits_out_of_range"] == 0, rec
    assert under["self_top1"] >= 0.99, rec
    assert under["sharded_searches"] > 0, rec

    # the lists: one live slot a vid, every indexed vid but the deleted
    rec["indexed_count"] = model.indexed_count
    assert model.indexed_count == store.n == base + N_RT, rec
    st = model.state
    live = ((st.docids >= 0)
            & (torch.arange(st.cap, device=st.lens.device)[None, :]
               < st.lens[:, None]))
    vids = st.vids[live]
    rec["live_slots"] = int(vids.numel())
    rec["distinct_live_vids"] = int(torch.unique(vids).numel())
    rec["deleted_docs"] = eng.delete_num
    assert (rec["live_slots"] == rec["distinct_live_vids"]
            == model.indexed_count - eng.delete_num), rec

    # the new docs by their own vectors: sharded (the snapshot taken
    # halfway, the tail after it), then single
    rec["self_top1_new_sharded"], last_sh = _self_top1(eng, new, base)
    gt_grown = _exact_topk(np.concatenate([held, new]), q1k, TOPK)
    rec["recall_at_10_after_sharded"] = _recall(_ids(_search(eng, q1k)),
                                                gt_grown)
    eng.disable_sharded_search()
    rec["self_top1_new_single"], last_single = _self_top1(eng, new, base)
    rec["recall_at_10_after"] = _recall(_ids(_search(eng, q1k)), gt_grown)
    res = _filtered(eng, q1k[:64])
    assert res and all(RT_RANGE[0] <= it.attributes["price"] <= RT_RANGE[1]
                       for sr in res for it in sr.result_items), rec
    assert last_sh and last_single, rec
    assert rec["self_top1_new_sharded"] >= 0.99, rec
    assert rec["self_top1_new_single"] >= 0.99, rec
    assert (rec["recall_at_10_after"]
            >= rec["recall_at_10_before"] - 0.002), rec
    torch.cuda.synchronize()
    rec["launches"] = _launch_counts()
    scan = SHARD_SCAN[tag]
    assert rec["launches"][scan] > 0, rec
    if tag == "pq":
        assert rec["launches"]["gather_rows"] > 0, rec
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"phase D-rt {tag}:", json.dumps(rec))
    RT_RECS.append(rec)
    return gt_grown


# ---------------------------------------------------------------------
# D-shard: multi-device serving on the engines of D, D-pq, D-fs, D-dense
# ---------------------------------------------------------------------

SHARD_MESH = (4, 2)       # MULTICHIP_r05.json's mesh: 4 list x 2 query shards
N_SHARD_TAIL = 8192       # docs ingested after the snapshot (realtime tail)
# the scan kernel of each engine's shard body (D-dense: none, X1 alone)
SHARD_SCAN = {"d": "gsq", "pq": "gadc", "fs": "gadc", "dense": None}
SHARD_RECS = []           # each D-shard run's record
SHARD_ROWS = []           # kernels vs plain on the shard bodies' operands


def _scores(results, k=TOPK):
    out = np.full((len(results), k), np.inf)
    for i, sr in enumerate(results):
        sc = [it.score for it in sr.result_items][:k]
        out[i, :len(sc)] = sc
    return out


def _search_ms(eng, queries, reps=3):
    """Host milliseconds of one engine search (synchronized), median."""
    import torch
    _search(eng, queries)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _search(eng, queries)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return 1e3 * float(np.median(times))


def _sharded_exact_probe(eng, model, mode, queries):
    """The engine's own snapshot searched through sharded_*_search_fn at
    local_probe = nprobe (the single-device candidate set), under the
    engine's validity penalty → dists [b, k]."""
    import torch
    from gamma_tpu_torch import parallel as par
    from gamma_tpu_torch.config import SearchParams
    mesh = eng._sharded["mesh"]
    snapped = eng._sharded[mode][0]
    rn = max(SearchParams().recall_num, TOPK)
    qd = torch.from_numpy(queries).to(eng.device)
    q = model._rotate(qd)
    pen = eng._validity
    if mode == "dense":
        d, _ = par.sharded_dense_search_fn(
            mesh, recall_num=rn, k=TOPK,
            rows_per_shard=snapped.rows_per_shard)(
                snapped, q, eng._pad_pen(pen, snapped.recon.shape[0]), qd)
    elif mode == "sq":
        d, _, _ = par.sharded_ivfsq_search_fn(
            mesh, nprobe=NPROBE, k=TOPK, local_probe=NPROBE)(
                snapped, q, eng._pad_pen(pen, max(eng.max_docid, 1)))
    else:
        d, _, _ = par.sharded_ivfpq_search_fn(
            mesh, nprobe=NPROBE, recall_num=rn, k=TOPK, local_probe=NPROBE,
            v_per_shard=snapped.v_per_shard, packed=model.packed_codes,
            by_residual=model.by_residual)(
                snapped, q, eng._pad_pen(pen, snapped.raw.shape[0]), qd)
    return d.cpu().numpy()


def _mesh_run(eng, queries, gt, single_recall, rec, **mesh):
    """Enable a mesh, search: recall@10 (>= 0.95 and within 0.005 of the
    engine's single-device recall), the launches of one batch-1024
    search, its host ms."""
    eng.enable_sharded_search(**mesh)
    rec["recall_at_10"] = _recall(_ids(_search(eng, queries[:1000])), gt)
    before = _launch_counts()
    _search(eng, queries)
    rec["launches_per_search"] = {k: v - before[k] for k, v in
                                  _launch_counts().items() if v > before[k]}
    rec["ms_b1024"] = _search_ms(eng, queries)
    assert rec["recall_at_10"] >= 0.95, rec
    assert abs(rec["recall_at_10"] - single_recall) <= 0.005, rec
    return rec["launches_per_search"]


def phase_shard(tag, eng, model, corpus, queries, gt):
    """D-shard on one engine at the end of its phase: the engine's
    single-device search first (recall, batch-1024 ms), then its
    sharded search (enable_sharded_search) on the default 1 x 1 mesh of
    the card, on every card where there are several, and on a 2 x 4
    mesh of eight shards on cuda:0 (MULTICHIP_r05.json's layout).  On
    the 2 x 4 mesh: recall@10 at the default local_probe, the launches
    of one batch-1024 search (the scan kernel and X1 once a shard: 8),
    its ms and the snapshot's memory; through sharded_*_search_fn at
    local_probe = nprobe the single engine's distances (to 1e-3 on 99%
    of the queries at least: the selects are near-exact past 16,384
    candidates a query, so a near-tie may fall the other way); a doc
    deleted after the snapshot vanishes; N_SHARD_TAIL docs ingested
    after it are found (the realtime tail), none twice in a result.
    The counts are zeroed before the sharded searches and read after
    them; then each kernel is held against its plain version on the
    widest operands the shard bodies of the 2 x 4 mesh handed it."""
    import torch
    scan = SHARD_SCAN[tag]
    mode = {"d": "sq", "dense": "dense"}.get(tag, "index")
    rec = {"engine": tag, "mode": mode}
    q1k = queries[:1000]
    single = _search(eng, q1k)
    rec["single_recall_at_10"] = _recall(_ids(single), gt)
    rec["single_ms_b1024"] = _search_ms(eng, queries)
    t0 = time.perf_counter()
    recorder = _Recorder()
    recorder.x1 = True
    _zero_counts()
    try:
        # the sharded body on one real card (bench.py:579's figure)
        card = eng.device              # the engine's card: cuda:0
        one = _mesh_run(eng, queries, gt, rec["single_recall_at_10"],
                        rec.setdefault("mesh_1x1", {}), devices=[card])
        assert one.get(scan or "gather_rows", 0) == 1, rec
        if torch.cuda.device_count() > 1:
            # the default mesh: every card, one list shard each
            _mesh_run(eng, queries, gt, rec["single_recall_at_10"],
                      rec.setdefault("mesh_all_cards", {}))
        torch.cuda.synchronize()
        eng.disable_sharded_search()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grid = rec.setdefault("mesh_2x4", {})
        recorder.start()            # the shard bodies' own operands
        per = _mesh_run(eng, queries, gt, rec["single_recall_at_10"], grid,
                        n_list_shards=SHARD_MESH[0],
                        n_query_shards=SHARD_MESH[1], devices=[card] * 8)
        grid["snapshot_gb"] = (torch.cuda.memory_allocated() - mem0) / 2 ** 30
        grid["peak_gb_over_before"] = (torch.cuda.max_memory_allocated()
                                       - mem0) / 2 ** 30
        shards = SHARD_MESH[0] * SHARD_MESH[1]
        if scan is not None:
            assert per.get(scan, 0) == shards, rec
        if tag != "d":                      # the owner-computes rerank
            assert per.get("gather_rows", 0) == shards, rec

        # local_probe = nprobe: the single engine's distances
        want = _scores(single)
        got = _sharded_exact_probe(eng, model, mode, q1k)
        close = np.isclose(got, want, rtol=1e-3, atol=1e-3)
        grid["exact_probe_rows_within_1e-3"] = float(close.all(1).mean())
        grid["exact_probe_max_rel_err"] = float(np.max(
            np.abs(got - want) / np.maximum(np.abs(want), 1e-3)))
        assert grid["exact_probe_rows_within_1e-3"] >= 0.99, rec
        recorder.stop()

        # a delete after the snapshot vanishes: the first live doc from
        # 7/9 of the corpus on (777,777) that its own vector finds
        v0 = len(corpus) * 7 // 9
        victim = next(v for v in range(v0, v0 + 20)
                      if v in _ids(_search(eng, corpus[v:v + 1]))[0])
        assert eng.delete(f"k{victim}") == 0
        got_ids = _ids(_search(eng, corpus[victim:victim + 1]))[0]
        assert victim not in got_ids, ("deleted doc returned", rec)
        grid["delete_after_snapshot"] = "vanished"

        # the realtime tail: docs after the snapshot, served by the live
        # index and merged in
        base = eng.table.n
        rng = np.random.default_rng(5)
        tail = (corpus[:N_SHARD_TAIL] + 0.05 * rng.normal(
            size=(N_SHARD_TAIL, D))).astype(np.float32)
        _ingest(eng, tail, base)
        found, dups = 0, 0
        for s0 in range(0, N_SHARD_TAIL, 1024):
            ids = _ids(_search(eng, tail[s0:s0 + 1024]))
            found += sum(base + s0 + i in row for i, row in enumerate(ids))
            dups += sum(len(set(row[row >= 0])) != int((row >= 0).sum())
                        for row in ids)
        grid["tail_found"] = found / N_SHARD_TAIL
        grid["rows_with_a_duplicate"] = dups
        assert grid["tail_found"] == 1.0 and dups == 0, rec
        torch.cuda.synchronize()
        rec["launches"] = _launch_counts()
    finally:
        recorder.stop()
        eng.disable_sharded_search()
    rec["seconds"] = time.perf_counter() - t0
    for key, (ops, kw, _) in sorted(recorder.calls.items(), key=str):
        name, origin = key[0], f"shard-{tag}"
        if name.startswith("gsq_fold"):
            SHARD_ROWS.append(_compare_b2(ops, kw, origin))
        elif name.startswith("gsq"):
            SHARD_ROWS.append(_compare_b1(ops, kw, origin))
        elif name == "gadc":
            SHARD_ROWS.append(_compare_b3(ops, kw, origin))
        elif name == "gather_rows":
            SHARD_ROWS.append(_compare_x1(*ops, origin))
        torch.cuda.empty_cache()
    keep = ("kernel", "groups", "q", "cap", "k", "max_abs_err", "ms",
            "plain_ms", "bound_ms")
    rec["kernels_checked"] = [{k: r[k] for k in keep if k in r}
                              for r in SHARD_ROWS
                              if r["operands"] == f"shard-{tag}"]
    print(f"phase D-shard {tag}:", json.dumps(rec))
    SHARD_RECS.append(rec)
    return rec


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
        gt_hot, held = _hot_list(eng, model, corpus, queries, rng, rec, n)
        rec["native_persist"] = _delete_reload(
            eng, path, engines, corpus, queries, int(sel[0]))
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
        recorder.stop()
        gt_grown = phase_rt("d", eng, model, held, queries, gt_hot)
        phase_shard("d", eng, model, corpus, queries, gt_grown)
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
            rec["native_persist"] = _delete_reload(
                eng, path, engines, corpus, queries, int(sel[0]))
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
        if tag in SHARD_SCAN:
            recorder.stop()
            if tag in RT_ENGINES:
                gt = phase_rt(tag, eng, model, corpus[:n], queries, gt)
            phase_shard(tag, eng, model, corpus, queries, gt)
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
        rec["mirror_row_bytes"] = _mirror_row_bytes(model.store)
        rec["mirror_dtype"] = str(model.store.device.dtype).split(".")[-1]
        if tag == "opq":
            rec["gather"] = {}
            _serve(eng, model, corpus, queries, gt, rec["gather"], n,
                   rp={"scan_mode": "gather"})
        rec["native_persist"] = _delete_reload(
            eng, path, engines, corpus, queries, int(sel[0]))
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
            phase_shard(tag, eng, model, corpus, queries, gt)
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
        rec["native_persist"] = _delete_reload(
            eng, path, engines, corpus, queries, int(sel[0]), rp=rp)
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
        rec["native_persist"] = _delete_reload(
            eng, path, engines, corpus, queries, int(sel[0]))
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
        rec["native_persist"] = _delete_reload(
            eng, path, engines, corpus, queries, int(sel[0]))
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
        rec["native_persist"] = _delete_reload(
            eng, path, engines, corpus, queries, int(gt_ip[0, 0]),
            rp=list(rps.values()))
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
        rec["native_persist"] = _delete_reload(
            eng, path, engines, corpus, queries, victim, rp=rp)
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
# D-hnsw, D-hnsw-200k, D-serve: the graph model and the serving surface
# ---------------------------------------------------------------------

HNSW = {"nlinks": 32, "efSearch": 64}        # bench.py:942's parameters
N_HNSW_200K, NQ_HNSW_200K = 200_000, 256      # bench.py:901-947
# the TPU's figure at that geometry: a TPU's number, printed beside the
# card's and compared with nothing
TPU_HNSW_200K = {"qps": 2984.7, "recall_at_10": 0.9949,
                 "origin": "BENCH_r05.json secondary.hnsw, a TPU run"}
N_TAIL = 1000          # D-hnsw's realtime tail: below the rebuild step


def _timed_rebuilds(model):
    """Times the model's two rebuild paths (synchronized); → the list
    each rebuild appends {kind, nodes, s} to."""
    import torch
    log = []
    for name in ("_bulk_build", "_incremental_build"):
        def timed(end, _orig=getattr(model, name), _kind=name.strip("_")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _orig(end)
            torch.cuda.synchronize()
            log.append({"kind": _kind, "nodes": end,
                        "s": time.perf_counter() - t})
        setattr(model, name, timed)
    return log


def phase_hnsw(data, gt):
    """D-hnsw: HNSW (nlinks 32, efSearch 64) at 1M docs through the
    engine.  Ingest in the usual batches: the pump adds 8192 rows at a
    time and each 1.25x growth rebuilds the graph, past CLUSTER_BUILD_N
    from two k-means partitions.  Then the checks of D, a realtime tail
    below the next rebuild step whose docs must be found, a delete, and
    a dump loaded by a fresh engine answering identically."""
    import torch
    from gamma_tpu_torch.index import hnsw
    corpus, queries, _ = data
    n = N_DOCS
    rec = {"engine": "hnsw", "model": "HNSW", "params": HNSW, "n": n}
    path = tempfile.mkdtemp(prefix="gamma_torch_smoke_hnsw_")
    engines = []
    torch.cuda.reset_peak_memory_stats()
    try:
        eng = _open_engine(path, "HNSW", HNSW)
        engines.append(eng)
        model = eng.vm.index_for("emb")
        rebuilds = _timed_rebuilds(model)
        _zero_counts()
        _ingest_all(eng, model, corpus, n, rec)
        rec["rebuilds"] = rebuilds
        rec["n_rebuilds"] = len(rebuilds)
        rec["rebuild_s_total"] = sum(r["s"] for r in rebuilds)
        rec["n_nodes"] = model.n_nodes
        assert model.n_nodes > hnsw.CLUSTER_BUILD_N, rec   # clustered
        rec["graph_bytes"] = model.mem_bytes()
        rec["memory"] = _memory(eng)
        sel = _serve(eng, model, corpus, queries, gt, rec, n)
        # the realtime tail: docs past the graph, found by the flat scan
        tail = (corpus[:N_TAIL] + 0.5 * np.random.default_rng(3).normal(
            size=(N_TAIL, D))).astype(np.float32)
        nodes = model.n_nodes
        _ingest(eng, tail, n)
        assert model.n_nodes == nodes, "the tail rebuilt the graph"
        top1 = _ids(_search(eng, tail), 1)[:, 0]
        rec["tail_found_share"] = float(np.mean(
            top1 == np.arange(n, n + N_TAIL)))
        assert rec["tail_found_share"] == 1.0, rec
        rec["native_persist"] = _delete_reload(
            eng, path, engines, corpus, queries, int(sel[0]))
        rec["launches"] = _launch_counts()
        assert not any(rec["launches"].values()), rec   # no csrc kernel
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        for e in engines:
            e.close()
        shutil.rmtree(path, ignore_errors=True)
    print("phase D-hnsw engine:", json.dumps(rec))
    return rec


def phase_hnsw_200k(data):
    """D-hnsw-200k: HNSWIndex on its own at the TPU bench's secondary
    geometry (bench.py:901-947: the first 200,000 rows, 256 queries at
    +0.5 noise, nlinks 32, efSearch 64), through the exact _build_knn
    path; recall over batches of 128, QPS at batch 1024 (the queries
    repeated), beside the TPU's figure."""
    import torch
    from gamma_tpu_torch.config import SearchParams
    from gamma_tpu_torch.index import hnsw
    from gamma_tpu_torch.vector.raw_store import RawVectorStore
    corpus, _, _ = data
    n, nq = N_HNSW_200K, NQ_HNSW_200K
    assert n <= hnsw.CLUSTER_BUILD_N
    rng = np.random.default_rng(2)
    x = np.ascontiguousarray(corpus[:n])
    q = (x[rng.choice(n, nq, replace=False)]
         + 0.5 * rng.normal(size=(nq, D))).astype(np.float32)
    gt = _exact_topk(x, q, TOPK)
    store = RawVectorStore("sec", D, init_cap=n + 1024)
    store.add(x)
    store.flush_device()
    idx = hnsw.HNSWIndex(store, HNSW)
    ids = np.arange(n, dtype=np.int64)
    _zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    idx.add(x, ids, ids)
    torch.cuda.synchronize()
    rec = {"engine": "hnsw-200k", "n": n, "params": HNSW,
           "build_s": time.perf_counter() - t, "n_nodes": idx.n_nodes}
    assert idx.n_nodes == n, rec
    pen = torch.zeros(store.device.shape[0], device=store.dev)
    sp = SearchParams.from_dict({"ef_search": 64})
    qd = torch.from_numpy(q).to(store.dev)
    found = np.concatenate([
        idx.search(qd[s:s + 128], pen, sp, TOPK)[1].cpu().numpy()
        for s in range(0, nq, 128)])
    rec["recall_at_10"] = _recall(found, gt)
    qb = qd[torch.arange(1024, device=store.dev) % nq]
    idx.search(qb, pen, sp, TOPK)                          # warm-up
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        idx.search(qb, pen, sp, TOPK)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    rec["qps_b1024"] = 1024 / float(np.median(times))
    rec["tpu_figure"] = TPU_HNSW_200K
    rec["launches"] = _launch_counts()
    assert not any(rec["launches"].values()), rec
    assert rec["recall_at_10"] >= 0.95, rec
    print("phase D-hnsw-200k index:", json.dumps(rec))
    return rec


def _timed_calls(fn, sink):
    """`fn`, appending the seconds of each call to `sink`."""
    def timed(*a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        sink.append(time.perf_counter() - t)
        return out
    return timed


def _wire_timers():
    """Times every call of the wire's pack/unpack functions (the served
    path's serialization, on both sides of the socket: client and
    server share this process); → (seconds by function, restore)."""
    from gamma_tpu_torch.idl import wire
    names = ("pack_docs", "unpack_docs", "pack_request", "unpack_request",
             "pack_response", "unpack_response")
    spent = {name: [] for name in names}
    orig = {name: getattr(wire, name) for name in names}
    for name in names:
        setattr(wire, name, _timed_calls(orig[name], spent[name]))

    def restore():
        for name, fn in orig.items():
            setattr(wire, name, fn)
    return spent, restore


def _hits(results):
    """(ids [B, TOPK] from the keys "k<id>", scores [B, TOPK]) of a
    response's results, padded with -1 / inf (a router's docids are its
    partitions' own, the keys are global)."""
    ids = np.full((len(results), TOPK), -1, np.int64)
    sc = np.full((len(results), TOPK), np.inf)
    for i, sr in enumerate(results):
        for j, it in enumerate(sr.result_items[:TOPK]):
            ids[i, j], sc[i, j] = int(str(it.key)[1:]), it.score
    return ids, sc


# the router's table: two partitions of N_ROUTER docs in all, each engine
# trains on its first ROUTER_INDEXING rows (~131k docs a partition)
N_ROUTER, ROUTER_INDEXING = INDEXING_SIZE, 65536
ROUTER_PARAMS = {"ncentroids": 1024, "nprobe": NPROBE, "nsubvector": M_SUB}


def _serve_router(data):
    """A GammaRouter over launch_local(2, ...), laid out as
    tests/test_cluster.py lays its cluster: partition 0 has two
    replicas (one on each server), partition 1 one.  The merged top-10
    of 1000 queries against the exact top-10 of the union; then server
    0 stops and the router fails over to partition 0's other replica."""
    from gamma_tpu_torch import EngineConfig, Request, VectorQuery
    from gamma_tpu_torch.cluster import GammaRouter, launch_local
    corpus, queries, _ = data
    n = N_ROUTER
    base = tempfile.mkdtemp(prefix="gamma_torch_smoke_router_")
    lc = launch_local(2, os.path.join(base, "socks"))
    router = None
    rec = {"n": n, "params": ROUTER_PARAMS,
           "indexing_size": ROUTER_INDEXING}
    try:
        router = GammaRouter([[lc.sockets[0], lc.sockets[1]],
                              [lc.sockets[1]]])
        router.bootstrap(
            [[EngineConfig(path=os.path.join(base, "p0r0")),
              EngineConfig(path=os.path.join(base, "p0r1"))],
             [EngineConfig(path=os.path.join(base, "p1r0"))]],
            _table("IVFPQ", ROUTER_PARAMS, ROUTER_INDEXING))
        t = time.perf_counter()
        for s in range(0, n, INGEST_BATCH):
            codes = router.add_or_update_docs(
                _docs(corpus[s:min(n, s + INGEST_BATCH)], s))
            assert all(c == 0 for c in codes)
            router.flush()
        router.build_index()
        router.flush()
        rec["ingest_s"] = time.perf_counter() - t
        assert router.doc_count() == n, router.doc_count()
        gt = _exact_topk(corpus[:n], queries[:1000], TOPK)
        req = Request(vec_fields=[VectorQuery("emb", queries[:1000])],
                      topn=TOPK)
        before, _ = _hits(router.search(req).results)
        rec["recall_at_10"] = _recall(before, gt)
        assert rec["recall_at_10"] >= 0.95, rec
        lc.stop(0)                     # server 0 goes, and its connection
        router._drop_client(0, 0)
        after, _ = _hits(router.search(req).results)
        rec["alive_after_stop"] = router.partitions[0].alive
        assert rec["alive_after_stop"] == [False, True], rec
        rec["recall_at_10_after_stop"] = _recall(after, gt)
        rec["same_ids_after_stop"] = bool((after == before).all())
        assert rec["recall_at_10_after_stop"] >= 0.95, rec
    finally:
        if router is not None:
            router.close()
        lc.stop_all()
        shutil.rmtree(base, ignore_errors=True)
    return rec


def _served_mode(cli, twin, queries, gt, rp, clocks):
    """One scan mode of D-serve: 1000 queries in one request, recall
    and the answers held against the in-process twin's; then five
    batch-1024 requests, each split by `clocks` (lists of seconds the
    wrappers append to: "wire" by function, "engine" the served
    engine's search, "handle" the server's c_api.Search)."""
    from gamma_tpu_torch import Request, VectorQuery
    from gamma_tpu_torch.idl import wire
    r = {}
    req = Request(vec_fields=[VectorQuery("emb", queries[:1000])],
                  topn=TOPK, retrieval_params=dict(rp))
    _zero_counts()
    ids, sc = _hits(cli.search(req).results)
    first = _launch_counts()
    r["recall_at_10"] = _recall(ids, gt)
    tids, tsc = _hits(_search(twin, queries[:1000],
                              retrieval_params=dict(rp)))
    r["identical_to_in_process"] = int(
        ((ids == tids).all(1) & (sc == tsc).all(1)).sum())
    # where a query differs, the near-tie rule: the distances of each
    # side's chosen ids
    np.testing.assert_allclose(np.sort(sc, 1), np.sort(tsc, 1),
                               rtol=1e-4, atol=1e-3)
    assert r["recall_at_10"] >= 0.95, r
    big = Request(vec_fields=[VectorQuery("emb", queries)], topn=TOPK,
                  retrieval_params=dict(rp))
    _zero_counts()
    cli.search(big)                                         # warm-up
    parts = {"request": [], "wire": [], "engine": [], "handle": []}
    for _ in range(5):
        for sink in (*clocks["wire"].values(), clocks["engine"],
                     clocks["handle"]):
            sink.clear()
        t = time.perf_counter()
        cli.search(big)
        parts["request"].append(time.perf_counter() - t)
        parts["wire"].append(sum(map(sum, clocks["wire"].values())))
        parts["engine"].append(sum(clocks["engine"]))
        parts["handle"].append(sum(clocks["handle"]))
    ms = {k: 1e3 * float(np.median(v)) for k, v in parts.items()}
    r["served_qps_b1024"] = 1e3 * queries.shape[0] / ms["request"]
    r["request_ms"] = ms["request"]
    r["wire_pack_unpack_ms"] = ms["wire"]
    r["engine_search_ms"] = ms["engine"]
    # the server's unpack, engine search and pack; the rest of a request
    # is the client's pack and unpack and the socket
    r["server_handle_ms"] = ms["handle"]
    r["request_bytes"] = len(wire.pack_request(big))
    timed = _launch_counts()
    r["launches_per_request_b1024"] = {k: v / 6 for k, v in timed.items()}
    r["launches"] = {k: first[k] + timed[k] for k in timed}
    return r


def phase_serve(data, gt):
    """D-serve: the port's socket server in this process, a GammaClient
    over TCP, an IVFPQ M 32 engine with D-dense's params at 1M docs
    behind it.  Ingest through AddOrUpdateDocs over the wire (auto-train
    fires on the third batch), batch-1024 Search requests dense (X1 in
    the rerank) and with scan_mode "gather" (B1), each answer held
    against an in-process engine fed the same docs in the same batches;
    then a GammaRouter over two local partition servers."""
    import torch
    from gamma_tpu_torch import EngineConfig, c_api
    from gamma_tpu_torch.server import GammaClient, serve
    corpus, queries, _ = data
    n = N_DOCS
    rec = {"engine": "serve", "model": "IVFPQ", "params": DENSE, "n": n}
    path = tempfile.mkdtemp(prefix="gamma_torch_smoke_serve_")
    srv = serve(("127.0.0.1", 0))
    spent, restore = _wire_timers()
    capi_search = c_api.Search
    clocks = {"wire": spent, "engine": [], "handle": []}
    c_api.Search = _timed_calls(capi_search, clocks["handle"])
    cli, engines = None, []
    torch.cuda.reset_peak_memory_stats()
    try:
        cli = GammaClient(srv.server_address)
        assert cli.init(EngineConfig(path=os.path.join(path, "served"))) == 0
        assert cli.create_table(_table("IVFPQ", DENSE)) == 0
        (served,) = c_api._engines.values()     # the handle, in-process
        served.search = _timed_calls(served.search, clocks["engine"])
        t = time.perf_counter()
        for s in range(0, n, INGEST_BATCH):
            codes = cli.add_or_update_docs(
                _docs(corpus[s:min(n, s + INGEST_BATCH)], s))
            assert all(c == 0 for c in codes)
            assert cli.flush() == 0
        ingest_s = time.perf_counter() - t
        st = cli.status()
        assert st.index_status.name == "INDEXED", st
        assert st.doc_count == n and st.min_indexed_num == n, st
        rec.update(wire_ingest_s=ingest_s, wire_docs_per_s=n / ingest_s,
                   wire_ingest_pack_s=sum(spent["pack_docs"]),
                   wire_ingest_unpack_s=sum(spent["unpack_docs"]))
        twin = _open_engine(os.path.join(path, "twin"), "IVFPQ", DENSE)
        engines.append(twin)
        rec["twin"] = {}
        _ingest_all(twin, twin.vm.index_for("emb"), corpus, n, rec["twin"])
        for mode, rp in (("dense", {}), ("gather", {"scan_mode": "gather"})):
            rec[mode] = _served_mode(cli, twin, queries, gt, rp, clocks)
        assert rec["dense"]["launches"]["gather_rows"] > 0, rec
        assert rec["gather"]["launches"]["gsq"] > 0, rec
        _zero_counts()
        rec["router"] = _serve_router(data)
        rec["router"]["launches"] = _launch_counts()
        rec["launches"] = {k: sum(rec[p]["launches"][k] for p in
                                  ("dense", "gather", "router"))
                           for k in rec["router"]["launches"]}
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        restore()
        c_api.Search = capi_search
        if cli is not None:
            cli.close()
        srv.stop()
        for e in engines:
            e.close()
        shutil.rmtree(path, ignore_errors=True)
    print("phase D-serve engine:", json.dumps(rec))
    return rec


# ---------------------------------------------------------------------
# D-store, D-store-sweep, D-crash: the store options of gamma_tpu (the
# fp8 mirror tier, zstd block compression, native incremental
# persistence and its crash recovery)
# ---------------------------------------------------------------------

# the fp8 (e4m3) mirror and zstd-compressed vector segments
STORE_PARAM = {"device_dtype": "float8", "compress": "zstd"}
# gamma_tpu's recall@10 floor for the fp8 tier (tests/test_compress.py)
FP8_RECALL_FLOOR = 0.80
N_SWEEP, NQ_SWEEP = 50_000, 256
# the six other models over an fp8 mirror: type → (params, request params)
SWEEP = {
    "FLAT": ({}, {}),
    "IVFFLAT": ({"ncentroids": 256}, {"nprobe": 32}),
    "HNSW": (HNSW, {}),
    "SCANN": ({"ncentroids": 256, "nsubvector": M_SUB, "nprobe": 32,
               "metric_type": "InnerProduct"}, {"recall_num": 256}),
    "IVFPQ_FASTSCAN": ({"ncentroids": 256, "nsubvector": 2 * M_SUB,
                        "nprobe": 32}, {}),
    "BINARYIVF": ({"ncentroids": 256}, {"nprobe": 32}),
}
N_CRASH, N_CRASH_TAIL = 100_000, 10_000


def _mirror_row_bytes(store):
    """Bytes of the store mirror's rows (its mirrored rows, not its
    capacity)."""
    return store.flushed * store.d * store.device.element_size()


def _gate(tag, name, rec):
    print(f"phase D-{tag} gate {name}:", json.dumps(rec))


def _dump_state(path):
    """What a native dump leaves: the vector segment's inode and size,
    the commit marker."""
    zblk = os.path.join(path, "store", "vec_emb.zblk")
    with open(os.path.join(path, "commit.json")) as f:
        commit = json.load(f)
    st = os.stat(zblk)
    return {"zblk_inode": st.st_ino, "zblk_bytes": st.st_size,
            "commit": commit}


def phase_store(data, gt, d_rec, dense_rec, recorder):
    """D-store: D-dense's engine (IVFPQ M 32, dense by default) over an
    fp8 store mirror with zstd-compressed vector segments and table
    columns, native persistence in effect.  1M docs in two halves, a
    dump after each; 1024 queries dense (X1 over fp8 rows), then gather
    (B1 over the SQ8 sidecar); a fresh engine loads the commit.  Gates:
    (a) the mirror is 1 byte an element, half of D-dense's; (b) recall@10
    >= gamma_tpu's floor for the tier in both modes; (c) X1 on the
    engine's own fp8 rerank indices equals its plain version bit for
    bit; (d) the second dump is a delta over sealed zstd frames; (e) the
    loaded engine answers 64 queries with the same ids and scores.
    → (the phase's record, X1's row)."""
    import torch
    from gamma_tpu_torch import EngineConfig, GammaEngine
    from gamma_tpu_torch.config import SearchParams
    corpus, queries, _ = data
    n, half = N_DOCS, N_DOCS // 2
    rp_gather = {"scan_mode": "gather"}
    rec = {"engine": "store", "model": "IVFPQ", "params": DENSE,
           "store_param": STORE_PARAM, "compress_table_blocks": True,
           "n": n}
    path = tempfile.mkdtemp(prefix="gamma_torch_smoke_store_")
    engines = []
    torch.cuda.reset_peak_memory_stats()
    try:
        cfg = EngineConfig(path=path, compress_table_blocks=True)
        eng = GammaEngine(cfg)
        engines.append(eng)
        rec["native_persist"] = eng._native_persist
        assert eng._native_persist, "native persistence is not in effect"
        eng.create_table(_table("IVFPQ", DENSE, store_param=STORE_PARAM))
        model = eng.vm.index_for("emb")
        store = eng.vm.stores["emb"]
        _zero_counts()
        rec["ingest"] = [{}, {}]
        _ingest_all(eng, model, corpus, half, rec["ingest"][0])
        t = time.perf_counter()
        assert eng.dump() == 0
        rec["dump_s"] = [time.perf_counter() - t]
        first = _dump_state(path)
        _ingest_all(eng, model, corpus, n, rec["ingest"][1], start=half)
        t = time.perf_counter()
        assert eng.dump() == 0
        rec["dump_s"].append(time.perf_counter() - t)
        second = _dump_state(path)

        # (a) the mirror's bytes
        gate = {"dtype": str(store.device.dtype).split(".")[-1],
                "element_bytes": store.device.element_size(),
                "row_bytes": _mirror_row_bytes(store),
                "d_dense_row_bytes": dense_rec["mirror_row_bytes"],
                "d_dense_dtype": dense_rec["mirror_dtype"]}
        rec["mirror"] = gate
        _gate("store", "(a) mirror", gate)
        assert gate["element_bytes"] == 1, gate
        assert 2 * gate["row_bytes"] == gate["d_dense_row_bytes"], gate

        # (b) recall in both modes; the dense search's X1 operands kept
        rec["scan_mode"] = model.scan_mode(SearchParams())
        assert rec["scan_mode"] == "dense", rec
        recorder.x1 = True
        recorder.start()
        ids = _ids(_search(eng, queries))
        recorder.stop()
        recorder.x1 = False
        before = _launch_counts()
        gids = _ids(_search(eng, queries, retrieval_params=rp_gather))
        after = _launch_counts()
        gate = {"dense": _recall(ids[:1000], gt),
                "gather": _recall(gids[:1000], gt),
                "floor": FP8_RECALL_FLOOR,
                "d_dense_recall_at_10": dense_rec["recall_at_10"],
                "d_recall_at_10": d_rec["recall_at_10"],
                "gather_launches": {k: after[k] - before[k] for k in after
                                    if after[k] > before[k]}}
        rec["recall_at_10"] = gate
        _gate("store", "(b) recall", gate)
        assert min(gate["dense"], gate["gather"]) >= FP8_RECALL_FLOOR, gate
        assert set(gate["gather_launches"]) & {"gsq", "gsq_fold", "gadc"}, \
            gate
        rec["qps_b1024"] = {"dense": _qps(eng, queries),
                            "gather": _qps(eng, queries,
                                           retrieval_params=rp_gather)}

        # (d) the second dump: a delta over sealed zstd frames
        comp = store._persist.store.comp_bytes()
        raw = n * D * 4
        gate = {"zblk_inode_kept": (first["zblk_inode"]
                                    == second["zblk_inode"]),
                "commit_rewritten": first["commit"] != second["commit"],
                "commit_doc_count": [first["commit"]["doc_count"],
                                     second["commit"]["doc_count"]],
                "zstd_frame_bytes": comp, "zblk_bytes": second["zblk_bytes"],
                "raw_row_bytes": raw, "frame_share": comp / raw,
                "dump_s": rec["dump_s"]}
        rec["delta_dump"] = gate
        _gate("store", "(d) delta dump", gate)
        assert gate["zblk_inode_kept"] and gate["commit_rewritten"], gate
        assert gate["commit_doc_count"] == [half, n], gate
        assert 0 < comp < raw and second["zblk_bytes"] < raw, gate

        # (e) a fresh engine loads the commit and answers alike
        kws = _request_kws([None, rp_gather])
        res_a = [_search(eng, queries[:64], **kw) for kw in kws]
        t = time.perf_counter()
        eng2 = GammaEngine(cfg)
        engines.append(eng2)
        assert eng2.load() == 0
        load_s = time.perf_counter() - t
        assert eng2._native_persist
        assert eng2.engine_status().doc_count == n
        assert eng2.vm.stores["emb"].device.element_size() == 1
        _same_results(res_a, [_search(eng2, queries[:64], **kw)
                              for kw in kws])
        gate = {"queries": 64, "modes": ["dense", "gather"],
                "same_ids_and_scores": True, "load_s": load_s}
        rec["reload"] = gate
        _gate("store", "(e) reload", gate)
        torch.cuda.synchronize()
        rec["launches"] = _launch_counts()
        assert rec["launches"]["gather_rows"] > 0, rec
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30

        # (c) X1 on the dense search's own fp8 rows and indices
        (table, idx), _, _ = recorder.calls.pop(
            ("gather_rows", "float8_e4m3fn"))
        x1_row = _compare_x1(table, idx, "engine")
        del table, idx
        rec["x1"] = {k: x1_row[k] for k in (
            "dtype", "k", "bitexact", "max_abs_err", "ms", "bound_ms",
            "library_ms", "plain_ms")}
        # the same gather over bf16 rows (D-dense's mirror): its bound
        rec["x1"]["bf16_rows_bound_ms"] = _x1_bound(
            x1_row["distinct_rows"], x1_row["k"], 2 * D,
            4 if x1_row["idx_dtype"] == "int32" else 8)[0]
        _gate("store", "(c) x1", rec["x1"])
    finally:
        recorder.stop()
        recorder.x1 = False
        for e in engines:
            e.close()
        shutil.rmtree(path, ignore_errors=True)
    print("phase D-store engine:", json.dumps(rec))
    return rec, x1_row


def _tie_aware_recall(res, kth, dist):
    """Found ids whose exact Hamming distance is <= the exact k-th (the
    top-k boundary of Hamming distances is a plateau of ties)."""
    hits = 0
    for i, sr in enumerate(res):
        ids = np.array([it.docid for it in sr.result_items], np.int64)
        hits += int((dist(i, ids) <= kth[i]).sum())
    return hits / (TOPK * len(res))


def phase_store_sweep(data):
    """D-store-sweep: the six other models over an fp8 mirror at 50,000
    docs, 256 queries each, recall@10 against exact neighbours (SCANN:
    inner product; BINARYIVF: Hamming, tie-aware) >= the tier's floor."""
    import torch
    corpus, queries = data[0][:N_SWEEP], data[1][:NQ_SWEEP]
    gt = _exact_topk(corpus, queries, TOPK)
    gt_ip = _exact_topk(corpus, queries, TOPK, metric="ip")
    kth, dist = _hamming_to(corpus, queries, TOPK)
    recs = []
    for name, (params, rp) in SWEEP.items():
        rec = {"model": name, "params": params, "request_params": rp,
               "n": N_SWEEP, "store_param": {"device_dtype": "float8"}}
        path = tempfile.mkdtemp(prefix="gamma_torch_smoke_sweep_")
        eng = None
        try:
            eng = _open_engine(path, name, params, N_SWEEP // 2,
                               store_param=rec["store_param"])
            model = eng.vm.index_for("emb")
            _zero_counts()
            _ingest_all(eng, model, corpus, N_SWEEP, rec)
            store = eng.vm.stores["emb"]
            rec["mirror_element_bytes"] = store.device.element_size()
            assert rec["mirror_element_bytes"] == 1, rec
            res = _search(eng, queries, retrieval_params=rp)
            if name == "BINARYIVF":
                rec["recall_at_10_tie_aware"] = r = _tie_aware_recall(
                    res, kth, dist)
            else:
                rec["recall_at_10"] = r = _recall(
                    _ids(res), gt_ip if name == "SCANN" else gt)
            rec["qps_b256"] = _qps(eng, queries, retrieval_params=rp)
            torch.cuda.synchronize()
            rec["launches"] = _launch_counts()
            assert r >= FP8_RECALL_FLOOR, rec
        finally:
            if eng is not None:
                eng.close()
            shutil.rmtree(path, ignore_errors=True)
        recs.append(rec)
    print("phase D-store-sweep engines:", json.dumps(recs))
    return recs


def _crash_engine(path):
    """D-crash's engine: FLAT on the card, zstd vector segments and table
    columns, native persistence (the child's and the parent's alike)."""
    from gamma_tpu_torch import EngineConfig, GammaEngine
    eng = GammaEngine(EngineConfig(path=path, compress_table_blocks=True))
    assert eng._native_persist, "native persistence is not in effect"
    return eng


def crash_child(path):
    """The child process of D-crash: builds the engine over N_CRASH docs,
    dumps, prints its answers to the committed state, then ingests
    N_CRASH_TAIL more docs, flushes them to the segments and exits
    without a second dump (os._exit: no close, no handler runs)."""
    rows = np.load(os.path.join(path, "rows.npy"))
    queries = np.load(os.path.join(path, "queries.npy"))
    eng = _crash_engine(os.path.join(path, "engine"))
    eng.create_table(_table("FLAT", {}, store_param={"compress": "zstd"}))
    _ingest(eng, rows[:N_CRASH], 0)
    assert eng.dump() == 0
    res = _search(eng, queries)
    print(json.dumps({"ids": [[it.docid for it in sr.result_items]
                              for sr in res],
                      "scores": [[it.score for it in sr.result_items]
                                 for sr in res],
                      "native_persist": eng._native_persist}))
    _ingest(eng, rows[N_CRASH:], N_CRASH)
    sys.stdout.flush()
    os._exit(0)


def phase_crash(data):
    """D-crash: crash recovery on the card.  A child process (this
    interpreter, `crash_child`) commits N_CRASH docs, flushes
    N_CRASH_TAIL more and exits before a second dump; this process
    loads the directory and must find exactly the committed docs, with
    the answers the child printed for them."""
    from gamma_tpu_torch.storage.native_backend import VectorPersist
    corpus, queries, _ = data
    rec = {"model": "FLAT", "store_param": {"compress": "zstd"},
           "committed": N_CRASH, "flushed_after": N_CRASH_TAIL}
    path = tempfile.mkdtemp(prefix="gamma_torch_smoke_crash_")
    eng = None
    try:
        np.save(os.path.join(path, "rows.npy"),
                corpus[:N_CRASH + N_CRASH_TAIL])
        np.save(os.path.join(path, "queries.npy"), queries[:64])
        t = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {HERE!r}); "
             f"import chip_smoke; chip_smoke.crash_child({path!r})"],
            capture_output=True, text=True, timeout=600)
        rec["child_s"] = time.perf_counter() - t
        assert child.returncode == 0, child.stderr[-4000:]
        said = json.loads(child.stdout.strip().splitlines()[-1])
        assert said["native_persist"], said
        # on disk: the commit names N_CRASH docs, the vector segment
        # holds the flushed tail too
        with open(os.path.join(path, "engine", "commit.json")) as f:
            rec["commit_doc_count"] = json.load(f)["doc_count"]
        seg = VectorPersist(os.path.join(path, "engine", "store"), "emb", D,
                            compress=True)
        rec["segment_rows_before_load"] = len(seg)
        seg.close()
        assert rec["commit_doc_count"] == N_CRASH, rec
        # (rows past the commit are not synced: their count may run
        # past what was flushed, and load truncates them all)
        assert rec["segment_rows_before_load"] >= N_CRASH + N_CRASH_TAIL, rec
        t = time.perf_counter()
        eng = _crash_engine(os.path.join(path, "engine"))
        assert eng.load() == 0
        rec["load_s"] = time.perf_counter() - t
        rec["doc_count"] = eng.engine_status().doc_count
        assert rec["doc_count"] == N_CRASH, rec
        assert eng.get_doc_by_key(f"k{N_CRASH - 1}") is not None, rec
        assert eng.get_doc_by_key(f"k{N_CRASH}") is None, rec
        res = _search(eng, queries[:64])
        rec["same_ids"] = said["ids"] == [[it.docid for it in sr.result_items]
                                          for sr in res]
        rec["same_scores"] = said["scores"] == [
            [it.score for it in sr.result_items] for sr in res]
        assert rec["same_ids"] and rec["same_scores"], rec
    finally:
        if eng is not None:
            eng.close()
        shutil.rmtree(path, ignore_errors=True)
    print("phase D-crash recovery:", json.dumps(rec))
    return rec


# ---------------------------------------------------------------------
# E. kernels against their plain versions at the engines' widths
# ---------------------------------------------------------------------

# ---------------------------------------------------------------------
# D-10M and D-vgg: the JAX package's two published scale configurations
# (bench.py's 10M capacity tiers and VGG-1M), driven at the model level
# over a RawVectorStore and an IVFPQIndex, as bench.py drives them
# ---------------------------------------------------------------------

N_10M, N_VGG, D_VGG, M_VGG = 10_000_000, 1_000_000, 512, 64
NQ_SCALE = 256                 # bench.py's queries at both scales
ADD_CHUNK = 65_536             # bench.py's add_chunk
SCALE_RECS = []                # each scale phase's record
SCALE_ROWS = []                # its kernels against their plain versions
# bench.py's request: the dense scan, the exact rerank of recall_num 100
SCALE_DENSE = {"scan_mode": "dense", "recall_num": 100,
               "recall_target": 0.95, "has_rank": True}
SCALE_GATHER = {"scan_mode": "gather", "nprobe": NPROBE, "recall_num": 100,
                "has_rank": True}
RECALL_FLOOR = 0.95            # PERF.md §2's limit for recall@10


def _step_memory(tag, rec, step, store, model=None, **also):
    """One line after a step of a scale phase: the step's peak device
    memory (the peak is reset after each line), what is allocated after
    it, and what the step should hold: the store mirror and, once there
    is one, the model's device state by its own count (`mem_bytes`:
    posting lists, reconstruction mirror, sidecar, quantizers)."""
    import torch
    torch.cuda.synchronize()
    held = (store.device.numel() * store.device.element_size()
            + store.device_norms.numel() * 4
            + (model.mem_bytes() if model is not None else 0))
    row = {"step": step,
           "max_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "allocated_gb": torch.cuda.memory_allocated() / 2 ** 30,
           "expect_gb": held / 2 ** 30, **also}
    rec["memory"].append(row)
    print(f"phase D-{tag} memory:", json.dumps(row))
    torch.cuda.reset_peak_memory_stats()


def _scale_data(n, d, seed, **geometry):
    """bench.py's corpus at (n, d), NQ_SCALE queries at +0.5 noise, and
    their exact neighbours (float64, on the card) → (corpus, queries,
    gt, seconds of the corpus, seconds of the ground truth)."""
    sys.path.insert(0, HERE)
    from bench import _make_corpus          # the TPU bench's generator
    rng = np.random.default_rng(seed)
    t = time.perf_counter()
    corpus, _ = _make_corpus(n, d, 1024, rng, **geometry)
    queries = (corpus[rng.choice(n, NQ_SCALE, replace=False)]
               + 0.5 * rng.normal(size=(NQ_SCALE, d))).astype(np.float32)
    corpus_s = time.perf_counter() - t
    t = time.perf_counter()
    gt = _exact_topk(corpus, queries, TOPK)
    return corpus, queries, gt, corpus_s, time.perf_counter() - t


def _scale_build(tag, rec, corpus, params, device_dtype):
    """bench.py's build: the store and its mirror, the index, training
    on the mirror's first nlist x 256 rows, `add` in chunks of
    ADD_CHUNK from the mirror (the steady rate is the median chunk's).
    → (store, model)."""
    import torch
    from gamma_tpu_torch.index.ivfpq import IVFPQIndex
    from gamma_tpu_torch.vector.raw_store import RawVectorStore
    n, d = corpus.shape
    store = RawVectorStore(f"vec_{tag}", d, device_dtype=device_dtype,
                           init_cap=n + 1024)
    store.add(corpus)
    t = time.perf_counter()
    store.flush_device()
    torch.cuda.synchronize()
    rec["flush_device_s"] = time.perf_counter() - t
    _step_memory(tag, rec, "store mirror", store,
                 dtype=str(store.device.dtype).split(".")[-1])
    model = IVFPQIndex(store, params)
    t = time.perf_counter()
    model.train(store.device_rows(0, min(n, params["ncentroids"] * 256)))
    torch.cuda.synchronize()
    rec["train_s"] = time.perf_counter() - t
    _step_memory(tag, rec, "train", store, model,
                 posting_cap=model.state.cap)
    ids = np.arange(n, dtype=np.int64)
    rates = []
    t = time.perf_counter()
    for s in range(0, n, ADD_CHUNK):
        e = min(n, s + ADD_CHUNK)
        tc = time.perf_counter()
        model.add(store.device_rows(s, e), ids[s:e], ids[s:e])
        torch.cuda.synchronize()
        rates.append((e - s) / (time.perf_counter() - tc))
    lens = model.state.lens.cpu().numpy()
    rec["add"] = {"s": time.perf_counter() - t,
                  "steady_docs_per_s": float(np.median(rates)),
                  "best_docs_per_s": max(rates), "chunks": len(rates),
                  "max_list": int(lens.max()),
                  "mean_list": float(lens.mean()),
                  "posting_cap": model.state.cap,
                  "cap_eff": model._cap_eff()}
    print(f"phase D-{tag} add:", json.dumps(rec["add"]))
    recon = (model.recon.numel() * model.recon.element_size()
             + 3 * model.recon_norms.numel() * 4)
    sidecar = (model.sq_codes.numel() + model.sq_norms.numel() * 4
               if model.sq_active else 0)
    _step_memory(tag, rec, "add", store, model, recon_gb=recon / 2 ** 30,
                 posting_gb=model.state.mem_bytes() / 2 ** 30,
                 sidecar_gb=sidecar / 2 ** 30)
    return store, model


def _scale_runner(model, n, params):
    """A model-level search under request params → fn(queries, k)."""
    import torch
    from gamma_tpu_torch.config import SearchParams
    sp = SearchParams.from_dict(params)
    pen = torch.zeros(model.store.device.shape[0], device="cuda")
    return lambda qb, k=TOPK: model.search(qb, pen, sp, k, validity_n=n)


def _scale_recalls(run, qd, gt, step=64):
    """bench.py's measure_recalls: top-100 searches of `step` queries →
    recall@1 and @100 (the true nearest neighbour first / among the
    100) and recall@10 (intersection with the exact top 10)."""
    f100 = np.concatenate([run(qd[s:s + step], 100)[1].cpu().numpy()
                           for s in range(0, qd.shape[0], step)])
    nn = gt[:, 0]
    return {"recall_at_1": float(np.mean(f100[:, 0] == nn)),
            "recall_at_10": _recall(f100[:, :TOPK], gt),
            "recall_at_100": float(np.mean([nn[i] in f100[i]
                                            for i in range(nn.size)]))}


def _scale_batch(run, qd, batch, reps=3):
    """One batch of `batch` queries (the queries repeated) → (the batch,
    median seconds of `reps` synchronized calls after a warm one)."""
    import torch
    qb = qd[torch.arange(batch, device=qd.device) % qd.shape[0]]
    run(qb)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(qb)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return qb, float(np.median(times))


def _scale_breakdown(run, qd, batch):
    """One batch's host time (median) and device time by kernel
    (`_trace`)."""
    qb, s = _scale_batch(run, qd, batch)
    return {"batch": batch, "model_search_ms": 1e3 * s,
            **_trace(lambda: run(qb), 1e3 * s)}


def _scale_gate(tag, name, got, **also):
    gate = {"recall_at_10": got, "floor": RECALL_FLOOR, **also}
    _gate(tag, name, gate)
    assert got >= RECALL_FLOOR, (tag, name, gate)
    return gate


def _scale_search(run, qd, held, kernels):
    """One request's ids and the launches it made, which must include
    each of `kernels`."""
    before = _held_counts(held)
    got = run(qd)[1].cpu().numpy()
    after = _held_counts(held)
    launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    assert all(launched.get(k) for k in kernels), (kernels, launched)
    return got, launched


def _scale_checks(tag, calls, want):
    """The kernels a scale phase launched, each against its plain version
    on the widest operands the phase handed it (`want`: label → recorder
    key), at phase E's tolerances; the rows carry their label and the
    phase as their operands' origin."""
    import torch
    rows = []
    for label, key in want.items():
        assert key in calls, (tag, label, sorted(calls, key=str))
        ops, kw, _ = calls.pop(key)
        if key[0] == "gather_rows":
            row = _compare_x1(*ops, f"D-{tag}")
        elif key[0] == "gadc":
            row = _compare_b3(ops, kw, f"D-{tag}")
        elif key[0].startswith("gsq_fold"):
            row = _compare_b2(ops, kw, f"D-{tag}")
        else:
            row = _compare_b1(ops, kw, f"D-{tag}")
        row["label"] = label
        rows.append(row)
        del ops, kw
        torch.cuda.empty_cache()
    calls.clear()
    print(f"phase D-{tag} kernels:", json.dumps(rows))
    return rows


def _held_counts(held):
    """`held` plus the launch counts since the last zeroing."""
    return {k: held.get(k, 0) + v for k, v in _launch_counts().items()}


def _scale_dense(tag, rec, model, n, qd, queries, gt, batches):
    """The dense scan: recalls, QPS at `batches`, then the stage split
    of a batch-2048 search, whose X1 launches are timing launches, held
    out of the counts (→ the counts the searches made)."""
    from gamma_tpu_torch.config import SearchParams
    dense = _scale_runner(model, n, SCALE_DENSE)
    assert model.scan_mode(SearchParams.from_dict(SCALE_DENSE)) == "dense"
    r = _scale_recalls(dense, qd, gt)
    r["qps"] = {b: b / _scale_batch(dense, qd, b)[1] for b in batches}
    rec["dense"] = r
    _scale_gate(tag, "dense recall", r["recall_at_10"],
                recall_at_1=r["recall_at_1"],
                recall_at_100=r["recall_at_100"], qps=r["qps"])
    held = _launch_counts()
    r["stages_b2048"] = _dense_stages(model,
                                      queries[np.arange(2048) % NQ_SCALE])
    _zero_counts()
    _step_memory(tag, rec, "dense searches", model.store, model)
    return held


def phase_10m(n=N_10M):
    """D-10M: bench.py:1192-1338 through the port, the JAX package's
    published 10M x 128 configuration on one card through its three
    capacity tiers (docs/CAPACITY_TIERS.md): a bf16 store mirror, IVFPQ
    nlist 2048, M 32, nprobe 64 over the PQ payload (no sidecar at
    ingest), 6 rebalance rounds, posting lists presized to 3x the mean;
    the dense scan (recall@1/10/100, batches 2048 and 4096), one gather
    request over the PQ codes (B3, X1 in the rerank), then
    release_recon() and build_sq_sidecar() and the SQ8 tier's folded
    scan (B2) with sq_rerank (X1), batches 512 and 768.  X1, B3 and B2
    are held against their plain versions on the phase's operands."""
    import torch
    tag, nlist = "10M", NLIST
    params = {"ncentroids": nlist, "nsubvector": M_SUB, "nprobe": NPROBE,
              "gather_payload": "pq", "train_rebalance": 6,
              "bucket_init_size": max(1024, 3 * n // nlist)}
    rec = {"phase": f"D-{tag}", "n": n, "d": D, "params": params,
           "memory": []}
    t_phase = time.perf_counter()
    recorder = _Recorder()
    recorder.x1 = True
    # what earlier phases left in reference cycles would read as this
    # phase's memory
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        corpus, queries, gt, rec["corpus_s"], rec["ground_truth_s"] = \
            _scale_data(n, D, 10)
        store, model = _scale_build(tag, rec, corpus, params,
                                    torch.bfloat16)
        del corpus
        assert not model.sq_active and model.sq_payload == "pq", rec
        qd = torch.from_numpy(queries).cuda()
        _zero_counts()
        recorder.start()
        # 1. the dense scan over the reconstruction mirror (X1 reranks)
        held = _scale_dense(tag, rec, model, n, qd, queries, gt,
                            (2048, 4096))

        # 2. the "gather / ADC" tier: one request over the PQ codes
        pq = _scale_runner(model, n, SCALE_GATHER)
        got, launched = _scale_search(pq, qd, held, ("gadc", "gather_rows"))
        r = rec["pq_gather"] = {"recall_at_10": _recall(got, gt),
                                "launches": launched}
        _scale_gate(tag, "pq gather recall", r["recall_at_10"],
                    launches=launched)
        r["breakdown"] = _scale_breakdown(pq, qd, NQ_SCALE)
        _step_memory(tag, rec, "pq gather", store, model)

        # 3. the capacity tier: drop the mirror, promote the SQ8 sidecar
        model.release_recon()
        _step_memory(tag, rec, "release_recon", store, model)
        t = time.perf_counter()
        ok = model.build_sq_sidecar()
        torch.cuda.synchronize()
        ce = model._cap_eff()
        side = rec["sidecar"] = {
            "active": bool(ok), "s": time.perf_counter() - t, "cap_eff": ce,
            "d_pad": model._sq_d_pad,
            "bytes": (model.sq_codes.numel() + model.sq_norms.numel() * 4)
            if ok else 0,
            "want_bytes": nlist * ce * (model._sq_d_pad + 4)}
        _gate(tag, "build_sq_sidecar", side)
        assert ok and side["bytes"] == side["want_bytes"], side
        _step_memory(tag, rec, "build_sq_sidecar", store, model)

        # 4. the SQ8 tier's folded scan with the exact rerank
        sq = _scale_runner(model, n, dict(SCALE_GATHER, sq_rerank=True))
        got, launched = _scale_search(
            lambda q: tuple(torch.cat(t) for t in zip(
                *[sq(q[s:s + 64]) for s in range(0, q.shape[0], 64)])),
            qd, held, ("gsq_fold", "gather_rows"))
        r = rec["sq8_gather"] = {"recall_at_10": _recall(got, gt),
                                 "launches": launched}
        r["qps"] = {b: b / _scale_batch(sq, qd, b)[1] for b in (512, 768)}
        _scale_gate(tag, "sq8 gather recall", r["recall_at_10"],
                    cap_eff=ce, launches=launched, qps=r["qps"])
        r["breakdown"] = _scale_breakdown(sq, qd, 512)
        _step_memory(tag, rec, "sq8 gather", store, model)
        recorder.stop()
        rec["launches"] = _held_counts(held)
        SCALE_ROWS.extend(_scale_checks(tag, recorder.calls, {
            "X1 10M bf16 rows": ("gather_rows",),
            "B3 10M width": ("gadc", False, True, 2.0),
            "B2 10M cap_eff": ("gsq_fold", True)}))
        _step_memory(tag, rec, "kernel checks", store, model)
    finally:
        recorder.stop()
        recorder.calls.clear()
        store = model = qd = pq = sq = None
        torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"phase D-{tag} engine:", json.dumps(rec))
    SCALE_RECS.append(rec)
    return rec


def phase_vgg(n=N_VGG):
    """D-vgg: bench.py:1092-1145 through the port, VGG-1M's geometry at
    the JAX package's published scale: d 512 rows from a 24-dim
    manifold, an f32 store mirror, IVFPQ nlist 2048, M 64 (dsub 8),
    nprobe 64 over the default SQ8 payload, lists presized to 4x the
    mean; the dense scan (recall@1/10/100, batch 2048; X1 on 2 KB f32
    rows), then one SQ8 gather request with sq_rerank (B1 at d_pad
    512).  X1 and B1 are held against their plain versions on the
    phase's operands."""
    import torch
    tag, nlist = "vgg", NLIST
    params = {"ncentroids": nlist, "nsubvector": M_VGG, "nprobe": NPROBE,
              "bucket_init_size": max(1024, 4 * n // nlist)}
    rec = {"phase": f"D-{tag}", "n": n, "d": D_VGG, "params": params,
           "memory": []}
    t_phase = time.perf_counter()
    recorder = _Recorder()
    recorder.x1 = True
    # what earlier phases left in reference cycles would read as this
    # phase's memory
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        corpus, queries, gt, rec["corpus_s"], rec["ground_truth_s"] = \
            _scale_data(n, D_VGG, 12, intrinsic=24)
        store, model = _scale_build(tag, rec, corpus, params,
                                    torch.float32)
        del corpus
        assert model.sq_active and model._sq_d_pad == D_VGG, rec
        qd = torch.from_numpy(queries).cuda()
        _zero_counts()
        recorder.start()
        held = _scale_dense(tag, rec, model, n, qd, queries, gt, (2048,))

        # one SQ8 gather request with the exact rerank (B1 at d_pad 512)
        sq = _scale_runner(model, n, dict(SCALE_GATHER, sq_rerank=True))
        got, launched = _scale_search(sq, qd, held, ("gsq", "gather_rows"))
        ce = model._cap_eff()
        r = rec["sq8_gather"] = {"recall_at_10": _recall(got, gt),
                                 "cap_eff": ce, "launches": launched}
        _scale_gate(tag, "sq8 gather recall", r["recall_at_10"],
                    cap_eff=ce, launches=launched)
        r["breakdown"] = _scale_breakdown(sq, qd, NQ_SCALE)
        _step_memory(tag, rec, "sq8 gather", store, model)
        recorder.stop()
        rec["launches"] = _held_counts(held)
        SCALE_ROWS.extend(_scale_checks(tag, recorder.calls, {
            "X1 f32 d512 rows": ("gather_rows", "float32"),
            "B1 d_pad 512": ("gsq", True)}))
        assert SCALE_ROWS[-1]["d_pad"] == D_VGG, SCALE_ROWS[-1]
        _step_memory(tag, rec, "kernel checks", store, model)
    finally:
        recorder.stop()
        recorder.calls.clear()
        store = model = qd = sq = None
        torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"phase D-{tag} engine:", json.dumps(rec))
    SCALE_RECS.append(rec)
    return rec


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
    own in phase E; for X1, the bf16 rows of D-dense: D-store's fp8
    rows are a row of their own)."""
    mine = [r for r in rows if r["kernel"] == name
            and r["operands"] == "engine"]
    assert mine, f"no engine operands were recorded for {name}"
    if name == "gadc":
        mine = [r for r in mine if not r["packed"] and r["masked"]
                and r["metric"] == "l2"]
    if name == "gather_rows":          # D-dense's bf16 rows, not D-store's
        mine = [r for r in mine if r["dtype"] == "bfloat16"]
    return max(mine, key=lambda r: r.get("groups", r.get("pairs",
                                                         r.get("k", 0))))


def _timed(name, fn, *a, **kw):
    """Run one phase and print its wall time on a line of its own."""
    t = time.perf_counter()
    out = fn(*a, **kw)
    print(f"phase {name} wall:", json.dumps(
        {"s": time.perf_counter() - t}))
    return out


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
    t_start = time.perf_counter()
    _timed("A", phase_a)
    _timed("B", phase_b)
    rows = _timed("C", phase_c)
    data = _data()
    recorder = _Recorder()
    _timed("D-det", phase_determinism, data)
    rec, gt = _timed("D", phase_d, data, recorder)
    adc_recs, b5_ops = {}, None
    for tag in ADC_ENGINES:
        adc_recs[tag], ops = _timed(f"D-{tag}", phase_adc_engine, tag, data,
                                    gt, recorder)
        b5_ops = ops if ops is not None else b5_ops
    b5 = _timed("D-b5", phase_b5, b5_ops)
    dense_recs = {tag: _timed(f"D-{tag}", phase_dense, tag, data, gt,
                              recorder)
                  for tag in ("dense", "opq")}
    store_rec, x1_fp8 = _timed("D-store", phase_store, data, gt, rec,
                               dense_recs["dense"], recorder)
    rows.append(x1_fp8)
    store_recs = [store_rec, *_timed("D-store-sweep", phase_store_sweep,
                                     data)]
    _timed("D-crash", phase_crash, data)
    flat_rec, flat_forms = _timed("D-flat", phase_ivfflat, data, gt,
                                  recorder)
    _timed("D-flat-exact", phase_flat_engine, data)
    _timed("D-facade", phase_facade, data)
    disk_recs = {tag: _timed(f"D-{tag}", phase_disk, tag, data, gt,
                             recorder)
                 for tag in ("disk", "disk-pq")}
    scann_rec = _timed("D-scann", phase_scann, data, recorder)
    _timed("D-bivf", phase_bivf, data, recorder)
    hnsw_rec = _timed("D-hnsw", phase_hnsw, data, gt)
    _timed("D-hnsw-200k", phase_hnsw_200k, data)
    serve_rec = _timed("D-serve", phase_serve, data, gt)
    del data
    rows += _timed("E", phase_e, rec, flat_rec, recorder.calls, b5_ops)
    recorder.calls.clear()
    rows += SHARD_ROWS
    # the JAX package's published scales, once the 1M corpus is freed
    _timed("D-10M", phase_10m)
    _timed("D-vgg", phase_vgg)
    rows += SCALE_ROWS
    runs = [rec, *adc_recs.values(), *dense_recs.values(),
            *disk_recs.values(), scann_rec, hnsw_rec, serve_rec]
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
    # D-rt's, D-shard's, the store options' and the scale phases' runs,
    # each counted from 0 on its own
    for r in RT_RECS + SHARD_RECS + store_recs + SCALE_RECS:
        for name, n in r["launches"].items():
            launches[name] += n
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
    print("chip_smoke wall:", json.dumps(
        {"s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
