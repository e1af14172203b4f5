#!/usr/bin/env python3
"""H100 smoke run of the PyTorch/CUDA port (gamma_tpu_torch).

    python3 chip_smoke.py            # needs one CUDA card; no flags needed

Builds the port's CUDA kernels from csrc/, holds each kernel against its
plain PyTorch version at the main path's shapes, then drives the port's
GammaEngine through its public API at the SIFT1M geometry of the TPU
bench (IVFPQ, nlist 2048, M 32, nprobe 64, residual-SQ8 gather tier):
ingest, auto-train, searches (plain, hybrid, score range, a hot list that
switches the scan to the folded kernel), delete, dump and load.  Every
phase raises on a failed check, so the run exits non-zero and prints no
result line; the last stdout line is the device record.

Phases (one line each): A card, B kernel build, C kernels vs plain at
the slice's nominal shapes, D engine (its searches also record the
operands they hand each kernel, and a time breakdown), E kernels vs
plain at the engine's own widths and on those recorded operands.
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
BIG = 3.0e38


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
    print(smi)
    print("phase A card:", json.dumps({
        "nvidia_smi": smi, "torch": torch.__version__,
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
    from gamma_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.load("gsq")
    print("phase B build:", json.dumps({
        "gsq_build_s": cuda_build.BUILD_SECONDS["gsq"],
        "load_s": time.perf_counter() - t0,
        "build_dir": os.path.relpath(cuda_build.BUILD_DIR, HERE)}))


# ---------------------------------------------------------------------
# C. kernels against their plain versions
# ---------------------------------------------------------------------

def _operands(cap, tile, metric, masked, seed):
    """Grouped operands at the main path's shapes: nlist 2048, d_pad 128,
    B 1024 x P 64 probes grouped Q = 64 per list."""
    import torch
    from gamma_tpu_torch.ops.gadc import build_groups, group_bound
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    b, p, q_pad = 1024, NPROBE, 64
    codes = torch.randint(0, 256, (NLIST, cap, D), generator=g, device=dev,
                          dtype=torch.uint8)
    lens = torch.randint(1, cap + 1, (NLIST,), generator=g, device=dev,
                         dtype=torch.int32)
    norms = 100.0 + 900.0 * torch.rand((NLIST, cap), generator=g,
                                       device=dev)
    list_ids = torch.randint(0, NLIST, (b, p), generator=g, device=dev)
    g_pad = group_bound(b, p, NLIST, q_pad)
    glist, ntiles, _, _, _ = build_groups(list_ids, lens, q_pad=q_pad,
                                          tile=tile, g_pad=g_pad)
    qs = (0.02 * torch.randn((g_pad, q_pad, D), generator=g, device=dev)
          ).to(torch.bfloat16)
    if masked:
        pos = torch.arange(cap, device=dev)[None, :]
        dead = (pos >= lens[:, None]) | (
            torch.rand((NLIST, cap), generator=g, device=dev) < 0.05)
        bias = torch.where(dead, BIG, 0.0)
        nrm = norms + bias if metric == "l2" else bias
    else:
        nrm = norms
    return codes, nrm.contiguous(), glist, ntiles, qs


def _bound(plain_live):
    med = float(plain_live.abs().median()) if plain_live.numel() else 0.0
    return 1e-4 * max(1.0, med)


def _metric(alpha):
    return "l2" if alpha == 2.0 else "ip"


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
    row = dict(kernel="gsq", operands=origin, cap=cap, tile=tile,
               metric=_metric(kw["alpha"]), masked=kw["masked"],
               groups=int(ref.shape[0]), q=int(ref.shape[1]),
               max_abs_err=max_abs, max_rel_err=rel, bound=tol)
    assert torch.isfinite(got).all(), ("non-finite B1 output", row)
    assert max_abs <= tol, row
    assert dead_exact, ("skipped/masked B1 slots differ from plain", row)
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
               groups=g_n, q=q_n, max_abs_err=max_abs, max_rel_err=rel,
               bound=tol)
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
    if differ.any():
        gap = float((picked[differ] - pv[differ]).abs().max())
        assert gap <= tol, ("B2 argmin is not a near-tie", gap, row)
    del full, picked, vals, args, pv, pa, live, err
    row["ms"] = cuda_time(lambda: gsq.gsq_fold(*ops, **kw))
    row["plain_ms"] = cuda_time(lambda: gsq._gsq_fold_plain(*ops, **kw),
                                iters=3, warmup=1)
    return row


def _check_b1(cap, metric, masked, seed):
    tile = min(512, cap)
    ops = _operands(cap, tile, metric, masked, seed)
    return _compare_b1(ops, dict(
        tile=tile, alpha=2.0 if metric == "l2" else 1.0, masked=masked,
        with_norms=masked or metric == "l2"), "synthetic")


def _check_b2(cap, metric, seed):
    from gamma_tpu_torch.ops import gsq
    tile, _ = gsq.fold_geometry(cap, 4096, 8)
    ops = _operands(cap, tile, metric, True, seed)
    return _compare_b2(ops, dict(
        tile=tile, alpha=2.0 if metric == "l2" else 1.0, fold=8),
        "synthetic")


def phase_c():
    """The slice's nominal shapes: B1 at cap 1024, B2 at cap 8192."""
    import torch
    rows = []
    for i, metric in enumerate(("l2", "ip")):
        rows.append(_check_b1(1024, metric, False, 10 + i))
        rows.append(_check_b1(1024, metric, True, 20 + i))
        rows.append(_check_b2(8192, metric, 30 + i))
        torch.cuda.empty_cache()
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


def _qps(eng, queries, reps=5):
    import torch
    _search(eng, queries)                                   # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _search(eng, queries)
        times.append(time.perf_counter() - t0)
    return queries.shape[0] / float(np.median(times))


def _breakdown(eng, model, queries, reps=5):
    """Where one batch-1024 engine search spends its time: the host clock
    inside IVFPQIndex.search (synchronized, so it holds the device work)
    against the whole GammaEngine.search, and the device time of each
    kernel of one search from torch.profiler's CUDA trace."""
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
            _search(eng, queries)
            outer.append(time.perf_counter() - t)
    finally:
        del model.search
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _search(eng, queries)
        torch.cuda.synchronize()
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
            "device_ms_by_kernel": dict(top)}


class _Recorder:
    """Wraps the kernel wrappers of ops/gsq.py while the engine runs and
    keeps, per (kernel, masked), the operands of its widest call (most
    groups), so phase E can hold each kernel against its plain version
    on exactly what the main path handed it.  It launches nothing."""

    def __init__(self, gsq_mod):
        self.mod = gsq_mod
        self.orig = {"gsq": gsq_mod.gsq, "gsq_fold": gsq_mod.gsq_fold}
        self.calls = {}

    def _wrap(self, name):
        fn = self.orig[name]

        def wrapper(*ops, **kw):
            key = (name, kw.get("masked", True))
            old = self.calls.get(key)
            if old is None or ops[4].shape[0] > old[0][4].shape[0]:
                self.calls[key] = (ops, dict(kw))
            return fn(*ops, **kw)
        return wrapper

    def start(self):
        for name in self.orig:
            setattr(self.mod, name, self._wrap(name))

    def stop(self):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


def phase_d():
    import torch
    sys.path.insert(0, HERE)
    from bench import _make_corpus          # the TPU bench's generator
    from gamma_tpu_torch import (Doc, EngineConfig, FieldInfo, GammaEngine,
                                 RangeFilter, TableInfo, TermFilter,
                                 VectorInfo)
    from gamma_tpu_torch.config import DataType
    from gamma_tpu_torch.ops import gsq

    n = N_DOCS
    rec = {"n": n}
    rng = np.random.default_rng(0)
    corpus, _ = _make_corpus(n, D, 1024, rng)
    queries = (corpus[rng.choice(n, 1024, replace=False)]
               + 0.5 * rng.normal(size=(1024, D))).astype(np.float32)
    path = tempfile.mkdtemp(prefix="gamma_torch_smoke_")
    engines = []
    recorder = _Recorder(gsq)
    try:
        eng = GammaEngine(EngineConfig(path=path))
        engines.append(eng)
        eng.create_table(TableInfo(
            name="smoke",
            fields=[FieldInfo("price", DataType.FLOAT, is_index=True),
                    FieldInfo("tag", DataType.STRING, is_index=True)],
            vectors=[VectorInfo("emb", D)],
            indexing_size=INDEXING_SIZE,
            retrieval_types=["IVFPQ"],
            retrieval_params=[{"ncentroids": NLIST, "nsubvector": M_SUB,
                               "nprobe": NPROBE, "scan_mode": "gather"}]))
        model = eng.vm.index_for("emb")
        train_s = []
        orig_train = model.train

        def timed_train(x, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            orig_train(x, *a, **kw)
            torch.cuda.synchronize()
            train_s.append(time.perf_counter() - t)

        model.train = timed_train

        def ingest(rows, start):
            docs = [Doc(key=f"k{start + i}",
                        fields={"price": float((start + i) % 500),
                                "tag": f"t{(start + i) % 5}"},
                        vectors={"emb": rows[i]})
                    for i in range(rows.shape[0])]
            assert all(c == 0 for c in eng.add_or_update_docs(docs))
            eng.flush()                  # device ingest (the indexer pump)

        # every kernel count starts at 0 for the engine's own run
        for key in gsq.LAUNCHES:
            gsq.LAUNCHES[key] = 0
        recorder.start()
        t0 = time.perf_counter()
        step = n // 10
        for s in range(0, n, step):
            ingest(corpus[s:s + step], s)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        st = eng.engine_status()
        assert st.index_status.name == "INDEXED", st
        assert st.min_indexed_num == n, st
        rec.update(ingest_s=ingest_s, docs_per_s=n / ingest_s,
                   train_s=train_s[0], cap_eff=model._cap_eff())

        # self-retrieval, recall@10 against exact f64, QPS at batch 1024
        sel = np.random.default_rng(1).choice(n, 1000, replace=False)
        top1 = _ids(_search(eng, corpus[sel]), 1)[:, 0]
        rec["self_top1"] = float(np.mean(top1 == sel))
        gt = _exact_topk(corpus, queries[:1000], TOPK)
        rec["recall_at_10"] = _recall(_ids(_search(eng, queries[:1000])), gt)
        rec["qps_b1024"] = _qps(eng, queries)
        assert rec["self_top1"] >= 0.99, rec
        assert rec["recall_at_10"] >= 0.95, rec
        rec["breakdown_b1024"] = _breakdown(eng, model, queries)

        # range + term hybrid: every hit satisfies both predicates
        res = _search(eng, queries[:64], fields=["price", "tag"],
                      range_filters=[RangeFilter("price", 100.0, 300.0)],
                      term_filters=[TermFilter("tag", "t1")])
        hits = [it for sr in res for it in sr.result_items]
        assert hits and all(100.0 <= it.attributes["price"] <= 300.0
                            and it.attributes["tag"] == "t1"
                            for it in hits), "hybrid predicate violated"
        rec["hybrid_hits"] = len(hits)

        # score range (scans with the unmasked kernel): scores in range
        base = _search(eng, queries[:64])
        hi = float(np.median([sr.result_items[4].score for sr in base]))
        res = _search(eng, queries[:64], min_score=0.0, max_score=hi)
        scores = [it.score for sr in res for it in sr.result_items]
        assert scores and all(0.0 <= s <= hi for s in scores), "score range"
        rec["score_range_hits"] = len(scores)

        # a hot list: 4096 near-duplicates of one doc push the live
        # watermark past 4096 slots, so the scan switches to B2
        hot = (corpus[7] + 1e-3 * rng.normal(size=(4096, D))).astype(
            np.float32)
        ingest(hot, n)
        rec["cap_eff_hot"] = model._cap_eff()
        assert rec["cap_eff_hot"] >= 4096, rec
        allx = np.concatenate([corpus, hot])
        gt = _exact_topk(allx, queries[:1000], TOPK)
        rec["recall_at_10_hot"] = _recall(
            _ids(_search(eng, queries[:1000])), gt)
        rec["qps_b1024_hot"] = _qps(eng, queries)
        assert rec["recall_at_10_hot"] >= 0.95, rec

        # delete: the doc vanishes from its own search
        victim = int(sel[0])
        assert eng.delete(f"k{victim}") == 0
        got = _ids(_search(eng, corpus[victim:victim + 1]))[0]
        assert victim not in got, "deleted doc still returned"

        # dump, then a fresh engine loads identical results
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
        torch.cuda.synchronize()
        rec["launches"] = dict(gsq.LAUNCHES)
        assert gsq.LAUNCHES["gsq"] > 0 and gsq.LAUNCHES["gsq_fold"] > 0, rec
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        recorder.stop()
        for e in engines:
            e.close()
        shutil.rmtree(path, ignore_errors=True)
    print("phase D engine:", json.dumps(rec))
    return rec, recorder.calls


# ---------------------------------------------------------------------
# E. kernels against their plain versions at the engine's widths
# ---------------------------------------------------------------------

def phase_e(rec, calls):
    """Synthetic operands at the scan widths the engine reached (B1 at
    cap_eff with 512-slot logical tiles, B2 at the hot cap_eff with
    fold_geometry's tile), then the very operands the engine's widest
    search handed each kernel."""
    import torch
    assert ("gsq_fold", True) in calls and any(
        k[0] == "gsq" for k in calls), sorted(calls)
    rows = [_check_b1(rec["cap_eff"], "l2", True, 40),
            _check_b1(rec["cap_eff"], "l2", False, 41),
            _check_b2(rec["cap_eff_hot"], "l2", 42)]
    torch.cuda.empty_cache()
    for (name, _), (ops, kw) in sorted(calls.items()):
        check = _compare_b1 if name == "gsq" else _compare_b2
        rows.append(check(ops, kw, "engine"))
        torch.cuda.empty_cache()
    print("phase E kernels:", json.dumps(rows))
    return rows


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
    rec, calls = phase_d()
    rows += phase_e(rec, calls)
    del calls
    kernels = []
    for name, line in (("gsq", 107), ("gsq_fold", 143)):
        mine = [r for r in rows if r["kernel"] == name]
        # the times are those of the engine's widest call's own operands
        main_row = max((r for r in mine if r["operands"] == "engine"),
                       key=lambda r: r["groups"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gamma_tpu_torch/csrc/gsq.cu",
            "replaces": f"gamma_tpu/ops/pallas_gsq.py:{line}",
            "launches": rec["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
