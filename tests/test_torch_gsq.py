"""Parity of the port's grouped SQ8 scan (gamma_tpu_torch.ops.gsq) with
the JAX package's Pallas scan, run in interpret mode as
tests/test_pallas_gsq.py runs it on the CPU.  On CPU tensors the port's
kernel wrappers take their plain versions, so these tests pin the
arithmetic the CUDA kernels are held to on the card (chip_smoke.py).

Tolerances: 1e-4 x median|ref| on live slots (summation order only —
both sides round the query operand to bf16 identically); skipped-tile
slots exact at the kernel level; fold argmins equal outside near-ties.
The raw-bf16-row form (the IVFFlat payload) and the f32 form (`precise`)
feed both sides the same bf16 rows / f32 queries and are held to 1e-5 x
median|ref| (f32 sums of exact products in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu.ops import pallas_gadc as jg
from gamma_tpu.ops import pallas_gsq as js
from gamma_tpu_torch.ops import gadc as tg
from gamma_tpu_torch.ops import gsq as ts

BIG = 3.0e38


def _t(a):
    return torch.from_numpy(np.array(a))


def _state(rng, nlist, cap, d, d_pad, *, residual=True):
    """Encoded lists (port encoder; codes are checked against JAX's in
    test_encode_sq_exact) → numpy (codes, norms, lens, cents, scale, off)."""
    cents = rng.normal(size=(nlist, d)).astype(np.float32) * 3.0
    rows = cents[:, None, :] + 0.3 * rng.normal(size=(nlist, cap, d))
    rows = rows.astype(np.float32)
    res = (rows - cents[:, None, :]) if residual else rows
    scale, off = ts.train_sq(_t(res.reshape(-1, d)))
    codes, norms = ts.encode_sq(
        _t(rows.reshape(-1, d)), scale, off,
        _t(np.repeat(cents, cap, 0)) if residual else None,
        d_pad=d_pad, residual=residual)
    lens = rng.integers(0, cap + 1, size=nlist).astype(np.int32)
    return (codes.numpy().reshape(nlist, cap, d_pad),
            norms.numpy().reshape(nlist, cap), lens, cents,
            scale.numpy(), off.numpy())


def _bias(rng, lens, cap):
    dead = (np.arange(cap)[None, :] >= lens[:, None]) | (
        rng.random((lens.size, cap)) < 0.1)
    return np.where(dead, BIG, 0.0).astype(np.float32)


def _close(got, ref, live, tol_scale=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    floor = max(float(np.median(np.abs(ref[live]))), 1.0)
    err = np.abs(got[live] - ref[live]).max(initial=0.0)
    assert err <= tol_scale * floor, (err, tol_scale * floor)


def test_grouping_helpers_exact():
    rng = np.random.default_rng(0)
    for b, p, nlist in [(6, 3, 10), (64, 8, 16), (1024, 64, 2048)]:
        q = jg.default_q_pad(b, p, nlist)
        assert tg.default_q_pad(b, p, nlist) == q
        assert tg.group_bound(b, p, nlist, q) == jg.group_bound(b, p,
                                                                nlist, q)
    nlist, b, p, q_pad, tile = 12, 20, 4, 4, 16
    lens = rng.integers(0, 70, size=nlist).astype(np.int32)
    li = rng.integers(0, nlist, size=(b, p)).astype(np.int32)
    li[:, 0] = 3                       # one list spills into chunk groups
    g_pad = jg.group_bound(b, p, nlist, q_pad)
    ref = jg.build_groups(jnp.asarray(li), jnp.asarray(lens), q_pad=q_pad,
                          tile=tile, g_pad=g_pad)
    got = tg.build_groups(_t(li), _t(lens), q_pad=q_pad, tile=tile,
                          g_pad=g_pad)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_train_sq_matches():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3000, 12)).astype(np.float32) * 0.7
    js_scale, js_off = js.train_sq(jnp.asarray(x))
    ts_scale, ts_off = ts.train_sq(_t(x))
    np.testing.assert_allclose(ts_scale.numpy(), np.asarray(js_scale),
                               rtol=1e-5)
    np.testing.assert_allclose(ts_off.numpy(), np.asarray(js_off),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("residual", [True, False])
def test_encode_sq_exact(residual):
    """Same (scale, off) → identical codes (padding dims 0), norms of the
    dequantized FULL point to 1e-5."""
    rng = np.random.default_rng(2)
    n, d, d_pad = 500, 12, 16
    cents = rng.normal(size=(n, d)).astype(np.float32)
    rows = (cents + 0.2 * rng.normal(size=(n, d))).astype(np.float32)
    scale, off = js.train_sq(jnp.asarray(rows - cents if residual else rows))
    jc, jn = js.encode_sq(jnp.asarray(rows), scale, off,
                          jnp.asarray(cents) if residual else None,
                          d_pad=d_pad, residual=residual)
    tc, tn = ts.encode_sq(_t(rows), _t(scale), _t(off),
                          _t(cents) if residual else None, d_pad=d_pad,
                          residual=residual)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)


def _bf16(a):
    """A float array rounded to bf16, as float32 (exact in both
    frameworks' bf16)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _rows(rng, rows, nlist, cap, d_pad):
    """(numpy rows, their squared norms or SQ-like norms): u8 codes, or
    finite bf16-representable raw rows as float32."""
    if rows == "bf16":
        r = _bf16(rng.normal(size=(nlist, cap, d_pad)))
        return r, (r.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    return (rng.integers(0, 256, (nlist, cap, d_pad)).astype(np.uint8),
            rng.uniform(10, 50, (nlist, cap)).astype(np.float32))


def _j_rows(codes):
    """numpy rows → the JAX operand (u8 codes, or bf16 rows)."""
    return jnp.asarray(codes, jnp.uint8 if codes.dtype == np.uint8
                       else jnp.bfloat16)


def _t_rows(codes):
    """numpy rows → the port's operand."""
    t = torch.from_numpy(codes)
    return t if codes.dtype == np.uint8 else t.to(torch.bfloat16)


def _grouped_operands(rng, masked, metric, *, nlist=10, cap=40, d_pad=16,
                      b=8, p=3, q_pad=4, tile=16, rows="u8", precise=False):
    codes, norms = _rows(rng, rows, nlist, cap, d_pad)
    lens = rng.integers(0, cap + 1, nlist).astype(np.int32)
    li = rng.integers(0, nlist, (b, p)).astype(np.int32)
    g_pad = jg.group_bound(b, p, nlist, q_pad)
    glist, ntiles = jg.build_groups(jnp.asarray(li), jnp.asarray(lens),
                                    q_pad=q_pad, tile=tile, g_pad=g_pad)[:2]
    qs = jnp.asarray((1.0 if rows == "bf16" else 0.05)
                     * rng.normal(size=(g_pad, q_pad, d_pad)),
                     jnp.float32 if precise else jnp.bfloat16)
    nrm = norms
    if masked:
        bias = _bias(rng, lens, cap)
        nrm = norms + bias if metric == "l2" else bias
    return codes, nrm, glist, ntiles, qs, q_pad, tile


def _t_qs(qs):
    """The JAX query operand (bf16 or f32) → the port's, same values."""
    t = _t(np.asarray(qs.astype(jnp.float32)))
    return t if qs.dtype == jnp.float32 else t.to(torch.bfloat16)


def _b1_case(rng, metric, masked, tol_scale=1e-4, **shape):
    """B1 operand-level parity: live slots to tolerance, skipped tiles
    bit-identical (copies of nrm, or 0)."""
    precise = shape.get("precise", False)
    codes, nrm, glist, ntiles, qs, q_pad, tile = _grouped_operands(
        rng, masked, metric, **shape)
    alpha = 2.0 if metric == "l2" else 1.0
    with_norms = masked or metric == "l2"
    nlist, cap, _ = codes.shape
    ref = np.asarray(js._gsq_call(
        _j_rows(codes), jnp.asarray(nrm).reshape(nlist, 1, cap), glist,
        ntiles, qs, q_pad=q_pad, tile=tile, alpha=alpha,
        with_norms=with_norms, precise=precise, interpret=True,
        masked=masked))
    before = dict(ts.LAUNCHES)
    got = ts.gsq(_t_rows(codes), _t(nrm), _t(glist), _t(ntiles), _t_qs(qs),
                 tile=tile, alpha=alpha, with_norms=with_norms,
                 masked=masked, precise=precise).numpy()
    assert ts.LAUNCHES == before, "the plain version counted a launch"
    live = (np.arange(cap)[None, :]
            < np.asarray(ntiles)[:, None] * tile)[:, None, :]
    live = np.broadcast_to(live, ref.shape) & (ref < 1e37)
    assert live.any()
    _close(got, ref, live, tol_scale)
    np.testing.assert_array_equal(got[~live], ref[~live])


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("masked", [False, True])
def test_gsq_kernel_plain_vs_pallas(metric, masked):
    """B1 operand-level parity: live slots to tolerance, skipped tiles
    bit-identical (copies of nrm, or 0)."""
    _b1_case(np.random.default_rng(3), metric, masked)


@pytest.mark.parametrize("metric,masked,shape", [
    ("ip", False, dict(cap=1000, tile=512, q_pad=8)),
    ("l2", True, dict(cap=1000, tile=512, q_pad=8)),
    ("ip", False, dict(cap=96, tile=32, q_pad=128, b=90, p=2)),
    ("l2", False, dict(cap=64, tile=32, d_pad=48, q_pad=16))])
def test_gsq_edge_shapes_plain_vs_pallas(metric, masked, shape):
    """B1 at the edge shapes the card's run drives: IP without norms, a
    cap that no logical tile divides (1000 under tile 512: the last tile
    ragged), the narrowest and the widest group, a d_pad of 48.  The
    same parity and tolerance as the small case."""
    _b1_case(np.random.default_rng(9), metric, masked, nlist=4, **shape)


@pytest.mark.parametrize("d_pad", [48, 128])
@pytest.mark.parametrize("q_n", [8, 64, 128])
@pytest.mark.parametrize("cap", [1000, 1024, 1280, 4864])
def test_scan_block_geometry(cap, q_n, d_pad):
    """Blocks and warp units of the CUDA plain scan cover every slot of
    a list exactly once, in whole 32-slot units but the last, whatever
    the logical tile; a block lies inside one logical tile wherever a
    multiple of 32 divides the tile; and the block's shared memory fits
    the card."""
    for tile in (256, 512, cap):
        span = ts.scan_block_slots(cap, tile)
        assert span % ts.SCAN_UNIT == 0
        assert ts.SCAN_UNIT <= span <= ts.SCAN_MAX_SLOTS
        covered = np.zeros(cap, np.int64)
        for y, warp, lo, hi in ts.scan_units(cap, span):
            assert 0 <= warp < ts.SCAN_WARPS and lo % ts.SCAN_UNIT == 0
            assert y * span <= lo < hi <= min(cap, (y + 1) * span)
            assert hi - lo == ts.SCAN_UNIT or hi == cap
            covered[lo:hi] += 1
        assert (covered == 1).all()
        if any(tile % n == 0 for n in range(32, min(tile, 512) + 1, 32)):
            assert tile % span == 0
    assert ts.scan_smem_bytes(q_n, d_pad) <= ts._SMEM_MAX
    nt = min(8, -(-q_n // 8))
    assert ts.scan_smem_bytes(q_n, d_pad) >= (
        q_n * d_pad * 2 + ts.SCAN_WARPS * nt * 8 * 36 * 4)


# the row and product forms beside u8 codes x bf16 queries: (rows, precise)
FORMS = [("bf16", False), ("u8", True), ("bf16", True)]


@pytest.mark.parametrize("rows,precise", FORMS)
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("masked", [False, True])
def test_gsq_row_forms_plain_vs_pallas(metric, masked, rows, precise):
    """B1 over raw bf16 rows (`_rows_as`: used as they are) and with the
    f32 product (`precise`, on u8 codes and on bf16 rows): the same
    operands through the interpreted kernel, 1e-5 x median|ref|."""
    _b1_case(np.random.default_rng(11), metric, masked, tol_scale=1e-5,
             rows=rows, precise=precise)


@pytest.mark.parametrize("rows,precise", FORMS)
def test_gsq_row_forms_edge_shapes(rows, precise):
    """The forms at a ragged cap under 512-slot tiles and a d_pad of 48."""
    _b1_case(np.random.default_rng(12), "l2", True, tol_scale=1e-5, nlist=4,
             cap=1000, tile=512, q_pad=8, d_pad=48, rows=rows,
             precise=precise)


def _fold_case(rng, metric, *, nlist=8, cap=64, d_pad=16, b=6, p=3, q_pad=4,
               fold=8, tile=32, rows="u8", precise=False, tol_scale=1e-4):
    """B2 operand-level parity: strided per-bin min to tolerance, skipped
    tiles (max of the tile's operand, arg 0) exact, argmins equal except
    where the plain version shows a near-tie."""
    tile, lb = ts.fold_geometry(cap, tile, fold)
    codes, norms = _rows(rng, rows, nlist, cap, d_pad)
    lens = rng.integers(0, cap + 1, nlist).astype(np.int32)
    bias = _bias(rng, lens, cap)
    nrm = norms + bias if metric == "l2" else bias
    li = rng.integers(0, nlist, (b, p)).astype(np.int32)
    g_pad = jg.group_bound(b, p, nlist, q_pad)
    glist, ntiles = jg.build_groups(jnp.asarray(li), jnp.asarray(lens),
                                    q_pad=q_pad, tile=tile, g_pad=g_pad)[:2]
    qs = jnp.asarray((1.0 if rows == "bf16" else 0.05)
                     * rng.normal(size=(g_pad, q_pad, d_pad)),
                     jnp.float32 if precise else jnp.bfloat16)
    alpha = 2.0 if metric == "l2" else 1.0
    rv, ra = map(np.asarray, js._gsq_fold_call(
        _j_rows(codes), jnp.asarray(nrm).reshape(nlist, 1, cap), glist,
        ntiles, qs, q_pad=q_pad, tile=tile, alpha=alpha, precise=precise,
        fold=fold, interpret=True))
    args_t = [_t_rows(codes), _t(nrm), _t(glist), _t(ntiles), _t_qs(qs)]
    gv, ga = ts.gsq_fold(*args_t, tile=tile, alpha=alpha, fold=fold,
                         precise=precise)
    gv, ga = gv.numpy(), ga.numpy()
    nt = cap // tile
    live_t = np.arange(nt)[None, :] < np.asarray(ntiles)[:, None]
    live = np.repeat(live_t, lb, axis=1)[:, None, :]
    live = np.broadcast_to(live, rv.shape) & (rv < 1e37)
    assert live.any()
    _close(gv, rv, live, tol_scale)
    np.testing.assert_array_equal(gv[~live], rv[~live])
    np.testing.assert_array_equal(ga[~live], ra[~live])
    full = ts.gsq(*args_t, tile=tile, alpha=alpha, with_norms=True,
                  masked=True, precise=precise).numpy()
    full = full.reshape(g_pad, q_pad, nt, fold, lb)
    differ = live & (ga != ra)
    if differ.any():
        g_i, q_i, f_i = np.nonzero(differ)
        at_ref = full[g_i, q_i, f_i // lb, ra[differ], f_i % lb]
        assert np.abs(at_ref - gv[differ]).max() <= 1e-4 * max(
            1.0, float(np.median(np.abs(rv[live]))))
    return tile, lb


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gsq_fold_kernel_plain_vs_pallas(metric):
    """B2 operand-level parity: strided per-bin min to tolerance, skipped
    tiles (max of the tile's operand, arg 0) exact, argmins equal except
    where the plain version shows a near-tie."""
    _fold_case(np.random.default_rng(4), metric)


@pytest.mark.parametrize("rows,precise", FORMS)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gsq_fold_row_forms_plain_vs_pallas(metric, rows, precise):
    """B2 over raw bf16 rows and with the f32 product: the fold, the
    strict `<` and the skipped-tile value do not change with the form."""
    _fold_case(np.random.default_rng(13), metric, rows=rows,
               precise=precise, tol_scale=1e-5)


@pytest.mark.parametrize("metric,q_pad,b", [("l2", 8, 6), ("ip", 128, 90)])
def test_gsq_fold_hot_geometry_plain_vs_pallas(metric, q_pad, b):
    """B2 at the engine's hot-list geometry, where fold_geometry gives
    tile = cap = 4864 and lb 608 (no multiple of 128), at the narrowest
    and the widest group: the same parity as the small case, tolerance
    1e-4 x median|ref| for the order of the f32 sum."""
    tile, lb = _fold_case(np.random.default_rng(8), metric, nlist=3,
                          cap=4864, b=b, p=2, q_pad=q_pad, tile=4096)
    assert (tile, lb) == (4864, 608)


@pytest.mark.parametrize("lb,max_bins,nbins", [
    (512, 640, 512), (608, 640, 608), (100, 640, 112), (8, 640, 16),
    (1016, 640, 256), (512, 320, 256), (608, 320, 304), (1016, 320, 256)])
def test_fold_bin_chunk(lb, max_bins, nbins):
    """Bins of a logical tile per block of the CUDA folded scan: whole
    16-row MMA tiles, at most max_bins, a divisor of lb where one exists
    (no ragged warp), else ragged only in the tile's last block."""
    n = ts.fold_bin_chunk(lb, max_bins)
    assert n == nbins
    assert n % ts.FOLD_BIN_ROWS == 0 and n <= max_bins
    divisors = [d for d in range(16, min(lb, max_bins) + 1, 16)
                if lb % d == 0]
    if divisors:
        assert n == max(divisors)
    else:
        blocks = -(-lb // n)
        assert (blocks - 1) * n < lb <= blocks * n


def test_gsq_fold_rejects_bad_geometry():
    codes = torch.zeros((2, 128, 16), dtype=torch.uint8)
    nrm = torch.zeros((2, 128))
    g = torch.zeros(1, dtype=torch.int32)
    qs = torch.zeros((1, 4, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError):          # one bit per fold slot: <= 32
        ts.gsq_fold(codes, nrm, g, g, qs, tile=128, alpha=2.0, fold=64)
    with pytest.raises(ValueError):          # cap is no multiple of tile
        ts.gsq_fold(codes, nrm, g, g, qs, tile=48, alpha=2.0, fold=8)
    with pytest.raises(NotImplementedError):
        ts.gsq_fold(*(t.to("meta") for t in (codes, nrm, g, g, qs)),
                    tile=128, alpha=2.0, fold=8)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("masked,fold", [(False, 1), (True, 1), (True, 8)])
def test_grouped_sq_scan_vs_pallas(metric, masked, fold):
    """Whole grouped scan (grouping, bf16 operand, kernel, ungroup,
    residual constants) against JAX grouped_sq_scan(interpret=True),
    small logical tiles as tests/test_pallas_gsq.py uses."""
    rng = np.random.default_rng(5)
    nlist, cap, d, d_pad, b, p, q_pad = 10, 32, 12, 16, 6, 3, 4
    codes, norms, lens, cents, scale, off = _state(rng, nlist, cap, d, d_pad)
    q = rng.normal(size=(b, d)).astype(np.float32) * 2.0
    li = np.stack([rng.choice(nlist, p, replace=False)
                   for _ in range(b)]).astype(np.int32)
    bias = _bias(rng, lens, cap) if masked else None
    kw = dict(metric=metric, q_pad=q_pad, tile=16, fold=fold)
    ref = js.grouped_sq_scan(
        jnp.asarray(codes), jnp.asarray(norms), jnp.asarray(lens),
        jnp.asarray(li), jnp.asarray(q), jnp.asarray(scale),
        jnp.asarray(off), jnp.asarray(cents),
        bias=None if bias is None else jnp.asarray(bias), interpret=True,
        **kw)
    got = ts.grouped_sq_scan(
        _t(codes), _t(norms), _t(lens), _t(li), _t(q), _t(scale), _t(off),
        _t(cents), bias=None if bias is None else _t(bias), **kw)
    if fold > 1:
        (ref, ref_args), (got, got_args) = ref, got
        ref_args, got_args = np.asarray(ref_args), got_args.numpy()
    ref, got = np.asarray(ref), got.numpy()
    if masked:
        dead = ref >= 1e37
        np.testing.assert_array_equal(got >= 1e37, dead)
        live = ~dead
    else:
        # unmasked: slots past a list's length carry only the query
        # constants; compare what a caller can rely on (in-length slots)
        live = np.broadcast_to(
            np.arange(cap)[None, None, :] < lens[li][..., None], ref.shape)
    _close(got, ref, live)
    if fold > 1:
        same = got_args == ref_args
        assert same[live].mean() > 0.95


def _raw_state(rng, nlist, cap, d):
    """bf16 payload rows (float32 values that bf16 holds exactly), their
    squared norms, list lengths."""
    rows = _bf16(rng.normal(size=(nlist, cap, d)))
    norms = (rows.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    return rows, norms, rng.integers(0, cap + 1, size=nlist).astype(np.int32)


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("masked,fold", [(False, 1), (True, 1), (True, 8)])
def test_grouped_sq_scan_raw_rows_vs_pallas(metric, masked, fold, precise):
    """grouped_sq_scan(scale=None, off=None) over raw bf16 rows (the
    IVFFlat scan) against the JAX call in interpret mode, default and
    f32 product, 1e-5 x median|ref|."""
    rng = np.random.default_rng(14)
    nlist, cap, d, b, p, q_pad = 10, 32, 16, 6, 3, 4
    rows, norms, lens = _raw_state(rng, nlist, cap, d)
    q = rng.normal(size=(b, d)).astype(np.float32)
    li = np.stack([rng.choice(nlist, p, replace=False)
                   for _ in range(b)]).astype(np.int32)
    bias = _bias(rng, lens, cap) if masked else None
    kw = dict(metric=metric, q_pad=q_pad, tile=16, fold=fold,
              precise=precise)
    ref = js.grouped_sq_scan(
        jnp.asarray(rows, jnp.bfloat16), jnp.asarray(norms),
        jnp.asarray(lens), jnp.asarray(li), jnp.asarray(q), None, None,
        bias=None if bias is None else jnp.asarray(bias), interpret=True,
        **kw)
    got = ts.grouped_sq_scan(
        _t(rows).to(torch.bfloat16), _t(norms), _t(lens), _t(li), _t(q),
        None, None, bias=None if bias is None else _t(bias), **kw)
    if fold > 1:
        (ref, ref_args), (got, got_args) = ref, got
        assert (got_args.numpy() == np.asarray(ref_args))[
            np.asarray(ref) < 1e37].mean() > 0.95
    ref, got = np.asarray(ref), got.numpy()
    if masked:
        dead = ref >= 1e37
        np.testing.assert_array_equal(got >= 1e37, dead)
        live = ~dead
    else:
        live = np.broadcast_to(
            np.arange(cap)[None, None, :] < lens[li][..., None], ref.shape)
    _close(got, ref, live, 1e-5)


@pytest.mark.parametrize("rows", ["u8", "bf16"])
def test_grouped_sq_scan_precise_tightens(rows):
    """precise=True must tighten the default form's error, asserted
    comparatively on the same inputs against a float64 oracle (as
    tests/test_pallas_gsq.py::test_grouped_sq_precise_mode): precise
    under 1e-4 relative and below the default form's."""
    rng = np.random.default_rng(15)
    nlist, cap, d, b, p = 6, 24, 16, 4, 2
    q = rng.normal(size=(b, d)).astype(np.float32)
    li = rng.integers(0, nlist, size=(b, p)).astype(np.int32)
    if rows == "u8":
        codes, norms, lens, cents, scale, off = _state(rng, nlist, cap, d, d)
        deq = (cents[:, None, :] + off + scale * codes.astype(np.float64))
        args = (_t(codes), _t(norms), _t(lens), _t(li), _t(q), _t(scale),
                _t(off), _t(cents))
    else:
        deq, norms, lens = _raw_state(rng, nlist, cap, d)
        args = (_t(deq).to(torch.bfloat16), _t(norms), _t(lens), _t(li),
                _t(q), None, None)
    ref = ((q[:, None, None, :].astype(np.float64) - deq[li]) ** 2).sum(-1)
    live = np.broadcast_to(
        np.arange(cap)[None, None, :] < lens[li][..., None], ref.shape)
    floor = max(float(np.median(np.abs(ref[live]))), 1.0)

    def err(precise):
        got = ts.grouped_sq_scan(*args, metric="l2", q_pad=8, tile=8,
                                 precise=precise).numpy()
        return float(np.abs(got - ref)[live].max()) / floor

    assert err(True) < 1e-4
    assert err(True) < err(False), (err(True), err(False))


def test_wrappers_reject_unported_operands():
    """What the wrappers still refuse: a row type that is neither u8 nor
    bf16, a query operand of the other product's type, a device without
    a kernel.  (bf16 rows and precise=True are taken: the tests above.)"""
    codes = torch.zeros((2, 16, 16), dtype=torch.bfloat16)
    nrm = torch.zeros((2, 16))
    g = torch.zeros(1, dtype=torch.int32)
    qs = torch.zeros((1, 4, 16), dtype=torch.bfloat16)
    kw = dict(tile=16, alpha=2.0, with_norms=True, masked=False)
    assert ts.gsq(codes, nrm, g, g, qs, **kw).shape == (1, 4, 16)
    assert ts.gsq(codes.to(torch.uint8), nrm, g, g, qs.float(),
                  precise=True, **kw).shape == (1, 4, 16)
    with pytest.raises(TypeError):
        ts.gsq(codes.float(), nrm, g, g, qs, **kw)
    with pytest.raises(TypeError):           # precise wants f32 queries
        ts.gsq(codes, nrm, g, g, qs, precise=True, **kw)
    with pytest.raises(TypeError):           # and the default form bf16
        ts.gsq(codes, nrm, g, g, qs.float(), **kw)
    with pytest.raises(NotImplementedError):
        ts.gsq(codes.to(torch.uint8).to("meta"), nrm.to("meta"),
               g.to("meta"), g.to("meta"), qs.to("meta"), **kw)
