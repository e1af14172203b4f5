"""Parity of the port's grouped ADC scan (gamma_tpu_torch.ops.gadc, the
kernel B3) with the JAX package's Pallas scan, run in interpret mode as
tests/test_pallas_gadc.py runs it on the CPU.  On CPU tensors the port's
wrapper takes its plain version, so these tests pin the arithmetic the
CUDA kernel is held to on the card (chip_smoke.py).

Tolerance.  Both sides build the LUT in f32 from bf16 operands and round
it to bf16; a different summation order can flip the rounding of one
entry, so each element is bound by sum_m ulp_bf16(max_k |lut[m, k]|) +
1e-5 x sum_m max_k |lut[m, k]| of its (group, query).  Skipped and
masked slots are bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu.ops import pallas_gadc as jg
from gamma_tpu.ops import pq as jpq
from gamma_tpu_torch.ops import gadc as tg
from gamma_tpu_torch.ops import pq as tpq

BIG = 3.0e38
NLIST, M, Q_PAD = 16, 8, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _codebooks(rng, m, ksub, dsub):
    cb = rng.normal(size=(m, ksub, dsub)).astype(np.float32)
    nrm = (cb * cb).sum(-1)
    return (jpq.PQCodebooks(jnp.asarray(cb), jnp.asarray(nrm)),
            tpq.PQCodebooks(_t(cb), _t(nrm)))


def _lut_bound(rg, cb, cbn, alpha):
    """[G, Q] per-element bound from the LUT rows [.., M, ksub] that the
    bf16 operands rg [G, Q, M*dsub] and cb [M, ksub, dsub] give."""
    m, ksub, dsub = cb.shape
    lut = cbn - alpha * np.einsum(
        "gqmt,mkt->gqmk", _bf16(rg).reshape(*rg.shape[:2], m, dsub),
        _bf16(cb).astype(np.float64))
    top = np.abs(lut).max(-1)                              # [G, Q, M]
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    return ulp.sum(-1) + 1e-5 * top.sum(-1)


def _bias(rng, lens, cap):
    dead = (np.arange(cap)[None, :] >= lens[:, None]) | (
        rng.random((lens.size, cap)) < 0.1)
    return np.where(dead, BIG, 0.0).astype(np.float32)


def _pack(codes4):
    return (codes4[..., 0::2] | (codes4[..., 1::2] << 4)).astype(np.uint8)


def test_flat_codebook_matches_jax():
    rng = np.random.default_rng(0)
    for packed, ksub in [(False, 256), (True, 16)]:
        jcb, tcb = _codebooks(rng, M, ksub, 3)
        jm, jn = jg.flat_codebook(jcb, packed)
        tm, tn = tg.flat_codebook(tcb, packed)
        assert tm.dtype == torch.bfloat16 and tuple(tm.shape) == jm.shape
        np.testing.assert_array_equal(tm.float().numpy(),
                                      np.asarray(jm.astype(jnp.float32)))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def _kernel_case(rng, *, packed, metric, masked, m=M, ksub=None, dsub=2,
                 cap=40, tile=16, q_pad=Q_PAD, nlist=NLIST, b=12, p=4):
    """One operand-level case through _gadc_call(interpret=True) and the
    port's wrapper (its plain version on CPU tensors) → (ref, got, live
    mask, per-element bound, the wrapper's positional operands, its
    keywords)."""
    ksub = ksub or (16 if packed else 256)
    jcb, tcb = _codebooks(rng, m, ksub, dsub)
    codes4 = rng.integers(0, ksub, (nlist, cap, m)).astype(np.uint8)
    codes = _pack(codes4) if packed else codes4
    lens = rng.integers(0, cap + 1, nlist).astype(np.int32)
    li = rng.integers(0, nlist, (b, p)).astype(np.int32)
    li[:, 0] = min(3, nlist - 1)     # one list spills into chunk groups
    g_pad = jg.group_bound(b, p, nlist, q_pad)
    glist, ntiles = jg.build_groups(jnp.asarray(li), jnp.asarray(lens),
                                    q_pad=q_pad, tile=tile, g_pad=g_pad)[:2]
    rg = (rng.normal(size=(g_pad, q_pad, m * dsub))).astype(np.float32)
    alpha = 2.0 if metric == "l2" else 1.0
    cbn = (np.zeros((m, ksub), np.float32) if metric == "ip"
           else np.asarray(jcb.cb_norms))
    bias = _bias(rng, lens, cap) if masked else None
    jm, jn = jg.flat_codebook(jpq.PQCodebooks(jcb.codebooks,
                                              jnp.asarray(cbn)), packed)
    d_pad = -(-m * dsub // 128) * 128
    rg_j = jnp.pad(jnp.asarray(rg), ((0, 0), (0, 0),
                                     (0, d_pad - m * dsub))).astype(jnp.bfloat16)
    jm = jnp.pad(jm, ((0, d_pad - m * dsub), (0, 0)))
    ref = np.asarray(jg._gadc_call(
        jnp.asarray(codes), glist, ntiles, rg_j, jm, jn,
        None if bias is None else jnp.asarray(bias).reshape(nlist, 1, cap),
        q_pad=q_pad, tile=tile, ksub=ksub, alpha=alpha, packed=packed,
        interpret=True))
    ops = [_t(codes), _t(glist), _t(ntiles), _t(rg).to(torch.bfloat16),
           tcb.codebooks.to(torch.bfloat16), _t(cbn),
           None if bias is None else _t(bias)]
    kw = dict(tile=tile, alpha=alpha, packed=packed)
    before = dict(tg.LAUNCHES)
    got = tg.gadc(*ops, **kw).numpy()
    assert tg.LAUNCHES == before, "the plain version counted a launch"
    live = (np.arange(cap)[None, :]
            < np.asarray(ntiles)[:, None] * tile)[:, None, :]
    live = np.broadcast_to(live, ref.shape) & (ref < 1e37)
    bound = np.broadcast_to(_lut_bound(
        rg, np.asarray(jcb.codebooks), cbn, alpha)[..., None], ref.shape)
    return ref, got, live, bound, ops, kw


@pytest.mark.parametrize("packed,metric,masked", [
    (False, "l2", False), (False, "l2", True), (False, "ip", False),
    (False, "ip", True), (True, "l2", True), (True, "l2", False)])
def test_gadc_kernel_plain_vs_pallas(packed, metric, masked):
    """B3 operand-level parity against _gadc_call(interpret=True): live
    slots within the LUT-rounding bound, skipped tiles and masked slots
    bit-identical.  cap 40 is not a multiple of the 16-slot tile."""
    rng = np.random.default_rng(1)
    ref, got, live, bound, ops, kw = _kernel_case(
        rng, packed=packed, metric=metric, masked=masked)
    err = np.abs(got - ref)
    assert np.all(err[live] <= bound[live]), err[live].max()
    np.testing.assert_array_equal(got[~live], ref[~live])
    if packed:
        # the nibble pairing matters: swapped nibbles leave the bound
        codes = ops[0].numpy()
        ops[0] = _t(((codes >> 4) | (codes << 4)) & 0xFF)
        swapped = tg.gadc(*ops, **kw).numpy()
        assert np.any(np.abs(swapped - ref)[live] > 10 * bound[live])


@pytest.mark.parametrize("case", [
    # ksub 16 unpacked: M 32 x 4 bit has M*ksub = 512, so it reaches B3
    dict(packed=False, m=32, ksub=16, dsub=4, cap=48, tile=16),
    dict(packed=False, m=16, ksub=256, dsub=8, cap=48, tile=16),
    dict(packed=False, q_pad=128, b=40, p=4, nlist=3, cap=32, tile=16),
    dict(packed=True, q_pad=16, m=32, ksub=16, dsub=4, cap=48, tile=16),
    # cap 1000 with 256-slot tiles: the last tile is ragged
    dict(packed=False, cap=1000, tile=256, nlist=4, b=3, p=2),
], ids=["ksub16-unpacked", "dsub8", "q128", "packed-dsub4-q16", "cap1000"])
def test_gadc_edge_shapes_plain_vs_pallas(case):
    """The edge shapes the card's smoke run holds the CUDA kernel to, here
    for its plain version against _gadc_call(interpret=True): same bound
    (a bf16 LUT entry may round the other way under another summation
    order), skipped and masked slots bit-identical."""
    rng = np.random.default_rng(7)
    ref, got, live, bound, _, _ = _kernel_case(
        rng, metric="l2", masked=True, **case)
    err = np.abs(got - ref)
    assert live.any()
    assert np.all(err[live] <= bound[live]), err[live].max()
    np.testing.assert_array_equal(got[~live], ref[~live])


@pytest.mark.parametrize("shape,mc,stages", [
    ((1280, 32, 256, 4, False), 16, 2),    # the engine's 8-bit geometry
    ((1280, 64, 16, 2, True), 32, 2),      # FastScan, packed
    ((1280, 32, 16, 4, False), 16, 2),     # ksub 16 unpacked
    ((1280, 16, 256, 8, False), 16, 1),
    ((1000, 32, 256, 4, False), 16, 2),
    ((1280, 24, 256, 4, False), 16, 2),    # 16 + 8
    ((640, 48, 256, 2, False), 16, 3),
    ((3000, 64, 256, 2, False), 16, 4),    # cap past one block's span
    ((40, 8, 256, 2, False), 8, 1),
])
def test_gadc_geometry(shape, mc, stages):
    """The CUDA kernel's launch geometry: stage size and count, a span
    that covers cap in equal blocks of at most 1280 slots, a build unit
    that fits its buffer, shared memory inside the card's limit."""
    cap, m, ksub, dsub, packed = shape
    geo = tg.gadc_geometry(*shape)
    assert (geo["mc"], geo["stages"]) == (mc, stages)
    assert geo["mc"] * geo["stages"] >= m > geo["mc"] * (stages - 1)
    code_bytes = geo["mc"] // 2 if packed else geo["mc"]
    assert code_bytes <= tg.GADC_STAGE_CODE_BYTES
    assert not packed or geo["mc"] % 2 == 0
    assert geo["mc"] * ksub * tg.GADC_ENTRY_BYTES <= tg.GADC_LUT_BYTES
    assert 1 <= geo["span"] <= tg.GADC_SPAN
    assert geo["span"] * -(-cap // geo["span"]) < cap + -(-cap // geo["span"])
    assert 1 <= geo["tu"] <= geo["mc"] * -(-ksub // 16)
    unit = geo["tu"] * 16 * (2 * dsub + 4)
    assert unit <= max(tg.GADC_UNIT_BYTES, 16 * (2 * dsub + 4))
    assert geo["smem"] == (geo["mc"] * ksub * 16 + 2 * unit
                           + 8 * m * dsub * 2)
    # two blocks share an SM's 228 KB (1 KB of each is the system's)
    assert geo["smem"] <= tg.SMEM_LIMIT
    assert 2 * (geo["smem"] + 1024) <= 228 * 1024


def test_gadc_geometry_over_limit():
    """Residual rows too wide for shared memory: the geometry says so
    (the wrapper raises on it before a launch)."""
    geo = tg.gadc_geometry(1280, 64, 256, 256, False)
    assert geo["smem"] > tg.SMEM_LIMIT


def _grouped_case(rng, packed, metric, residual, masked, cap=40, tile=16):
    ksub, dsub, d = (16, 2, 32) if packed else (256, 2, 16)
    m = 2 * M if packed else M
    jcb, tcb = _codebooks(rng, m, ksub, dsub)
    cents = (rng.normal(size=(NLIST, d)) * 2.0).astype(np.float32)
    codes4 = rng.integers(0, ksub, (NLIST, cap, m)).astype(np.uint8)
    codes = _pack(codes4) if packed else codes4
    lens = rng.integers(1, cap + 1, NLIST).astype(np.int32)
    b, p = 12, 3
    q = rng.normal(size=(b, d)).astype(np.float32)
    li = np.stack([rng.choice(NLIST, p, replace=False)
                   for _ in range(b)]).astype(np.int32)
    li[:, 0] = 5                     # 12 pairs on one list > q_pad 8
    bias = _bias(rng, lens, cap) if masked else None
    kw = dict(metric=metric, packed=packed, residual=residual, q_pad=Q_PAD,
              tile=tile)
    ref = np.asarray(jg.grouped_adc(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(li),
        jnp.asarray(q), jnp.asarray(cents), jcb,
        bias=None if bias is None else jnp.asarray(bias), interpret=True,
        **kw))
    got = tg.grouped_adc(_t(codes), _t(lens), _t(li), _t(q), _t(cents), tcb,
                         bias=None if bias is None else _t(bias),
                         **kw).numpy()
    # per-(query, probe) LUT bound from the same rg rows
    rows = q[:, None, :] - cents[li] if (residual and metric == "l2") \
        else np.broadcast_to(q[:, None, :], (b, p, d))
    alpha = 1.0 if metric == "ip" else 2.0
    cbn = 0.0 if metric == "ip" else np.asarray(jcb.cb_norms)
    bound = _lut_bound(rows, np.asarray(jcb.codebooks), cbn, alpha)
    return ref, got, bound[..., None], lens[li]


@pytest.mark.parametrize("packed,metric,residual,masked", [
    (False, "l2", True, True), (False, "l2", True, False),
    (False, "ip", True, True), (True, "l2", True, True),
    (True, "l2", False, True), (True, "ip", False, False)])
def test_grouped_adc_vs_pallas(packed, metric, residual, masked):
    """Whole grouped scan (grouping, rg rows, bf16 operands, kernel,
    ungroup) against JAX grouped_adc(interpret=True), with one list
    probed by more pairs than q_pad and cap 40 past two 16-slot tiles."""
    rng = np.random.default_rng(2)
    ref, got, bound, lens_g = _grouped_case(rng, packed, metric, residual,
                                            masked)
    if masked:
        dead = ref >= 1e37
        np.testing.assert_array_equal(got >= 1e37, dead)
        live = ~dead
    else:
        live = np.arange(ref.shape[-1])[None, None, :] < lens_g[..., None]
    err = np.abs(got - ref)
    assert np.all((err <= bound)[live]), err[live].max()


def test_gadc_rejects_bad_operands():
    codes = torch.zeros((2, 16, 4), dtype=torch.uint8)
    g = torch.zeros(1, dtype=torch.int32)
    rg = torch.zeros((1, 8, 16), dtype=torch.bfloat16)
    cb = torch.zeros((8, 16, 2), dtype=torch.bfloat16)
    cbn = torch.zeros((8, 16))
    with pytest.raises(ValueError):          # W 4 holds neither M nor M/2
        tg.gadc(codes, g, g, rg, cb, cbn, tile=16, alpha=2.0, packed=False)
    with pytest.raises(TypeError):
        tg.gadc(codes, g, g, rg.float(), cb, cbn, tile=16, alpha=2.0,
                packed=True)
    with pytest.raises(NotImplementedError):
        tg.gadc(*(t.to("meta") for t in (codes, g, g, rg, cb, cbn)),
                tile=16, alpha=2.0, packed=True)
