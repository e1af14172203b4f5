"""Parity of the port's ADC tables and per-(query, probe) ADC scans
(gamma_tpu_torch.ops.pq LUTs, ops.adc B4/B5) with the JAX package's:
`pq.l2_lut` / `ip_lut` / `adc_scan`, `pallas_adc.unpack_nibbles`, and
the Pallas kernels `adc_scan_pallas` / `adc_scan_pallas_fs` run in
interpret mode as tests/test_pallas_adc.py runs them on the CPU.  On CPU
tensors the port's wrappers take their plain versions, so these tests
pin the arithmetic the CUDA kernels are held to on the card.

Tolerances: the tables are f32 sums of the same products (1e-5
relative); a scan sums M f32 table entries in another order, so each
element is bound by 1e-5 x sum_m |lut entry| (the B4/B5 bound of
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu.ops import pallas_adc as jadc
from gamma_tpu.ops import pq as jpq
from gamma_tpu_torch.ops import adc as tadc
from gamma_tpu_torch.ops import pq as tpq


def _t(a):
    return torch.from_numpy(np.array(a))


def _codebooks(rng, m, ksub, dsub):
    cb = rng.normal(size=(m, ksub, dsub)).astype(np.float32)
    return (jpq.PQCodebooks(jnp.asarray(cb), jnp.asarray((cb * cb).sum(-1))),
            tpq.codebooks_from(_t(cb)))


def _sum_bound(picked_abs_sum):
    return 1e-5 * picked_abs_sum + 1e-6


@pytest.mark.parametrize("d,m", [(16, 8), (20, 8)])
def test_luts_match_jax(d, m):
    """l2_lut / ip_lut on [B, P, d] residuals and [B, d] queries (d not a
    multiple of M pads with zeros on both sides)."""
    rng = np.random.default_rng(0)
    dsub = -(-d // m)
    jcb, tcb = _codebooks(rng, m, 16, dsub)
    res = rng.normal(size=(3, 4, d)).astype(np.float32)
    q = rng.normal(size=(5, d)).astype(np.float32)
    np.testing.assert_allclose(tpq.l2_lut(tcb, _t(res)).numpy(),
                               np.asarray(jpq.l2_lut(jcb, jnp.asarray(res))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tpq.ip_lut(tcb, _t(q)).numpy(),
                               np.asarray(jpq.ip_lut(jcb, jnp.asarray(q))),
                               rtol=1e-5, atol=1e-5)


def test_adc_scan_and_unpack_match_jax():
    """adc_scan with a per-query table broadcast over probes, and the
    nibble unpack order (low nibble first)."""
    rng = np.random.default_rng(1)
    b, p, c, m, ksub = 3, 4, 10, 6, 16
    lut = rng.normal(size=(b, 1, m, ksub)).astype(np.float32)
    codes = rng.integers(0, ksub, (b, p, c, m)).astype(np.uint8)
    ref = np.asarray(jpq.adc_scan(jnp.asarray(lut), jnp.asarray(codes)))
    got = tpq.adc_scan(_t(lut), _t(codes)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    packed = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        tadc.unpack_nibbles(_t(packed)).numpy(),
        np.asarray(jadc.unpack_nibbles(jnp.asarray(packed))))


@pytest.mark.parametrize("m,ksub,cap", [(20, 16, 40), (8, 64, 600)])
def test_adc_plain_vs_pallas(m, ksub, cap):
    """B4: the plain version against adc_scan_pallas(interpret=True);
    cap 600 is not a multiple of the TPU kernel's 512-slot tile (its
    padded tail is undefined, the port writes no tail)."""
    rng = np.random.default_rng(2)
    nlist, b, p = 16, 3, 5
    codes = rng.integers(0, ksub, (nlist, cap, m)).astype(np.uint8)
    lids = rng.integers(0, nlist, (b, p)).astype(np.int32)
    lut = rng.normal(size=(b, p, m, ksub)).astype(np.float32)
    ref = np.asarray(jadc.adc_scan_pallas(jnp.asarray(codes),
                                          jnp.asarray(lids),
                                          jnp.asarray(lut), interpret=True))
    before = dict(tadc.LAUNCHES)
    got = tadc.adc(_t(codes), _t(lids).long(), _t(lut)).numpy()
    assert tadc.LAUNCHES == before, "the plain version counted a launch"
    assert got.shape == (b, p, cap)
    picked = np.abs(np.take_along_axis(
        lut[:, :, None], codes[lids].astype(np.int64)[..., None],
        axis=-1)[..., 0]).sum(-1)
    assert np.all(np.abs(got - ref) <= _sum_bound(picked))


def test_adc_broadcast_table_and_strided_codes():
    """A per-query table broadcast over probes (stride-0 P axis, as the
    IP branch hands it) and codes trimmed to a cap_eff view."""
    rng = np.random.default_rng(3)
    nlist, cap, m, ksub, b, p = 8, 48, 10, 16, 4, 3
    codes = rng.integers(0, ksub, (nlist, cap, m)).astype(np.uint8)
    lids = rng.integers(0, nlist, (b, p))
    lut = rng.normal(size=(b, m, ksub)).astype(np.float32)
    view = _t(codes)[:, :32]
    got = tadc.adc(view, _t(lids), _t(lut)[:, None].expand(-1, p, -1, -1))
    ref = tpq.adc_scan(_t(lut)[:, None], _t(codes[lids][:, :, :32]))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_adc_fs_plain_vs_pallas():
    """B5: packed 4-bit codes, one table per query, against
    adc_scan_pallas_fs(interpret=True) at a cap past one 512-slot tile."""
    rng = np.random.default_rng(4)
    nlist, cap, m, b, p = 8, 520, 16, 3, 4
    codes4 = rng.integers(0, 16, (nlist, cap, m)).astype(np.uint8)
    packed = (codes4[..., 0::2] | (codes4[..., 1::2] << 4)).astype(np.uint8)
    lids = rng.integers(0, nlist, (b, p)).astype(np.int32)
    lut = rng.normal(size=(b, m, 16)).astype(np.float32)
    ref = np.asarray(jadc.adc_scan_pallas_fs(
        jnp.asarray(packed), jnp.asarray(lids), jnp.asarray(lut),
        interpret=True))
    got = tadc.adc_fs(_t(packed), _t(lids), _t(lut)).numpy()
    picked = np.abs(np.take_along_axis(
        lut[:, None, None], codes4[lids].astype(np.int64)[..., None],
        axis=-1)[..., 0]).sum(-1)
    assert np.all(np.abs(got - ref) <= _sum_bound(picked))
    # a swapped nibble order would not pass: it is a different sum
    swapped = tadc.adc_fs(_t(((packed >> 4) | (packed << 4)) & 0xFF),
                          _t(lids), _t(lut)).numpy()
    assert np.abs(swapped - ref).max() > 1e-2


def test_wrappers_reject_bad_operands():
    codes = torch.zeros((2, 8, 4), dtype=torch.uint8)
    ids = torch.zeros((1, 2), dtype=torch.int64)
    with pytest.raises(ValueError):
        tadc.adc(codes, ids, torch.zeros((1, 2, 3, 16)))      # M mismatch
    with pytest.raises(TypeError):
        tadc.adc(codes.float(), ids, torch.zeros((1, 2, 4, 16)))
    with pytest.raises(ValueError):
        tadc.adc_fs(codes, ids, torch.zeros((1, 4, 16)))      # M != 2W
    with pytest.raises(NotImplementedError):
        tadc.adc_fs(codes.to("meta"), ids.to("meta"),
                    torch.zeros((1, 8, 16), device="meta"))
