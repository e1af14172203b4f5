"""X1, the row gather (ops/gather_rows.py), against the TPU kernel it
replaces, experiments/exp_rerank.py gather_rows_pallas, run in interpret
mode: the plain version equals it bit for bit on fp8 (e4m3), bf16 and
f32 tables, with duplicate indices and k a multiple of the kernel's rows per step.
Beyond the TPU kernel's contract, an index outside [0, n) gives a row
of zeros.  The CUDA kernel is held against the plain version on the
card by chip_smoke.py."""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu_torch.ops import gather_rows as tgr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def exp_rerank(monkeypatch):
    """experiments/exp_rerank.py with its pallas_call interpreted.  The
    module sets a JAX compilation cache directory when imported: both
    the environment variable and the config value are put back."""
    env_before = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    cfg_before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "exp_rerank", os.path.join(REPO, "experiments", "exp_rerank.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
        monkeypatch.setattr(mod.pl, "pallas_call", functools.partial(
            mod.pl.pallas_call, interpret=True))
        yield mod
    finally:
        jax.config.update("jax_compilation_cache_dir", cfg_before)
        if env_before is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = env_before


def _table(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "bfloat16", "float32"])
@pytest.mark.parametrize("rps", [8, 16])
def test_plain_equals_tpu_kernel_bit_for_bit(exp_rerank, dtype, rps):
    n, d, k = 1000, 128, 64
    x = _table(0, n, d)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, n, size=k).astype(np.int32)
    idx[5:9] = idx[0]                       # duplicate indices
    idx[-1] = n - 1
    jt = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref = np.asarray(exp_rerank.gather_rows_pallas(jt, jnp.asarray(idx),
                                                   rps=rps))
    tt = torch.from_numpy(np.array(jt.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = tgr._gather_rows_plain(tt, torch.from_numpy(idx))
    assert got.dtype == tt.dtype and got.shape == (k, d)
    width = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.int16),
             4: (torch.int32, np.int32)}[tt.element_size()]
    got_bits = got.view(width[0])
    ref_bits = ref.view(width[1])
    np.testing.assert_array_equal(got_bits.numpy(), ref_bits)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_out_of_range_indices_give_zero_rows(idx_dtype):
    n, d = 50, 24
    table = torch.from_numpy(_table(2, n, d)).to(torch.bfloat16)
    idx = torch.tensor([3, -1, n, n + 7, 0, n - 1, -5, 3], dtype=idx_dtype)
    out = tgr.gather_rows(table, idx)
    ok = (idx >= 0) & (idx < n)
    assert out.dtype == torch.bfloat16 and out.shape == (8, d)
    assert torch.equal(out[ok], table[idx[ok].long()])
    assert torch.equal(out[~ok], torch.zeros((int((~ok).sum()), d),
                                             dtype=torch.bfloat16))


def test_wrapper_uses_plain_only_on_cpu_and_counts_no_launch():
    table = torch.from_numpy(_table(3, 40, 8))
    idx = torch.tensor([1, 2, 39], dtype=torch.int64)
    before = tgr.LAUNCHES["gather_rows"]
    out = tgr.gather_rows(table, idx)
    assert torch.equal(out, table[idx])
    assert tgr.LAUNCHES["gather_rows"] == before
    # a device that is neither the CPU nor a CUDA card has no kernel
    with pytest.raises(NotImplementedError, match="meta"):
        tgr.gather_rows(table.to("meta"), idx.to("meta"))


@pytest.mark.parametrize("table,idx,err", [
    (torch.zeros(4, 3, 2), torch.tensor([0]), TypeError),
    (torch.zeros(4, 3), torch.tensor([[0]]), TypeError),
    (torch.zeros(4, 3), torch.tensor([0.0]), TypeError),
    (torch.zeros(4, 3), torch.tensor([0], dtype=torch.int16), TypeError),
])
def test_wrapper_rejects_bad_operands(table, idx, err):
    with pytest.raises(err):
        tgr.gather_rows(table, idx)


def test_empty_table_and_empty_index():
    table = torch.zeros((0, 6), dtype=torch.float32)
    out = tgr.gather_rows(table, torch.tensor([0, -1]))
    assert out.shape == (2, 6) and not out.any()
    out = tgr.gather_rows(torch.ones(5, 6), torch.zeros(0, dtype=torch.int64))
    assert out.shape == (0, 6)
