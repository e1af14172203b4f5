"""The delete-by-query matcher (tests/test_range_index_matching.py) on
both packages: `MultiFieldsRangeIndex.matching_docids` of the port
(table/range_index.py, ported code, on the CPU by request) and of
`gamma_tpu`, fed the same docs, must each equal a host oracle across
device mirrors, unflushed tail rows and never-mirrored (non-indexed)
fields (reference: DelDocByQuery routes through
MultiFieldsRangeIndex::Search, field_range_index.cc:1015-1115)."""

import numpy as np
import pytest

import gamma_tpu
import gamma_tpu.table.range_index
import gamma_tpu.table.table
import gamma_tpu_torch
import gamma_tpu_torch.table.range_index
import gamma_tpu_torch.table.table


def _mk(pkg, n, flush_at=None):
    dt = pkg.config.DataType
    fields = [pkg.FieldInfo("price", dt.FLOAT, is_index=True),
              pkg.FieldInfo("qty", dt.INT, is_index=False),
              pkg.FieldInfo("tag", dt.STRING, is_index=True)]
    t = pkg.table.table.Table(fields)
    kw = {"device": "cpu"} if pkg is gamma_tpu_torch else {}
    ri = pkg.table.range_index.MultiFieldsRangeIndex(t, **kw)
    ri.add_field("price", dt.FLOAT)
    ri.add_field("tag", dt.STRING)
    for i in range(n):
        tag = "red" if i % 3 == 0 else "blue"
        t.add(f"k{i}", {"price": float(i % 100), "qty": i % 7, "tag": tag})
        ri.add_doc(i, {"tag": tag})
        if flush_at is not None and i + 1 == flush_at:
            ri.flush_device()
    return t, ri


def _oracle(n, price=None, qty=None, tag=None):
    m = np.ones(n, bool)
    for i in range(n):
        if price is not None and not (price[0] <= (i % 100) <= price[1]):
            m[i] = False
        if qty is not None and not (qty[0] <= (i % 7) <= qty[1]):
            m[i] = False
        if tag is not None and (("red" if i % 3 == 0 else "blue") != tag):
            m[i] = False
    return np.flatnonzero(m)


# case → (docs, flush_at, ranges, terms): ranges (field, lo, hi), terms
# (field, value)
CASES = {
    # every row mirrored to the device
    "device_path": (500, 500, [("price", 10.0, 30.0)], [("tag", "red")]),
    # 300 rows mirrored, 200 added after the last flush: the host tail
    "unflushed_tail": (500, 300, [("price", 50.0, 99.0)], []),
    # qty is not an indexed field (no device mirror): host evaluation
    "never_mirrored_field": (400, 400, [("qty", 2.0, 4.0),
                                        ("price", 0.0, 50.0)], []),
    # flush_device never called
    "no_flush_at_all": (200, None, [("price", 0.0, 10.0)],
                        [("tag", "blue")]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matching_docids_both_packages(case):
    n, flush_at, ranges, terms = CASES[case]
    want = _oracle(n, **{f: (lo, hi) for f, lo, hi in ranges},
                   **{f: v for f, v in terms})
    for pkg in (gamma_tpu, gamma_tpu_torch):
        t, ri = _mk(pkg, n, flush_at)
        got = ri.matching_docids(
            [pkg.RangeFilter(f, lo, hi) for f, lo, hi in ranges],
            [pkg.TermFilter(f, v, is_union=1) for f, v in terms], t.n)
        np.testing.assert_array_equal(np.asarray(got), want,
                                      err_msg=pkg.__name__)
