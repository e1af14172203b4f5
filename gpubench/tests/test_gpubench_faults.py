"""`correct` comes out false when the timed path is broken underneath,
and for the control (the program one precision lower), on tiny cells on
the CPU: the run is driven whole, past the look for a chip."""

import time

import pytest
import torch

from gpubench import harness, spec

CELLS = ["tiny-pq-bulk", "tiny-dense-bulk"]


def _run(root, workload, seed=2**31 + 99, control=False):
    cell = spec.load_cell(workload, root, root + "/gpubench")
    return harness.run_cell(cell, seed, 1.0, False, "cpu",
                            time.perf_counter(), control=control)


FAULTS = {"answer_altered": "score_gap", "half_batch_left_out":
          "bad_answers", "scores_infinite": "bad_answers"}


def _break(monkeypatch, fault):
    from gamma_tpu_torch import GammaEngine
    from gamma_tpu_torch.index.ivfpq import IVFPQIndex
    if fault == "scores_infinite":
        # every hit the engine packs carries a score of +inf, keys kept
        orig_search = GammaEngine.search

        def packed_inf(self, request):
            resp = orig_search(self, request)
            for sr in resp.results:
                for it in sr.result_items:
                    it.score = float("inf")
            return resp

        monkeypatch.setattr(GammaEngine, "search", packed_inf)
        return
    orig = IVFPQIndex.search

    def broken(self, queries, *a, **kw):
        d, docids, vids = orig(self, queries, *a, **kw)
        d, docids = d.clone(), docids.clone()
        if fault == "answer_altered":
            # every 7th query's nearest hit names the next doc instead
            docids[::7, 0] = (docids[::7, 0] + 1) % self.store.n
        else:                        # half_batch_left_out
            half = queries.shape[0] // 2
            d[half:] = float("inf")
            docids[half:] = -1
        return d, docids, vids

    monkeypatch.setattr(IVFPQIndex, "search", broken)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny_root, workload):
    assert _run(tiny_root, workload)["correct"] is True


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_path_is_not_correct(tiny_root, monkeypatch, workload,
                                    fault):
    _break(monkeypatch, fault)
    out = _run(tiny_root, workload)
    assert out["correct"] is False
    v = out["compared"][FAULTS[fault]]
    assert v["value"] > v["limit"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [7, 8, 9])
def test_control_is_not_correct(tiny_root, workload, seed):
    out = _run(tiny_root, workload, seed=seed, control=True)
    assert out["correct"] is False
    v = out["compared"]["score_gap"]
    assert v["value"] > v["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["vgg1m-dense-bulk", "sift1m-pq-bulk"])
def test_control_fails_at_cell_size(cuda_device, workload):
    """The control at the cell's own size on the card, three seeds."""
    cell = spec.load_cell(workload)
    for seed in (2**31 + 7, 2**31 + 8, 2**31 + 9):
        out = harness.run_cell(cell, seed, 3.0, False, cuda_device,
                               time.perf_counter(), control=True)
        assert out["correct"] is False
        torch.cuda.empty_cache()
