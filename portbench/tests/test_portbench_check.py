"""The comparison's arithmetic, the result line, the arrivals, and the
loader order the reference follows."""

import json

import numpy as np
import pytest

from portbench import check, harness
from portbench.drivers.open_loop_serve import arrivals
from portbench.drivers.train_loop import loader_order


def test_leaf_gap_is_over_the_larger_of_the_leaf_and_the_median():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-6}
    prog = {"a": 1.1, "b": 2.0, "c": 2e-6}
    gaps = check.leaf_gaps(prog, ref, sorted(ref))
    assert gaps["a"] == pytest.approx(0.1)
    assert gaps["c"] == pytest.approx(1e-6 / 1.0)  # the median leaf's norm, 1.0


def test_still_leaves_are_left_out_of_the_update_only():
    ref = {"losses": [1.0, 1.0, 1.0], "grad": {"a": 1.0, "b": 2.0, "c": 1e-4},
           "change": {"a": 1.0, "b": 1.0, "c": 1.0}}
    prog = {"losses": [1.0, 2.0, 3.0], "grad": dict(ref["grad"]),
            "change": {"a": 1.0, "b": 1.0, "c": 5.0}}
    assert check.still_leaves(ref) == ["c"]
    numbers = dict(check.train_numbers(prog, ref))
    assert numbers == {"loss_gap": 0.0, "grad_gap": 0.0, "update_gap": 0.0}
    assert check.loss_gaps(prog, ref) == [0.0, 1.0, 2.0]


def test_an_unchanged_state_reads_one():
    ref = {"losses": [1.0], "grad": {"a": 1.0, "b": 2.0}, "change": {"a": 0.3, "b": 0.2}}
    prog = {"losses": [1.0], "grad": {"a": 0.0, "b": 0.0}, "change": {"a": 0.0, "b": 0.0}}
    numbers = dict(check.train_numbers(prog, ref))
    assert numbers["grad_gap"] == pytest.approx(1.0) and numbers["update_gap"] == pytest.approx(1.0)


def test_serve_numbers():
    emb = {"x": np.array([[3.0, 4.0], [1.0, 0.0]])}
    present = {"m": np.array([True, False])}
    answers = [{"embeddings": {"x": np.array([3.0, 4.5])}, "present": {"m": True}},
               {"embeddings": {"x": np.array([1.0, 0.0])}, "present": {"m": True}}]
    assert dict(check.serve_numbers(answers, emb, present)) == {
        "emb_gap": pytest.approx(0.1), "mask_errors": 1.0}


def test_verdict_and_line():
    assert harness.check_verdict([("a", 0.1, 0.2)])
    assert not harness.check_verdict([("a", 0.3, 0.2)])
    assert not harness.check_verdict([("a", 0.1, None)])
    assert not harness.check_verdict([("a", float("nan"), 1.0)])
    assert not harness.check_verdict([])
    line = json.loads(harness.result_line(True, 3, 0, {"m": (1.5, "s")}, {"platform": "gpu"},
                                          [("a", 0.1, 0.2)], {"device_ops": []}))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert line["checks"] == {"a": {"value": 0.1, "limit": 0.2}}


def test_arrivals_are_the_same_gaps_for_every_seed():
    a = arrivals(840.0, 20.0, 2**31 + 11, 0)
    b = arrivals(840.0, 20.0, 7, 0)
    assert len(a) == len(b) == 16800
    assert a[-1] == pytest.approx(20.0) and np.all(np.diff(a) > 0)
    ga, gb = np.diff(np.r_[0.0, a]), np.diff(np.r_[0.0, b])
    assert np.allclose(np.sort(ga), np.sort(gb))
    assert not np.allclose(ga, gb)
    assert np.mean(ga) == pytest.approx(1 / 840.0)


@pytest.mark.parametrize("seed", [2**31 + 11, 7, 3200000005])
def test_arrivals_are_as_bursty_as_poisson(seed):
    """Counts in stretches of 100 mean gaps vary as a Poisson process's
    do (variance about the mean), not smoothed within strata."""
    due = arrivals(840.0, 20.0, seed, 0)
    counts = np.histogram(due, bins=168, range=(0.0, 20.0))[0]
    assert counts.mean() == pytest.approx(100.0, rel=1e-3)
    assert 0.6 < counts.var() / counts.mean() < 1.5


def test_the_loader_order_is_the_loaders():
    from mca_tpu_torch.data.dataset import BatchedLoader

    rows = [{"i": i} for i in range(40)]
    loader = BatchedLoader(rows, lambda b: [r["i"] for r in b], 8, shuffle=True, seed=43)
    got = [i for batch in loader for i in batch]
    assert got == list(loader_order(40, 43))
