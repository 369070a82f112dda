"""``metric`` of the port against the JAX package's on the CPU: the same
seeded predictions through ``compute`` / ``update`` / ``accumulate`` /
``reset`` of both, batch by batch; the results equal exactly (both
count on host numpy).  The port also takes tensors (bf16 included)."""

import numpy as np
import pytest
import torch

import paddle_tpu.metric as jm

import paddle_tpu_torch.metric as tm


def _batches(kind, seed=0, n=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if kind == "classes":
            out.append((rng.standard_normal((16, 7)).astype(np.float32),
                        rng.integers(0, 7, (16, 1))))
        else:
            out.append((rng.random((20, 1)).astype(np.float32),
                        rng.integers(0, 2, (20, 1))))
    return out


def _drive(m, batches, use_compute):
    seen = []
    for pred, label in batches:
        if use_compute:
            outs = m.compute(pred, label)
            r = m.update(*(outs if isinstance(outs, tuple) else (outs,)))
        else:
            r = m.update(pred, label)
        seen.append((np.asarray(r).tolist() if r is not None else None,
                     m.accumulate()))
    name = m.name()
    m.reset()
    return seen, name, m.accumulate()


CASES = [
    ("accuracy-top1", lambda m: m.Accuracy(), "classes", True),
    ("accuracy-top1_5", lambda m: m.Accuracy(topk=(1, 5)), "classes", True),
    ("accuracy-top2_3-named", lambda m: m.Accuracy(topk=(2, 3),
                                                    name="hit"),
     "classes", True),
    ("accuracy-int_topk", lambda m: m.Accuracy(topk=4), "classes", True),
    ("precision", lambda m: m.Precision(), "binary", False),
    ("recall", lambda m: m.Recall(), "binary", False),
    ("auc", lambda m: m.Auc(), "binary", False),
    ("auc-coarse", lambda m: m.Auc(num_thresholds=15), "binary", False),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_metric_matches_jax(case):
    _, make, kind, compute = case
    batches = _batches(kind)
    assert _drive(make(tm), batches, compute) == \
        _drive(make(jm), batches, compute)


def test_auc_two_column_predictions():
    rng = np.random.default_rng(1)
    p = rng.random((30, 1)).astype(np.float32)
    two = np.concatenate([1 - p, p], axis=1)
    y = rng.integers(0, 2, (30, 1))
    got = [m.Auc() for m in (tm, jm)]
    for m in got:
        m.update(two, y)
    assert got[0].accumulate() == got[1].accumulate()


def test_empty_metrics_read_zero():
    assert tm.Precision().accumulate() == jm.Precision().accumulate() == 0.0
    assert tm.Recall().accumulate() == 0.0 and tm.Auc().accumulate() == 0.0


def test_tensor_inputs():
    """Tensors (bf16 widened exactly) give the numpy inputs' counts."""
    pred, label = _batches("classes", seed=2, n=1)[0]
    pred = pred.astype(np.float32)
    bf = torch.from_numpy(pred).to(torch.bfloat16)
    a, b = tm.Accuracy(topk=(1, 3)), tm.Accuracy(topk=(1, 3))
    a.update(a.compute(bf, torch.from_numpy(label)))
    b.update(b.compute(bf.float().numpy(), label))
    assert a.accumulate() == b.accumulate()


def test_names_are_jaxs():
    assert set(tm.__all__) == set(jm.__all__)
