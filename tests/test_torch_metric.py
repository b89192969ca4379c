"""The port's `metric` against the JAX package's, on the CPU.

The same logits and labels (numpy, from a seed) go through both:
`Accuracy` (compute on the device, update and accumulate on the host;
top-1 and top-k, with labels [n] and [n, 1]), `Precision`, `Recall`,
`Auc` and the functional `accuracy`, and the results must be equal
(they count the same hits).  Ties: the reference's `Accuracy` ranks the
higher class index first among equal logits and its `accuracy` the
lower one; the port keeps both orders, in float32 and in bfloat16,
where small logits tie often.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.metric as jmetric
from paddle_tpu_torch import metric


def _logits(seed, n=64, c=5, ties=False):
    rng = np.random.default_rng(seed)
    if ties:       # few distinct values: many rows hold equal maxima
        return rng.integers(0, 3, (n, c)).astype(np.float32)
    return rng.standard_normal((n, c)).astype(np.float32)


def _labels(seed, n=64, c=5):
    return np.random.default_rng(seed + 1).integers(0, c, n)


def _accuracy(mod, to_t, logits, labels, topk, batches=4):
    m = mod.Accuracy(topk=topk)
    for lo, la in zip(np.array_split(logits, batches),
                      np.array_split(labels, batches)):
        m.update(m.compute(to_t(lo), to_t(la)))
    return m.accumulate(), m.name()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("topk", [1, (1, 3)])
@pytest.mark.parametrize("label_shape", ["n", "n1"])
def test_accuracy_matches_jax(ties, topk, label_shape):
    logits, labels = _logits(0, ties=ties), _labels(0)
    if label_shape == "n1":
        labels = labels[:, None]
    ours = _accuracy(metric, torch.from_numpy, logits, labels, topk)
    ref = _accuracy(jmetric, pt.to_tensor, logits, labels, topk)
    assert ours == ref


def test_accuracy_ties_rank_like_the_reference():
    # every class ties: the reference's Accuracy takes the LAST index,
    # its functional accuracy the FIRST
    logits = np.zeros((4, 3), np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(logits).to(dtype)
        hits = metric.Accuracy().compute(t, torch.tensor([2, 2, 0, 1]))
        assert hits[:, 0].tolist() == [True, True, False, False]
        assert float(metric.accuracy(t, torch.tensor([0, 0, 0, 2]))) == \
            0.75
    ref = jmetric.Accuracy().compute(pt.to_tensor(logits),
                                     pt.to_tensor(np.array([2, 2, 0, 1])))
    assert np.asarray(ref)[:, 0].tolist() == [True, True, False, False]
    assert float(jmetric.accuracy(pt.to_tensor(logits),
                                  pt.to_tensor(np.array([0, 0, 0, 2])))) \
        == 0.75


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_functional_accuracy_matches_jax(ties, k):
    logits, labels = _logits(1, ties=ties), _labels(1)
    ours = metric.accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                           k=k)
    ref = jmetric.accuracy(pt.to_tensor(logits), pt.to_tensor(labels), k=k)
    assert ours.dtype == torch.float32 and ours.shape == ()
    assert float(ours) == float(ref)


def test_bfloat16_logits_rank_ties_like_float32():
    logits = torch.from_numpy(_logits(2)) * 1e-3     # bf16 rounds to ties
    labels = torch.from_numpy(_labels(2))
    lb = logits.to(torch.bfloat16)
    assert int((lb[:, :, None] == lb[:, None, :]).sum()) > lb.numel()
    ours = metric.Accuracy(topk=(1, 2)).compute(lb, labels)
    ref = jmetric.Accuracy(topk=(1, 2)).compute(
        pt.to_tensor(lb.float().numpy()), pt.to_tensor(labels.numpy()))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall_match_jax(cls):
    rng = np.random.default_rng(3)
    ours, ref = getattr(metric, cls)(), getattr(jmetric, cls)()
    for _ in range(3):
        preds = rng.random(50).astype(np.float32)
        labels = rng.integers(0, 2, 50)
        ours.update(torch.from_numpy(preds), torch.from_numpy(labels))
        ref.update(pt.to_tensor(preds), pt.to_tensor(labels))
    assert ours.accumulate() == ref.accumulate() and ours.name() == \
        ref.name()
    ours.reset()
    assert ours.accumulate() == 0.0


@pytest.mark.parametrize("two_columns", [False, True])
def test_auc_matches_jax(two_columns):
    rng = np.random.default_rng(4)
    ours, ref = metric.Auc(num_thresholds=255), jmetric.Auc(
        num_thresholds=255)
    for _ in range(3):
        p = rng.random(80).astype(np.float32)
        labels = (rng.random(80) < p).astype(np.int64)
        preds = np.stack([1 - p, p], 1) if two_columns else p
        ours.update(torch.from_numpy(preds), torch.from_numpy(labels))
        ref.update(pt.to_tensor(preds), pt.to_tensor(labels))
    assert ours.accumulate() == pytest.approx(ref.accumulate(), abs=1e-12)
    assert 0.5 < ours.accumulate() < 1.0
