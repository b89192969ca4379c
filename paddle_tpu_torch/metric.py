"""Evaluation metrics (counterpart: `paddle_tpu/metric.py`): `Metric`,
`Accuracy`, `Precision`, `Recall`, `Auc` and `accuracy`.

The same split as the reference: `compute()` runs on the device, on the
model's output, in the evaluation step (`Accuracy`'s top-k hits), and
`update()` / `accumulate()` run on the host over the small result.

Ties: the reference's `Accuracy.compute` takes top-k by a stable
ascending argsort reversed (`paddle_tpu/metric.py:65`), so among equal
logits the HIGHER class index ranks first; its functional `accuracy`
sorts the negated logits stably, so there the LOWER index ranks first.
`torch.topk` leaves the order of ties unspecified, and bfloat16 logits do
tie, so both keep the reference's order with a stable `torch.sort`.
"""
from __future__ import annotations

import abc

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]


def _arr(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric(abc.ABC):
    """Base metric: compute (device) -> update (host) -> accumulate."""

    def compute(self, pred, label, *args):
        """Device-side preprocessing; default passthrough."""
        return pred, label

    @abc.abstractmethod
    def update(self, *args):
        ...

    @abc.abstractmethod
    def accumulate(self):
        ...

    @abc.abstractmethod
    def reset(self):
        ...

    @abc.abstractmethod
    def name(self):
        ...


class Accuracy(Metric):
    """Top-k accuracy (reference: paddle.metric.Accuracy)."""

    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred, label = _arr(pred), _arr(label).to(pred.device)
        if label.ndim == pred.ndim and label.shape[-1] == 1:
            label = label[..., 0]
        k = max(self.topk)
        # stable ascending, reversed: ties rank the higher index first
        order = torch.sort(pred, dim=-1, stable=True).indices.flip(-1)
        return order[..., :k] == label[..., None]

    def update(self, correct):
        correct = _host(correct)
        n = int(np.prod(correct.shape[:-1]))
        for i, k in enumerate(self.topk):
            self._correct[i] += float(correct[..., :k].any(-1).sum())
        self._count += n
        hit = correct[..., :self.topk[0]].any(-1)
        return float(hit.mean())

    def accumulate(self):
        vals = [c / max(self._count, 1) for c in self._correct]
        return vals[0] if len(vals) == 1 else vals

    def reset(self):
        self._correct = [0.0] * len(self.topk)
        self._count = 0

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision: tp / (tp + fp) over thresholded predictions."""

    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _host(preds).reshape(-1)
        labels = _host(labels).reshape(-1)
        hard = (preds > 0.5).astype(np.int64)
        self.tp += int(((hard == 1) & (labels == 1)).sum())
        self.fp += int(((hard == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def reset(self):
        self.tp = 0
        self.fp = 0

    def name(self):
        return [self._name]


class Recall(Metric):
    """Binary recall: tp / (tp + fn)."""

    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _host(preds).reshape(-1)
        labels = _host(labels).reshape(-1)
        hard = (preds > 0.5).astype(np.int64)
        self.tp += int(((hard == 1) & (labels == 1)).sum())
        self.fn += int(((hard == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def reset(self):
        self.tp = 0
        self.fn = 0

    def name(self):
        return [self._name]


class Auc(Metric):
    """ROC-AUC by the reference's histogram of `num_thresholds` buckets of
    positive and negative counts."""

    def __init__(self, num_thresholds=4095, name="auc"):
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _host(preds)
        labels = _host(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        idx = np.clip((preds * self.num_thresholds).astype(np.int64),
                      0, self.num_thresholds - 1)
        np.add.at(self._pos, idx, labels == 1)
        np.add.at(self._neg, idx, labels == 0)

    def accumulate(self):
        # sweep the thresholds high to low summing tp and fp; trapezoids
        tp = np.cumsum(self._pos[::-1])
        fp = np.cumsum(self._neg[::-1])
        tot_p, tot_n = tp[-1], fp[-1]
        if tot_p == 0 or tot_n == 0:
            return 0.0
        tpr = np.concatenate([[0.0], tp / tot_p])
        fpr = np.concatenate([[0.0], fp / tot_n])
        trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy 1
        return float(trapezoid(tpr, fpr))

    def reset(self):
        self._pos = np.zeros(self.num_thresholds, np.int64)
        self._neg = np.zeros(self.num_thresholds, np.int64)

    def name(self):
        return [self._name]


def accuracy(input, label, k=1):
    """Functional top-k accuracy (reference: paddle.metric.accuracy): a
    0-d float32 tensor on the input's device.  Ties rank the lower index
    first, as the reference's stable sort of the negated logits does."""
    pred = _arr(input)
    lab = _arr(label).to(pred.device).reshape(-1)
    topk = torch.sort(-pred, dim=-1, stable=True).indices[:, :k]
    return (topk == lab[:, None]).any(dim=1).float().mean()
