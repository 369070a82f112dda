"""Training metrics (``paddle_tpu/metric/__init__.py``): ``Metric``
(compute / update / accumulate / reset / name), ``Accuracy``,
``Precision``, ``Recall``, ``Auc``.  They compute on host numpy, as in
the JAX package; a tensor argument (any device, bf16 included) is read
as numpy first."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]


def _to_np(x):
    if torch.is_tensor(x):
        x = x.detach().to("cpu")
        if x.dtype == torch.bfloat16:      # no numpy dtype: exact in fp32
            x = x.float()
        return x.numpy()
    return np.asarray(x)


class Metric:
    def __init__(self, name=None):
        self._name = name or type(self).__name__.lower()

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, pred, label, *args):
        """Optional device-side preprocessing; default passthrough."""
        return pred, label


class Accuracy(Metric):
    def __init__(self, topk=(1,), name="acc"):
        super().__init__(name)
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        pred_np = _to_np(pred)
        label_np = _to_np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        topk_idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        correct = topk_idx == label_np[..., None]
        return correct

    def update(self, correct, *args):
        correct = _to_np(correct)
        num = int(np.prod(correct.shape[:-1]))
        for i, k in enumerate(self.topk):
            self.total[i] += correct[..., :k].any(-1).sum()
            self.count[i] += num
        res = self.total / np.maximum(self.count, 1)
        return res[0] if len(self.topk) == 1 else res

    def accumulate(self):
        res = (self.total / np.maximum(self.count, 1)).tolist()
        return res[0] if len(self.topk) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_to_np(preds) > 0.5).astype(int).ravel()
        labels = _to_np(labels).astype(int).ravel()
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_to_np(preds) > 0.5).astype(int).ravel()
        labels = _to_np(labels).astype(int).ravel()
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(Metric):
    """ROC-AUC via thresholded confusion bins (reference metrics.py Auc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__(name)
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _to_np(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.ravel()
        labels = _to_np(labels).astype(int).ravel()
        bins = np.round(preds * self.num_thresholds).astype(int)
        bins = np.clip(bins, 0, self.num_thresholds)
        np.add.at(self._stat_pos, bins[labels == 1], 1)
        np.add.at(self._stat_neg, bins[labels == 0], 1)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        denom = tot_pos * tot_neg
        return float(auc / denom) if denom else 0.0
