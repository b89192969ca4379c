"""Loss layers (counterpart: `paddle_tpu/nn/loss.py`), over the losses in
`functional`.  Where the JAX layer computes apart from its functional
(`MarginRankingLoss`, `CosineEmbeddingLoss`: the cosine along the last
axis and a label compared with 1), the port does the same."""
from __future__ import annotations

import torch

from . import functional as PF
from .layer import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, label_smoothing=0.0):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return PF.cross_entropy(
            input, label, weight=self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, label_smoothing=self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return PF.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return PF.l1_loss(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return PF.smooth_l1_loss(input, label, self.reduction, self.delta)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean"):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return PF.nll_loss(input, label, self.weight, self.ignore_index,
                           self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean"):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return PF.binary_cross_entropy(input, label, self.weight,
                                       self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return PF.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return PF.kl_div(input, label, self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return PF.margin_ranking_loss(input, other, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        sim = PF.cosine_similarity(input1, input2, axis=-1)
        loss = torch.where(label == 1, 1.0 - sim,
                           (sim - self.margin).clamp(min=0.0))
        return PF._reduce_loss(loss, self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return PF.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                           blank=self.blank, reduction=self.reduction,
                           norm_by_times=norm_by_times)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean"):
        super().__init__()
        self.margin, self.p, self.epsilon = margin, p, epsilon
        self.swap, self.reduction = swap, reduction

    def forward(self, input, positive, negative):
        return PF.triplet_margin_loss(input, positive, negative,
                                      self.margin, self.p, self.epsilon,
                                      self.swap, self.reduction)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return PF.soft_margin_loss(input, label, self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean"):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return PF.hinge_embedding_loss(input, label, self.margin,
                                       self.reduction)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean"):
        super().__init__()
        self.log_input, self.full = log_input, full
        self.epsilon, self.reduction = epsilon, reduction

    def forward(self, input, label):
        return PF.poisson_nll_loss(input, label, self.log_input, self.full,
                                   self.epsilon, self.reduction)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean"):
        super().__init__()
        self.full, self.epsilon, self.reduction = full, epsilon, reduction

    def forward(self, input, label, variance):
        return PF.gaussian_nll_loss(input, label, variance, self.full,
                                    self.epsilon, self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean"):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return PF.multi_label_soft_margin_loss(input, label, self.weight,
                                               self.reduction)
