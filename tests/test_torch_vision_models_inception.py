"""The port's Inception and ResNet variants against the JAX package's, on the
CPU, the same seeded weights in both (`torch_vision_zoo`):

the eval and train-mode forwards (batch norm's running statistics after
the latter) of InceptionV3 (96 x 96, the size of
`tests/test_models.py:213-216`) and ResNeXt-50 32x4d (32: the grouped
bottleneck), dropout off for the train-mode runs.

Tolerances: float32 on both sides, convolutions summed in other orders
by XLA and by oneDNN: outputs to 1e-4 of their scale (max(1, max |y|))
in eval mode; train-mode outputs (batch 8) and running statistics by
`torch_vision_zoo.check_train`'s rule (within 4x the port's own float32
error against float64, at least 1e-4 of the scale: batch statistics of
few values are ill-conditioned).
"""
import numpy as np
import pytest

import torch_cpu_threads
from torch_vision_zoo import (assert_close_scaled, build_pair, check_train,
                              forward_pair, no_dropout)

torch_cpu_threads.limit()

FORWARDS = [("inception_v3", 96), ("resnext50_32x4d", 32)]


@pytest.mark.parametrize("name, size", FORWARDS, ids=[f[0] for f in FORWARDS])
def test_branched_forwards_match_jax(name, size):
    jm, tm = build_pair(name, seed=9, num_classes=7)
    x = np.random.RandomState(10).randn(2, 3, size, size).astype(np.float32)
    heads = 3 if name == "googlenet" else 1
    jys, tys = forward_pair(jm, tm, x, train=False)
    assert len(tys) == len(jys) == heads
    for ty, jy in zip(tys, jys):
        assert ty.shape == (2, 7)
        assert_close_scaled(ty, jy, 1e-4, "eval")
    no_dropout(jm, tm)
    check_train(jm, tm, np.random.RandomState(11).randn(
        8, *x.shape[1:]).astype(np.float32))
