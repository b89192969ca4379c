"""The port's mobile vision models against the JAX package's, on the
CPU, the same seeded weights in both (`torch_vision_zoo`):

the eval and train-mode forwards (batch norm's running statistics after
the latter) of MobileNetV1, MobileNetV2, MobileNetV3 Small and Large at
32 x 32 (the sizes of `tests/test_models.py:213-216`), dropout off for
the train-mode runs (ShuffleNetV2 and a training step:
`test_torch_vision_models_shufflenet.py`).

Tolerances: float32 on both sides, convolutions summed in other orders
by XLA and by oneDNN: logits to 1e-4 of their scale (max(1, max |y|))
in eval mode; train-mode outputs and running statistics by `torch_vision_zoo.check_train`'s rule (within
4x the port's own float32 error against float64, at least 1e-4 of the
scale: batch statistics of eight images at 1 x 1 maps are
ill-conditioned).
"""
import numpy as np
import pytest

import torch_cpu_threads
from torch_vision_zoo import (assert_close_scaled, build_pair, check_train,
                              forward_pair, no_dropout)
torch_cpu_threads.limit()

FORWARDS = [("mobilenet_v1", {}), ("mobilenet_v2", {}),
            ("mobilenet_v3_small", {}), ("mobilenet_v3_large", {})]


@pytest.mark.parametrize("name, kw", FORWARDS, ids=[f[0] for f in FORWARDS])
def test_mobile_forwards_match_jax(name, kw):
    jm, tm = build_pair(name, seed=5, num_classes=7, **kw)
    x = np.random.RandomState(6).randn(2, 3, 32, 32).astype(np.float32)
    (jy,), (ty,) = forward_pair(jm, tm, x, train=False)
    assert ty.shape == (2, 7)
    assert_close_scaled(ty, jy, 1e-4, "eval")
    no_dropout(jm, tm)
    check_train(jm, tm, np.random.RandomState(11).randn(
        8, *x.shape[1:]).astype(np.float32))
