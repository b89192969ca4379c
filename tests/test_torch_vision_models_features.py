"""The port's vision models as feature extractors against the JAX
package's, on the CPU, the same seeded weights in both
(`torch_vision_zoo`): `num_classes=0` with and without `with_pool`
(GoogLeNet, DenseNet-121, SqueezeNet 1.1, AlexNet), an eval forward of
one image at the sizes of `tests/test_models.py:213-216`, pooled to
[1, C, 1, 1] where `with_pool` is on.

Tolerance: float32 on both sides, convolutions summed in other orders by
XLA and by oneDNN: features to 1e-4 of their scale (max(1, max |y|)).
"""
import numpy as np
import pytest

import torch_cpu_threads
from torch_vision_zoo import assert_close_scaled, build_pair, forward_pair

torch_cpu_threads.limit()


@pytest.mark.parametrize("name, size, with_pool", [
    ("googlenet", 64, True), ("googlenet", 64, False),
    ("densenet121", 32, True), ("squeezenet1_1", 64, False),
    ("alexnet", 64, True)])
def test_feature_extractors_match_jax(name, size, with_pool):
    kw = dict(num_classes=0)
    if name != "alexnet":
        kw["with_pool"] = with_pool
    jm, tm = build_pair(name, seed=1, **kw)
    x = np.random.RandomState(2).randn(1, 3, size, size).astype(np.float32)
    (jy,), (ty,) = forward_pair(jm, tm, x, train=False)
    assert_close_scaled(ty, jy, 1e-4, name)
    if with_pool and name != "alexnet":
        assert ty.shape[2:] == (1, 1)
