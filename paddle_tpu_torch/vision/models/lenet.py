"""LeNet (counterpart: `paddle_tpu/vision/models/lenet.py`)."""
from __future__ import annotations

from ...nn import Layer, MaxPool2D, ReLU, Sequential
from ._builder import Builder


class LeNet(Layer):
    """For [b, 1, 28, 28] images.  `device` / `generator`: see
    `Builder`."""

    def __init__(self, num_classes=10, device=None, generator=None):
        super().__init__()
        b = Builder(device, generator)
        self.features = Sequential(
            b.conv(1, 6, 3, stride=1, padding=1), ReLU(), MaxPool2D(2, 2),
            b.conv(6, 16, 5, stride=1, padding=0), ReLU(), MaxPool2D(2, 2))
        self.fc = Sequential(b.linear(400, 120), b.linear(120, 84),
                             b.linear(84, num_classes))

    def forward(self, x):
        return self.fc(self.features(x).flatten(1))
