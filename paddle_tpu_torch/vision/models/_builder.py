"""How the zoo's models make their layers (the JAX package's models take
no device and draw from the global key; the port's take `device=` and
`generator=` as `ResNet` does)."""
from __future__ import annotations

from ...device import generator as make_generator
from ...device import resolve_device
from ...nn.common import Linear
from ...nn.conv import Conv2D
from ...nn.norm import BatchNorm2D


class Builder:
    """Makes convolutions, batch norms and linears on `device` (the CUDA
    device unless told otherwise; raises when there is none) in
    float32, drawing every weight from `generator` (a torch.Generator on
    `device`; by default one seeded with 0) in the order the layers are
    made: conv weights Kaiming-uniform, linear weights Xavier-uniform,
    biases zero, batch norms unit scale and zero shift (the JAX
    package's defaults)."""

    def __init__(self, device=None, generator=None):
        self.device = resolve_device(device)
        self.generator = (generator if generator is not None
                          else make_generator(0, self.device))

    def conv(self, *args, **kwargs):
        return Conv2D(*args, device=self.device, generator=self.generator,
                      **kwargs)

    def bn(self, num_features, **kwargs):
        return BatchNorm2D(num_features, device=self.device, **kwargs)

    def linear(self, in_features, out_features, **kwargs):
        return Linear(in_features, out_features, device=self.device,
                      generator=self.generator, **kwargs)


def no_pretrained(pretrained):
    """The builders' `pretrained` flag: no weights are shipped."""
    if pretrained:
        raise NotImplementedError("no pretrained weights are shipped")
