"""Device resolution, the Place API and random generators.

Counterparts: `paddle_tpu/device.py` (where the JAX package finds its
accelerator, `Place`, `set_device`, the `cuda` namespace),
`paddle_tpu/base.py` (`CUDAPlace`) and `paddle_tpu/framework/random.py`
(its seeded key stream).  The port runs on the card unless the caller
names the CPU: with no device given, no `set_device("cpu")` and no CUDA
device present, `resolve_device` raises instead of quietly running on
the CPU.  Randomness goes through explicit `torch.Generator`s, one per
call site that wants it; `seed` is `framework.random.seed`, which also
records the seed for checkpoints.

Places: `TPUPlace` is the accelerator's place, which here is the card
(`CUDAPlace` is the same class, as `paddle_tpu.base.CUDAPlace` is
`TPUPlace` there), and `CPUPlace` the host.  `set_device("gpu")`,
`"gpu:N"`, `"tpu"` and `"tpu:N"` name the card, `set_device("cpu")`
the CPU; from then on `resolve_device(None)` answers with that place.
Intended divergence: `get_device()` names the card "gpu:N" where the
JAX package says "tpu:N", and `device_count()` counts CUDA devices
where the JAX package counts every JAX device, the CPU's included.
"""
from __future__ import annotations

import torch

from .framework.random import seed  # noqa: F401  (the one seed path)


class Place:
    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def torch_device(self):
        """The torch.device of this place (the card's raises RuntimeError
        when there is no CUDA device)."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self!r} names a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU")
        return torch.device("cuda", self.device_id)


class TPUPlace(Place):
    """The accelerator's place: the card."""
    device_type = "gpu"


class CPUPlace(Place):
    device_type = "cpu"


CUDAPlace = TPUPlace

_current_place = [None]       # None: nothing set, the card is the default


def set_device(device):
    """set_device("gpu") / ("gpu:1") / ("tpu") / ("cpu"); returns the
    Place, which `resolve_device(None)` honours from then on."""
    name, _, idx = str(device).partition(":")
    idx = int(idx) if idx else 0
    if name in ("gpu", "cuda", "tpu", "xpu", "npu"):
        _current_place[0] = TPUPlace(idx)
    elif name == "cpu":
        _current_place[0] = CPUPlace(idx)
    else:
        raise ValueError(f"unknown device {device!r}")
    return _current_place[0]


def current_place() -> Place:
    """The place `set_device` chose; before any, the card when there is
    one, else the CPU (a query: `resolve_device(None)` still raises
    without a card unless the CPU was asked for)."""
    if _current_place[0] is not None:
        return _current_place[0]
    if torch.cuda.is_available():
        return TPUPlace(torch.cuda.current_device())
    return CPUPlace(0)


def get_device() -> str:
    p = current_place()
    return f"{p.device_type}:{p.device_id}"


def is_compiled_with_tpu() -> bool:
    """True when the accelerator (the card) is present."""
    return torch.cuda.is_available()


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_xpu() -> bool:
    return False


def device_count() -> int:
    return torch.cuda.device_count()


def resolve_device(device=None):
    """`device` (a str, torch.device or Place) as a torch.device; None
    means the place `set_device` chose, else the current CUDA device,
    and raises RuntimeError when that is the card and there is none."""
    if isinstance(device, Place):
        return device.torch_device()
    if isinstance(device, str) and device.split(":")[0] in ("gpu", "tpu"):
        name, _, idx = device.partition(":")
        return TPUPlace(int(idx or 0)).torch_device()
    if device is not None:
        return torch.device(device)
    if _current_place[0] is not None:
        return _current_place[0].torch_device()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def generator(seed, device=None):
    """A torch.Generator on `device`, seeded with `seed`."""
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))


# ------------------------------------------------------------ the cuda API
class _CudaNamespace:
    """paddle.device.cuda: torch.cuda's own calls (the JAX package maps
    them onto its runtime, `paddle_tpu/device.py:101-150`)."""

    @staticmethod
    def device_count():
        return torch.cuda.device_count()

    @staticmethod
    def empty_cache():
        torch.cuda.empty_cache()

    @staticmethod
    def synchronize(device=None):
        torch.cuda.synchronize(device)

    @staticmethod
    def max_memory_allocated(device=None):
        return torch.cuda.max_memory_allocated(device)

    @staticmethod
    def memory_allocated(device=None):
        return torch.cuda.memory_allocated(device)

    @staticmethod
    def get_device_name(device=None):
        return torch.cuda.get_device_name(device)

    Stream = torch.cuda.Stream
    Event = torch.cuda.Event


cuda = _CudaNamespace()
