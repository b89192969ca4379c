"""The port's `linalg`, `fft` and `signal` against the JAX package's, on
the CPU.

Every public name of the three modules has a case in
`tests/torch_tensor_api_cases.py`; the same seeded float32 inputs go
through both packages and the outputs agree within 1e-4 of the largest
magnitude of each reference output (of 1 where that is smaller); the
factors whose signs and phases are free (`qr`, `svd`, `eigh`, `eig`,
`lu_unpack`) are held by their products and invariants instead.
`solve`, `inv`, `det`, `cholesky`, `norm`, `fft`, `ifft`, `rfft`, `fft2`,
`frame`, `overlap_add` and `stft` (with respect to the signal and the
window) also hold their gradients (the reference's tape against torch
autograd, 1e-4).  Then the contracts one test each: `lu`'s 1-based
int32 pivots and info, `lu_unpack`'s shapes, `fftfreq`'s dtype and
device rule, `fftshift` over every axis, the frame-count checks and the
contradictory-flags error of `istft`, and `istft(stft(x))` giving x
back.
"""
import numpy as np
import pytest
import torch

import torch_cpu_threads
from torch_api_parity import check_grads, check_values
from torch_tensor_api_cases import CASES, LIN, public_names

import paddle_tpu as pt
import paddle_tpu_torch as P
from paddle_tpu_torch import device as tdevice

torch_cpu_threads.limit()

MODULES = ("linalg", "fft", "signal")
MINE = [c for c in CASES if c.module in MODULES]


@pytest.fixture(autouse=True)
def cpu_place():
    before = tdevice._current_place[0]
    P.set_device("cpu")
    yield
    tdevice._current_place[0] = before


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_case(module):
    names = public_names(getattr(P, module))
    assert names == {c.name for c in MINE if c.module == module}
    assert names == set(getattr(pt, module).__all__) if \
        hasattr(getattr(pt, module), "__all__") else True


@pytest.mark.parametrize("case", MINE, ids=lambda c: c.id)
def test_function_matches_the_reference(case):
    err = check_values(case)
    assert err is None, (case.id, err)


@pytest.mark.parametrize("case", [c for c in MINE if c.grad],
                         ids=lambda c: c.id)
def test_gradients_match_the_reference(case):
    err = check_grads(case, max(case.tol, LIN))
    assert err is None, (case.id, err)


def test_lu_contract():
    a = torch.tensor([[1.0, 2.0, 0.5], [4.0, 1.0, 2.0], [0.5, 3.0, 1.0]])
    lu, piv, info = P.linalg.lu(a, get_infos=True)
    assert piv.dtype == torch.int32 and piv.tolist() == [2, 3, 3]
    assert info.dtype == torch.int32 and info.tolist() == [0]
    p, l, u = P.linalg.lu_unpack(lu, piv)
    assert (p.shape, l.shape, u.shape) == ((3, 3), (3, 3), (3, 3))
    torch.testing.assert_close(p @ l @ u, a)
    wide = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    p, l, u = P.linalg.lu_unpack(*P.linalg.lu(wide))
    assert (l.shape, u.shape) == ((3, 3), (3, 5))
    assert P.linalg.qr(a, mode="r").shape == (3, 3)


def test_fft_contracts(monkeypatch):
    assert P.fft.fftfreq(4).dtype == torch.float32
    assert P.fft.fftfreq(4, dtype="float64").dtype == torch.float64
    x = torch.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(P.fft.fftshift(x).numpy(),
                                  np.fft.fftshift(x.numpy()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tdevice, "_current_place", [None])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.fft.fftfreq(4)
    assert P.fft.rfftfreq(4, device="cpu").device.type == "cpu"


def test_signal_checks_and_round_trip():
    x = torch.randn(2, 200, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="shorter than frame_length"):
        P.signal.frame(torch.zeros(4), 8, 2)
    with pytest.raises(ValueError, match="shorter than frame_length"):
        P.signal.stft(torch.zeros(4), 16, center=False)
    with pytest.raises(ValueError, match="contradictory"):
        P.signal.istft(torch.zeros(2, 9, 3, dtype=torch.complex64), 16,
                       return_complex=True)
    win = torch.hann_window(32, periodic=True)
    spec = P.signal.stft(x, 32, 8, window=win)
    assert spec.shape == (2, 17, 26) and spec.dtype == torch.complex64
    back = P.signal.istft(spec, 32, 8, window=win, length=200)
    torch.testing.assert_close(back, x, rtol=1e-4, atol=1e-5)
