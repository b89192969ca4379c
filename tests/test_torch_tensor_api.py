"""The port's top-level tensor functions (`paddle_tpu_torch.tensor_api`,
star-imported by the package) against the JAX package's, on the CPU.

Every public name has a case in `tests/torch_tensor_api_cases.py`: the
same seeded inputs (float32; JAX's x64 off) go through both packages and
the outputs agree within the case's tolerance, a fraction of the largest
magnitude of each reference output (of 1 where that is smaller):
manipulation, indexing, sorting and integer results equal; elementwise
math 1e-6; reductions and products 1e-5.  Integer widths are not
compared (the port keeps int64 where JAX gives int32: the intended
divergence of ROADMAP.md C).  The gradients of the differentiable
families are held in `test_torch_tensor_api_grads.py` (the two halves
fit a test worker's minute apart).  Random functions hold shapes,
dtypes, ranges and moments, the same draws after the same `seed`, and a
static program's fresh draws on every `Executor.run`.  Then the traps
the reference sets apart from torch, one test each.
"""
import numpy as np
import pytest
import torch

import torch_cpu_threads
from torch_api_parity import check_values, port_call
from torch_tensor_api_cases import CASES, public_names, to_numpy

import paddle_tpu_torch as P
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import tensor_api as T

torch_cpu_threads.limit()

MINE = [c for c in CASES if c.module == "tensor_api"]


@pytest.fixture(autouse=True)
def cpu_place():
    """The creation functions run on the CPU (`set_device("cpu")`)."""
    before = tdevice._current_place[0]
    P.set_device("cpu")
    yield
    tdevice._current_place[0] = before


def test_every_public_name_has_a_case():
    names = public_names(T)
    assert names == {c.name for c in MINE}
    assert P.seed is T.seed and P.to_tensor is T.to_tensor
    assert P.finfo is T.finfo and P.zeros is T.zeros and P.sum is T.sum


@pytest.mark.parametrize("case", [c for c in MINE if not c.random],
                         ids=lambda c: c.id)
def test_function_matches_the_reference(case):
    assert check_values(case) is None, (case.id, check_values(case))


@pytest.mark.parametrize("case", [c for c in MINE if c.random],
                         ids=lambda c: c.id)
def test_random_function_shapes_ranges_and_seed(case):
    args, kw = case.inputs()
    P.seed(123)
    first = to_numpy(port_call(case, args, kw)[0])
    assert case.check(first) == [], case.id
    P.seed(123)
    again = to_numpy(port_call(case, args, kw)[0])
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_random_draws_anew_in_each_static_run(monkeypatch):
    from paddle_tpu_torch import jit, static
    from paddle_tpu_torch.framework import static_graph as SG
    monkeypatch.setattr(jit, "_BACKEND", "aot_eager")   # semantics only
    P.enable_static()
    SG.reset()
    try:
        x = static.data("x", [4], "float32")
        out = x + P.rand([4]) + P.uniform([4], min=2.0, max=3.0)
        exe = static.Executor()
        feed = {"x": np.zeros(4, np.float32)}
        (a,) = exe.run(feed=feed, fetch_list=[out])
        (b,) = exe.run(feed=feed, fetch_list=[out])
    finally:
        SG.reset()
        P.disable_static()
    assert a.shape == (4,) and not np.array_equal(a, b)
    assert (a >= 2.0).all() and (a < 4.0).all()


# ------------------------------------------------------------- the traps
def test_max_and_median_follow_the_reference_not_torch():
    x = torch.tensor([[1.0, 4.0, 2.0, 3.0]])
    assert T.max(x, 1).shape == (1,)            # values only
    assert T.median(x).item() == 2.5            # the middle two averaged
    assert torch.median(x).item() == 2.0        # torch takes the lower
    assert T.nanmedian(torch.tensor([1.0, float("nan"), 3.0, 4.0])) \
        .item() == 3.0


def test_scatter_add_keeps_the_rows_it_adds_to():
    x = torch.ones(3, 2)
    out = T.scatter(x, torch.tensor([1, 1]), torch.full((2, 2), 2.0),
                    overwrite=False)
    np.testing.assert_array_equal(out.numpy(), [[1, 1], [5, 5], [1, 1]])


def test_sort_topk_and_mode_break_ties_as_the_reference():
    x = torch.tensor([2, 1, 2, 1, 2])
    assert T.argsort(x, descending=True).tolist() == [0, 2, 4, 1, 3]
    assert T.topk(x, 2)[1].tolist() == [0, 2]
    assert T.topk(x, 2, largest=False)[1].tolist() == [1, 3]
    v, i = T.mode(torch.tensor([3, 1, 3, 1, 5]))
    assert (v.item(), i.item()) == (1, 3)       # the smallest, its last
    assert T.kthvalue(x, 2)[1].item() == 3


def test_python_sign_rule_and_polygamma_order():
    a, b = torch.tensor([-7, 7]), torch.tensor([2, -2])
    assert T.floor_divide(a, b).tolist() == [-4, -4]
    assert T.mod(a, b).tolist() == [1, -1]
    assert T.remainder(a, b).tolist() == [1, -1]
    x = torch.tensor([1.5])
    assert torch.allclose(T.polygamma(x, 1), torch.polygamma(1, x))


def test_unique_gives_first_occurrences_on_the_device():
    x = torch.tensor([3, 1, 3, 2, 1])
    u, idx, inv, cnt = T.unique(x, True, True, True)
    assert u.tolist() == [1, 2, 3] and idx.tolist() == [1, 3, 0]
    assert inv.tolist() == [2, 0, 2, 1, 0] and cnt.tolist() == [2, 1, 2]


def test_histogram_takes_the_data_range_and_one_hot_never_asserts():
    h = T.histogram(torch.tensor([1.0, 2.0, 3.0, 3.0]), bins=2)
    assert h.tolist() == [1, 3]
    assert T.one_hot(torch.tensor([0, 9]), 3).tolist() == [[1, 0, 0],
                                                          [0, 0, 0]]


def test_take_raise_checks_bounds_and_builtins_survive():
    with pytest.raises(IndexError):
        T.take(torch.arange(4.0), torch.tensor([4]))
    import builtins
    assert T.sum is not builtins.sum and P.abs is T.abs
    assert T.slice(torch.arange(6).reshape(2, 3), [1], [1], [3]).tolist() \
        == [[1, 2], [4, 5]]


def test_creation_follows_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tdevice, "_current_place", [None])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.zeros([2])
    assert T.zeros([2], device="cpu").device.type == "cpu"
    assert T.arange(3, device="cpu").dtype == torch.int64
    assert T.full([1], 2, device="cpu").dtype == torch.int64
