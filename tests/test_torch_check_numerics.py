"""C10: the `check_numerics` flag in the port's training steps, against the
JAX package's, on the CPU.

With `set_flags({"check_numerics": True})` before a step's first call, a
loss times NaN raises FloatingPointError with the reference's message
word for word ("check_numerics: non-finite values at step N in: loss,
weight, bias"; at most 8 names, then "(+k more)"), through `TrainStep`
and through the fleet's `DistributedTrainStep` at world size 1 here and
2 in gloo ranks (`tests/torch_gloo_checks.py::check_numerics`, the flags
combined over the ranks).  The parameters are bit-equal to their values
before the step; the step counter has advanced in both packages; the
intended divergence (ROADMAP.md C): the reference's optimizer state
already holds the bad step's moments when it raises, the port's slots
are untouched, and its parameters stay usable where a donating JAX step
(the default) has given their buffers away.  The flag is read on a
step's first call, as the reference reads it when it builds the step.
With the flag off a step calls no check, and a finite step's loss and
parameters are the same bits as with it on.
`framework.debugging.check_numerics` checks one tensor.
"""
import numpy as np
import pytest
import torch

import torch_cpu_threads
from torch_gloo import Ranks

import paddle_tpu as pt
from paddle_tpu.framework import flags as ref_flags
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as O
from paddle_tpu_torch.distributed import fleet, mesh
from paddle_tpu_torch.framework import debugging, flags
from paddle_tpu_torch.jit import train_step

torch_cpu_threads.limit()


@pytest.fixture
def check_on():
    before = (flags.get_flags("check_numerics"),
              ref_flags.get_flags("check_numerics"))
    flags.set_flags({"check_numerics": True})
    ref_flags.set_flags({"check_numerics": True})
    yield
    flags.set_flags({"check_numerics": before[0]})
    ref_flags.set_flags({"check_numerics": before[1]})


def _loss(m, x):
    return (m(x) ** 2).mean() * x.sum()


def _pair(layers=1, opt="sgd"):
    """The same stack of Linear(4, 4) in both packages, one optimizer."""
    ref = pt.nn.Sequential(*[pt.nn.Linear(4, 4) for _ in range(layers)])
    port = tnn.Sequential(*[tnn.Linear(4, 4, device="cpu")
                            for _ in range(layers)])
    if opt == "adam":
        return (ref, pt.optimizer.Adam(learning_rate=0.1,
                                       parameters=ref.parameters()),
                port, O.Adam(learning_rate=0.1,
                             parameters=port.parameters()))
    return (ref, pt.optimizer.SGD(learning_rate=0.1,
                                  parameters=ref.parameters()),
            port, O.SGD(learning_rate=0.1, parameters=port.parameters()))


X = np.arange(8, dtype=np.float32).reshape(2, 4) / 8
BAD = np.full((2, 4), np.nan, np.float32)


def _raise(step, x):
    with pytest.raises(FloatingPointError) as e:
        step(x)
    return str(e.value)


@pytest.mark.parametrize("layers", [1, 5])
def test_train_step_raises_the_reference_message(check_on, layers):
    ref, ropt, port, popt = _pair(layers)
    # donate=False: a donating JAX step has given its parameters' buffers
    # away when it raises, and cannot take another step
    rstep = pt.jit.train_step(ref, _loss, ropt, donate=False)
    pstep = train_step(port, _loss, popt)
    rstep(pt.to_tensor(X))
    pstep(torch.from_numpy(X))
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    want = _raise(rstep, pt.to_tensor(BAD))
    got = _raise(pstep, torch.from_numpy(BAD))
    assert got == want
    assert want.startswith("check_numerics: non-finite values at step 2 "
                           "in: loss, 0.weight, 0.bias")
    if layers == 5:
        assert want.endswith("(+3 more)")
    for n, p in port.named_parameters():
        assert torch.equal(p, before[n]), n
        assert p.grad is None, n
    # the step goes on from there in both
    rstep(pt.to_tensor(X))
    pstep(torch.from_numpy(X))
    assert popt._step_count == rstep._step == 3


def test_slots_and_step_count_after_the_raise(check_on):
    """Both counters advance; the reference's state holds the bad step's
    moments (NaN), the port's slots are as before the step: the intended
    divergence."""
    ref, ropt, port, popt = _pair(opt="adam")
    rstep = pt.jit.train_step(ref, _loss, ropt)
    pstep = train_step(port, _loss, popt)
    rstep(pt.to_tensor(X))
    pstep(torch.from_numpy(X))
    slots = [{k: v.clone() for k, v in s.items()} for s in popt._state]
    _raise(rstep, pt.to_tensor(BAD))
    _raise(pstep, torch.from_numpy(BAD))
    assert rstep._step == popt._step_count == 2
    ref_leaves = [np.asarray(a) for a in
                  __import__("jax").tree_util.tree_leaves(rstep._opt_state)
                  if np.ndim(a) > 0]
    assert ref_leaves and not all(np.isfinite(a).all() for a in ref_leaves)
    for old, new in zip(slots, popt._state):
        for k in old:
            assert torch.equal(old[k], new[k]), k


def test_flag_is_read_on_the_first_call(check_on):
    ref, ropt, port, popt = _pair()
    flags.set_flags({"check_numerics": False})
    ref_flags.set_flags({"check_numerics": False})
    rstep = pt.jit.train_step(ref, _loss, ropt)
    pstep = train_step(port, _loss, popt)
    rstep(pt.to_tensor(X))
    pstep(torch.from_numpy(X))
    flags.set_flags({"check_numerics": True})
    ref_flags.set_flags({"check_numerics": True})
    assert np.isnan(float(rstep(pt.to_tensor(BAD))))
    assert np.isnan(float(pstep(torch.from_numpy(BAD))))


def test_flag_off_checks_nothing_and_changes_no_bit(monkeypatch):
    import importlib
    # the module: `jit.train_step` is also the function
    ts = importlib.import_module("paddle_tpu_torch.jit.train_step")

    def refuse(*a, **k):
        raise AssertionError("the check ran with the flag off")
    runs = []
    for on in (False, True):
        flags.set_flags({"check_numerics": on})
        torch.manual_seed(0)
        port = tnn.Sequential(tnn.Linear(4, 4, device="cpu"))
        opt = O.Adam(learning_rate=0.1, parameters=port.parameters())
        step = train_step(port, _loss, opt)
        if not on:
            monkeypatch.setattr(ts, "check_step", refuse)
        losses = [step(torch.from_numpy(X)) for _ in range(3)]
        monkeypatch.undo()
        runs.append((losses, [p.detach().clone()
                              for p in port.parameters()]))
    flags.set_flags({"check_numerics": False})
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)


def test_finite_flags_and_check_numerics(check_on):
    loss = torch.tensor(1.0)
    grads = [torch.tensor([1.0, float("inf")]), None,
             torch.tensor([float("nan")], dtype=torch.bfloat16),
             torch.ones(3)]
    assert debugging.finite_flags(loss, grads).tolist() == \
        [True, False, True, False, True]
    with pytest.raises(FloatingPointError, match="in w"):
        debugging.check_numerics(torch.tensor([np.nan]), "w")
    x = torch.ones(2)
    assert debugging.check_numerics(x) is x


def test_fleet_step_world_one_raises_the_reference_message(check_on):
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed import mesh as jmesh
    ref, ropt, port, popt = _pair()
    jfleet.init(is_collective=True, strategy=jfleet.DistributedStrategy())
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
    try:
        rstep = jfleet.build_train_step(ref, _loss, ropt)
        pstep = fleet.build_train_step(port, _loss, popt)
        rstep(pt.to_tensor(X))
        pstep(torch.from_numpy(X))
        before = [p.detach().clone() for p in port.parameters()]
        want = _raise(rstep, pt.to_tensor(BAD))
        got = _raise(pstep, torch.from_numpy(BAD))
    finally:
        jmesh.clear_mesh() if hasattr(jmesh, "clear_mesh") else None
        mesh.clear_mesh()
        fleet.fleet._strategy = None
    assert got == want == ("check_numerics: non-finite values at step 2 "
                           "in: loss, 0.weight, 0.bias")
    for a, b in zip(before, port.parameters()):
        assert torch.equal(a, b)


def test_fleet_step_two_ranks_raise_alike(tmp_path):
    ranks = Ranks(2, [{"name": "numerics", "fn": "check_numerics",
                       "kw": {}}], tmp_path)
    out = ranks["numerics"]
    assert str(out["message"]) == ("check_numerics: non-finite values at "
                                   "step 2 in: loss, 0.weight, 0.bias")
    assert out["unchanged"].all() and out["same_message"].all()
