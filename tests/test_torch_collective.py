"""The port's collectives, on the CPU.

In 2 gloo ranks (one launch for the file): every collective against
numpy (the five reductions, AVG over gloo by sum and divide, all_gather,
reduce_scatter, broadcast, reduce, scatter, alltoall, alltoall_single,
send / recv, isend / irecv, ppermute over the mesh's mp axis, the object
collectives, groups), the payload accounting, and `collective.fail_once`
retried by the policy on every rank.

In this process, without a process group (where both packages' calls
are the identity): the policy's deadline and retry and the three chaos
sites against the JAX package's outcomes, call for call: what raises,
and the timeout, retry and failure counters.
"""
import warnings

import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import collective as JC
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.resilience import chaos
from torch_gloo import Ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return Ranks(2, [{"name": "collectives", "fn": "collectives"}],
                 tmp_path_factory.mktemp("coll"))


def test_every_collective_matches_numpy_in_two_ranks(ranks):
    got = ranks["collectives"]
    assert int(got["failures"]) == 1 and int(got["retry"]) == 1


def test_ranks_load_no_jax(ranks):
    ranks["collectives"]
    assert ranks.modules() == {0: [], 1: []}


_COUNTERS = ("collective_timeout_total", "collective_retry_total",
             "collective_failures_total")


def _drill(pkg, spec, policy):
    """One all_reduce under `spec` and `policy` in package `pkg`: the
    outcome and the counters' increments."""
    coll, ch, reg = (C, chaos, metrics.registry()) if pkg == "torch" else \
        (JC, jchaos, jmetrics.registry())
    before = [reg.counter(n, op="all_reduce").value for n in _COUNTERS]
    coll.configure_collectives(**policy)
    ch.install(ch.ChaosPlan(spec))
    t = torch.ones(3) if pkg == "torch" else pt.ones([3])
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = coll.all_reduce(t)
        outcome = "ok" if out is t else "other"
    except Exception as e:      # noqa: BLE001 — the outcome is compared
        outcome, w = type(e).__name__, []
    finally:
        ch.uninstall()
        coll.configure_collectives()
    after = [reg.counter(n, op="all_reduce").value for n in _COUNTERS]
    kinds = sorted({str(x.message).split(":")[0] for x in w})
    return outcome, [a - b for a, b in zip(after, before)], kinds


DRILLS = [
    ("collective.fail_once@1", dict(retries=1, backoff_base=0.0)),
    ("collective.fail_once@1", dict(retries=0, backoff_base=0.0)),
    ("collective.timeout@1", dict(retries=1, backoff_base=0.0)),
    ("collective.timeout@1*2", dict(retries=1, backoff_base=0.0)),
    ("collective.hang@1", dict(timeout=0.05, retries=1, backoff_base=0.0)),
    ("collective.hang@1", dict(retries=0, backoff_base=0.0)),
]


@pytest.mark.parametrize("spec,policy", DRILLS,
                         ids=[f"{s}-{p.get('timeout')}-{p['retries']}"
                              for s, p in DRILLS])
def test_policy_and_chaos_sites_match_jax(spec, policy):
    assert _drill("torch", spec, policy) == _drill("jax", spec, policy)


def test_policy_from_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_COLLECTIVE_TIMEOUT", "2.5")
    monkeypatch.setenv("PADDLE_TPU_COLLECTIVE_RETRIES", "3")
    try:
        pol = C.policy_from_env()
        assert (pol.timeout, pol.retries) == (2.5, 3)
        assert C.collective_policy() is pol
    finally:
        C.configure_collectives()
    assert C.collective_policy() is None


def test_single_process_calls_are_the_identity_and_loop_back():
    t = torch.arange(4.0)
    assert C.all_reduce(t, op=C.ReduceOp.AVG) is t
    assert torch.equal(t, torch.arange(4.0))
    assert C.all_gather(None, t).shape == (1, 4)
    C.send(torch.full((2,), 3.0))
    r = torch.empty(2)
    C.recv(r)
    assert r.tolist() == [3.0, 3.0]
    with pytest.raises(RuntimeError, match="no pending send"):
        C.recv(r)
    with pytest.raises(NotImplementedError, match="uneven"):
        C.alltoall_single(None, t, in_split_sizes=[1, 3])
