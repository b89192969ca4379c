"""Fault injection, the checkpoint manager and the nonfinite-step guard
(`paddle_tpu_torch.resilience`) on the CPU, against the JAX package's.

Covered, as tests/test_chaos_resilience.py covers the JAX package:
* the chaos plan grammar and firing, hit for hit equal to the JAX
  package's plans (the same specs, seeds and hit sequences);
* the manager: retention and GC, fall-back past torn and truncated
  checkpoints (a crash after the meta stage and after the arrays), the
  SIGTERM handler with its final save, and the `save.sigterm` site;
* the guard in "fused" and "exact" mode against the JAX package's guard:
  parameters and optimizer slots after a clean, a poisoned and a clean
  step; a skipped step leaves the parameters bit for bit;
* rollback loss continuity: two poisoned steps roll back to the
  checkpoint and the replayed steps' losses equal a clean run's bit for
  bit (the port's version of `test_forced_nan_rollback_loss_continuity`);
* deferred verdicts (`check_every`), the FloatingPointError without a
  manager, `env_guard`, buffers selected back on a bad step;
* the integer-batch poison, where the port leaves the JAX package on
  purpose (ROADMAP C): it poisons the loss, not the indices.

Tolerance against the JAX package: 1e-6 (rtol and atol), the same
float32 formulas (tests/test_torch_optimizer_state.py).
"""
import os
import signal

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.jit.train_step import TrainStep as JaxTrainStep
from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu.resilience import guard as jguard
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework.checkpoint import CheckpointError
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.resilience import chaos, guard
from paddle_tpu_torch.resilience.chaos import ChaosInterrupt, ChaosPlan
from paddle_tpu_torch.resilience.guard import NonfiniteGuard, env_guard
from paddle_tpu_torch.resilience.manager import CheckpointManager

TOL = dict(rtol=1e-6, atol=1e-6)
pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    chaos.uninstall()
    jchaos.uninstall()


# =================================================================== chaos
SPECS = ["step.nonfinite@3", "loader.worker_kill@2#1*2",
         "loader.batch_corrupt~0.25", "loader.worker_kill#1@2*2",
         "a.b*inf", "s.x@2*2;s.y@1", "s.x@2#b"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_grammar_parses_as_the_jax_package(spec):
    t, j = ChaosPlan(spec), jchaos.ChaosPlan(spec)
    assert [(e.site, e.at, e.tag, e.repeat, e.prob) for e in t.entries] == \
        [(e.site, e.at, e.tag, e.repeat, e.prob) for e in j.entries]
    assert [repr(e) for e in t.entries] == [repr(e) for e in j.entries]


@pytest.mark.parametrize("spec,hits", [
    ("s.x@2*2", [("s.x", None)] * 5),
    ("s.x@2#b", [("s.x", "a"), ("s.x", "b"), ("s.x", "a"), ("s.x", "b")]),
    ("s.x~0.5*inf", [("s.x", None)] * 32),
    ("s.x@1;s.y@2*inf", [("s.x", None), ("s.y", None)] * 4),
])
@pytest.mark.parametrize("seed", [3, 4])
def test_plans_fire_hit_for_hit_as_the_jax_packages(spec, hits, seed):
    t, j = ChaosPlan(spec, seed=seed), jchaos.ChaosPlan(spec, seed=seed)
    assert [t.should_fire(*h) for h in hits] == \
        [j.should_fire(*h) for h in hits]
    assert t.log == j.log


def test_fire_scoped_crash_and_the_fast_path():
    assert chaos.active() is None and not chaos.fire("anything")
    chaos.install("s.x@2*2")
    assert [chaos.fire("s.x") for _ in range(5)] == [False, True, True,
                                                     False, False]
    chaos.uninstall()
    with chaos.scoped("s.x@1") as plan:
        assert chaos.active() is plan
        with pytest.raises(ChaosInterrupt):
            chaos.crash("s.x")
    assert chaos.active() is None


def test_plan_from_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CHAOS", "s.y@1")
    monkeypatch.setenv("PADDLE_TPU_CHAOS_SEED", "9")
    plan = chaos.plan_from_env()
    assert plan is chaos.active()
    assert plan.seed == 9 and plan.entries[0].site == "s.y"
    monkeypatch.delenv("PADDLE_TPU_CHAOS")
    chaos.uninstall()
    assert chaos.plan_from_env() is None


def test_chaos_interrupt_is_not_swallowed_by_except_exception():
    with pytest.raises(ChaosInterrupt):
        try:
            raise ChaosInterrupt("site")
        except Exception:
            pytest.fail("ChaosInterrupt must bypass `except Exception`")


def test_poison_batch_multiplies_the_first_float_tensor_like_jax():
    ids = torch.arange(6).reshape(2, 3)
    x = torch.ones(2, 3)
    y = torch.ones(2)
    out, rode = chaos.poison_batch((ids, x, y))
    assert rode and torch.equal(out[0], ids) and torch.equal(out[2], y)
    assert torch.isnan(out[1]).all()
    j = jchaos.poison_batch((ids.numpy(), x.numpy(), y.numpy()))
    assert np.isnan(j[1]).all() and np.array_equal(j[2], y.numpy())


def test_an_integer_batch_poisons_the_loss_not_the_indices():
    """The intended divergence (ROADMAP C): the JAX package sets the
    first array of an integer-only batch to the int32 maximum, which its
    embedding reads as NaN; in PyTorch that index raises on the CPU and
    trips a device-side assert on CUDA.  The port leaves the batch alone
    and multiplies the loss by NaN: loss and gradients go nonfinite, the
    guarded step skips, and no index leaves its range."""
    ids = torch.tensor([[1, 2, 3], [0, 4, 2]])
    labels = torch.tensor([1, 0])
    out, rode = chaos.poison_batch((ids, labels))
    assert not rode and all(torch.equal(a, b)
                            for a, b in zip(out, (ids, labels)))
    j = jchaos.poison_batch((ids.numpy(), labels.numpy()))
    assert int(j[0].max()) == np.iinfo(np.int32).max

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Embedding(5, 4),
                                torch.nn.Flatten(), torch.nn.Linear(12, 2))
    g = NonfiniteGuard(max_consecutive=5)
    ts = TrainStep(model, lambda m, i, y: torch.nn.functional.cross_entropy(
        m(i), y), topt.Adam(parameters=model.parameters()), guard=g)
    ts(ids, labels)
    before = [p.detach().clone() for p in model.parameters()]
    with chaos.scoped("step.nonfinite@1"):
        loss = ts(ids, labels)
    assert torch.isnan(loss)
    assert g.total_skipped == 1
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))


# =============================================================== the guard
def _linear_pair(seed=7):
    paddle.seed(seed)
    jm = jnn.Linear(4, 2)
    tm = torch.nn.Linear(4, 2)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.asarray(jm.weight._array).T
                                         .copy()))
        tm.bias.copy_(torch.from_numpy(np.asarray(jm.bias._array).copy()))
    return jm, tm


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(8, 4).astype("float32"), rs.randn(8, 2).astype("float32")


def _loss(m, x, y):
    """Both packages' mean squared error."""
    return ((m(x) - y) ** 2).mean()


OPTS = {"SGD": {}, "Momentum": dict(momentum=0.9), "Adam": {},
        "AdamW": dict(weight_decay=0.1)}


def _steps_pair(opt_name, guard_kw, seed=7):
    jm, tm = _linear_pair(seed)
    kw = dict(learning_rate=0.1, **OPTS[opt_name])
    jts = JaxTrainStep(jm, _loss, getattr(paddle.optimizer, opt_name)(
        parameters=jm.parameters(), **kw),
        guard=jguard.NonfiniteGuard(**guard_kw))
    tts = TrainStep(tm, _loss, getattr(topt, opt_name)(
        parameters=tm.parameters(), **kw), guard=NonfiniteGuard(**guard_kw))
    return jm, tm, jts, tts


def _compare(jm, tm, jts, tts):
    np.testing.assert_allclose(tm.weight.detach().numpy(),
                               np.asarray(jm.weight._array).T, **TOL)
    np.testing.assert_allclose(tm.bias.detach().numpy(),
                               np.asarray(jm.bias._array), **TOL)
    jts.sync_optimizer_state()
    jstate = jts.optimizer._state or []
    for js, ts_ in zip(jstate, tts.optimizer._state or []):
        assert set(js) == set(ts_)
        for k in ts_:
            j = np.asarray(js[k])
            np.testing.assert_allclose(ts_[k].numpy(),
                                       j.T if j.ndim == 2 else j, **TOL)


@pytest.mark.parametrize("mode", ["fused", "exact"])
@pytest.mark.parametrize("opt_name", sorted(OPTS))
def test_the_guard_matches_jax_in_both_modes(mode, opt_name):
    """A clean step, a poisoned one, a clean one: parameters and slots
    equal the JAX package's after each.  The skipped step leaves the
    parameters bit for bit; "exact" leaves every slot too, "fused" lets
    the moments take the decay step of a zero gradient, in both
    packages."""
    jm, tm, jts, tts = _steps_pair(opt_name, dict(max_consecutive=5,
                                                  mode=mode))
    x, y = _batch()
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jts(jx, jy)
    tts(tx, ty)
    _compare(jm, tm, jts, tts)
    params = [p.detach().clone() for p in tm.parameters()]
    slots = [{k: v.clone() for k, v in s.items()}
             for s in tts.optimizer._state]
    with jchaos.scoped("step.nonfinite@1"):
        jl = jts(jx, jy)
    with chaos.scoped("step.nonfinite@1"):
        tl = tts(tx, ty)
    assert not np.isfinite(float(jl.numpy())) and torch.isnan(tl)
    assert all(torch.equal(a, b) for a, b in zip(params, tm.parameters()))
    frozen = all(torch.equal(v, s[k]) for s, now in zip(
        slots, tts.optimizer._state) for k, v in now.items())
    if mode == "exact" or opt_name == "SGD":
        assert frozen
    _compare(jm, tm, jts, tts)
    assert tts._guard.total_skipped == jts._guard.total_skipped == 1
    assert tts.step_count == jts._step == 2
    jts(jx, jy)
    tts(tx, ty)
    _compare(jm, tm, jts, tts)
    assert tts._guard.consecutive == jts._guard.consecutive == 0


def test_the_guard_without_a_manager_raises_after_the_threshold():
    _, _, _, tts = _steps_pair("SGD", dict(max_consecutive=2))
    x, y = (torch.from_numpy(a) for a in _batch())
    with chaos.scoped("step.nonfinite@1*2"):
        tts(x, y)
        with pytest.raises(FloatingPointError, match="consecutive"):
            tts(x, y)


def _drive(ts, batches, upto, losses):
    while ts.step_count < upto:
        i = ts.step_count              # a rollback rewinds it inside
        val = ts(*batches[i]).item()
        if np.isfinite(val):           # skipped steps record no loss
            losses[i] = val


def _momentum_step(guard_, seed=11):
    jm, tm = _linear_pair(seed)
    return tm, TrainStep(tm, _loss, topt.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=tm.parameters()),
        guard=guard_)


def test_rollback_replays_a_clean_runs_losses_bit_for_bit(tmp_path):
    """Checkpoint at step 2, two poisoned steps, a rollback, the replay:
    the losses of steps 2-5 and the final parameters equal a run that
    never saw the poison, bit for bit (Momentum's slots go through the
    rollback too); the clean run matches the JAX package's."""
    batches = [tuple(torch.from_numpy(a) for a in _batch(i))
               for i in range(6)]
    model, ref = _momentum_step(NonfiniteGuard())
    ref_losses = {}
    _drive(ref, batches, 6, ref_losses)

    jm, _ = _linear_pair(11)
    jts = JaxTrainStep(jm, _loss, paddle.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=jm.parameters()))
    jlosses = [float(jts(*(paddle.to_tensor(t.numpy()) for t in b)).numpy())
               for b in batches]
    np.testing.assert_allclose([ref_losses[i] for i in range(6)], jlosses,
                               **TOL)

    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    g = NonfiniteGuard(max_consecutive=2, manager=mgr, fold_rng=False)
    model2, ts = _momentum_step(g)
    losses = {}
    _drive(ts, batches, 2, losses)
    mgr.save(2, train_step=ts)
    with chaos.scoped("step.nonfinite@3*2"):
        _drive(ts, batches, 6, losses)
    assert g.rollbacks == 1 and g.total_skipped == 2
    assert losses == ref_losses
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 model2.parameters()))


def test_a_folded_rollback_draws_other_random_numbers(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    model, ts = _momentum_step(NonfiniteGuard(max_consecutive=1,
                                              manager=mgr))
    x, y = (torch.from_numpy(a) for a in _batch())
    ts(x, y)
    mgr.save(1, train_step=ts)
    want = torch.rand(3)
    with chaos.scoped("step.nonfinite@1"):
        ts(x, y)                       # rollback, random state folded
    assert ts._guard.rollbacks == 1 and ts.step_count == 1
    assert not torch.equal(torch.rand(3), want)


def test_deferred_verdicts_drain_in_step_order(tmp_path):
    """check_every=4: verdicts settle at the drain, in step order, and a
    rollback drops the verdicts queued after it."""
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    g = NonfiniteGuard(max_consecutive=2, manager=mgr, check_every=4,
                       fold_rng=False)
    model, ts = _momentum_step(g)
    x, y = (torch.from_numpy(a) for a in _batch())
    ts(x, y)
    ts(x, y)
    mgr.save(2, train_step=ts)
    with chaos.scoped("step.nonfinite@1*2"):
        ts(x, y)
        assert g.total_skipped == 0      # queued, not yet read
        ts(x, y)                         # the 4th verdict drains
    assert g.total_skipped == 2 and g.rollbacks == 1
    assert g._pending == [] and ts.step_count == 2


def test_env_guard(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_GUARD", raising=False)
    assert env_guard() is None
    _, ts = _momentum_step(None)
    assert ts._guard is None
    monkeypatch.setenv("PADDLE_TPU_GUARD", "1")
    monkeypatch.setenv("PADDLE_TPU_GUARD_N", "5")
    monkeypatch.setenv("PADDLE_TPU_GUARD_EVERY", "4")
    monkeypatch.setenv("PADDLE_TPU_GUARD_MODE", "exact")
    _, ts = _momentum_step(None)
    assert isinstance(ts._guard, NonfiniteGuard)
    assert (ts._guard.max_consecutive, ts._guard.check_every,
            ts._guard.mode) == (5, 4, "exact")
    with pytest.raises(ValueError, match="guard mode"):
        NonfiniteGuard(mode="lazy")


@pytest.mark.parametrize("case", ["finite", "nan_loss", "inf_grad",
                                  "nan_bf16_grad", "none_grads"])
def test_all_finite_matches_jax(case):
    import jax.numpy as jnp
    loss = np.float32(np.nan if case == "nan_loss" else 1.5)
    g1 = np.ones((3, 4), np.float32)
    g2 = np.ones(4, np.float32)
    if case == "inf_grad":
        g1[1, 2] = np.inf
    if case == "nan_bf16_grad":
        g2[3] = np.nan
    grads = [g1, None, g2] if case == "none_grads" else [g1, g2]
    tdt = torch.bfloat16 if case == "nan_bf16_grad" else torch.float32
    t = guard.all_finite(torch.tensor(loss), [
        None if g is None else torch.from_numpy(g).to(tdt) for g in grads])
    j = jguard.all_finite(jnp.asarray(loss), [
        None if g is None else jnp.asarray(g) for g in grads])
    assert t.dim() == 0 and t.dtype == torch.bool
    assert bool(t) == bool(j) == (case in ("finite", "none_grads"))


def test_gate_grads_zeroes_nan_where_a_product_would_not():
    g = torch.tensor([1.0, float("nan"), float("inf")])
    same = g.clone()
    guard.gate_grads(torch.tensor(True), [same])
    assert torch.equal(same[:1], g[:1]) and torch.isnan(same[1])
    guard.gate_grads(torch.tensor(False), [g, None])
    assert torch.equal(g, torch.zeros(3))
    lr = torch.tensor(0.5)
    assert float(guard.gate_lr(torch.tensor(False), lr)) == 0.0
    assert float(guard.gate_lr(torch.tensor(True), lr)) == 0.5


@pytest.mark.parametrize("mode", ["fused", "exact"])
def test_a_skipped_step_selects_the_buffers_back(mode):
    """Running statistics update in the forward itself; a bad step puts
    them back, as the JAX step selects its buffers."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                torch.nn.BatchNorm1d(3))
    ts = TrainStep(model, _loss, topt.Adam(parameters=model.parameters()),
                   guard=NonfiniteGuard(max_consecutive=9, mode=mode))
    x, y = torch.randn(8, 4), torch.randn(8, 3)
    ts(x, y)
    bufs = [b.clone() for b in model.buffers()]
    with chaos.scoped("step.nonfinite@1"):
        ts(x, y)
    assert all(torch.equal(a, b) for a, b in zip(bufs, model.buffers()))
    ts(x, y)
    assert not torch.equal(bufs[0], next(model.buffers()))


# ============================================================= the manager
def _saved_step():
    model, ts = _momentum_step(None)
    ts(*(torch.from_numpy(a) for a in _batch()))
    return model, ts


def test_retention_keeps_the_newest(tmp_path):
    _, ts = _saved_step()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, train_step=ts)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest() == mgr.path_for(4)


@pytest.mark.parametrize("site", ["ckpt.crash_after_meta_stage",
                                  "ckpt.crash_after_arrays"])
def test_a_killed_save_falls_back_to_the_previous_good(tmp_path, site):
    _, ts = _saved_step()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    mgr.save(1, train_step=ts)
    with chaos.scoped(f"{site}@1"):
        with pytest.raises(ChaosInterrupt):
            mgr.save(2, train_step=ts)
    assert mgr.latest() == mgr.path_for(1)
    assert mgr.restore(train_step=ts)["step"] == 1
    # and the torn directory heals on the next save of its step
    mgr.save(2, train_step=ts)
    assert mgr.latest() == mgr.path_for(2)
    assert not os.path.exists(os.path.join(mgr.path_for(2),
                                           "meta.json.tmp"))


def test_restore_walks_back_past_truncated_arrays(tmp_path):
    """The probe passes a truncated arrays file (meta is fine); the deep
    load fails and restore() walks back."""
    model, ts = _saved_step()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    mgr.save(1, train_step=ts)
    want = [p.detach().clone() for p in model.parameters()]
    ts(*(torch.from_numpy(a) for a in _batch(1)))
    mgr.save(2, train_step=ts)
    chaos.corrupt_checkpoint(mgr.path_for(2), "truncate_arrays")
    assert mgr.latest() == mgr.path_for(2)
    meta = mgr.restore(train_step=ts)
    assert meta["step"] == 1 and meta["__path__"] == mgr.path_for(1)
    assert ts.step_count == 1
    assert all(torch.equal(a, b) for a, b in zip(want, model.parameters()))


def test_nothing_loadable_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(CheckpointError, match="no loadable checkpoint"):
        mgr.restore()


def test_sigterm_sets_preempted_and_the_final_save_lands(tmp_path):
    _, ts = _saved_step()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, train_step=ts, async_save=True)
    prev = signal.getsignal(signal.SIGTERM)
    mgr.install_preemption_handler()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert mgr.preempted
        assert mgr._pending is None       # the handler flushed it
        ts(*(torch.from_numpy(a) for a in _batch(2)))
        path = mgr.final_save()
    finally:
        mgr.uninstall_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) is prev
    assert path == mgr.path_for(2) and mgr.latest() == path
    assert mgr.restore(train_step=ts)["step"] == 2


def test_the_save_sigterm_site_delivers_the_signal_mid_save(tmp_path):
    _, ts = _saved_step()
    mgr = CheckpointManager(str(tmp_path))
    mgr.install_preemption_handler()
    try:
        with chaos.scoped("save.sigterm@1"):
            mgr.save(1, train_step=ts)
    finally:
        mgr.uninstall_preemption_handler()
    assert mgr.preempted
    assert mgr.restore(train_step=ts)["extra"]["restart_count"] == 0
