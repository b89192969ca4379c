"""Checkpoint and resume (`framework.checkpoint`) on the CPU, against an
unbroken run and against the JAX package's `save_state` / `load_state`.

* Deterministic resume: 4 steps, save, load into a fresh model,
  optimizer, scheduler and scaler built from other seeds, 4 more steps:
  the loss series and the parameters equal an unbroken 8-step run bit
  for bit (float32, a tiny BERT with dropout on, a LinearWarmup schedule,
  a GradScaler, global-norm clipping), for every optimizer of the port.
* The slots after such a resumed run equal the JAX package's after 8
  unbroken steps, within 1e-6 (rtol and atol: the same float32 formulas,
  as tests/test_torch_optimizer_state.py states).
* The meta sidecar has the JAX package's keys, and the slots the JAX
  package's names (the model's parameter names).
* `CheckpointError` on every partial or torn layout, with the half that
  failed (mirroring tests/test_chaos_resilience.py:156-217 and
  tests/test_checkpoint.py:31-100), raised before anything is changed.
* An async save is not torn by the next step's in-place update.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu_torch import amp, optimizer as topt
from paddle_tpu_torch.framework import checkpoint as ck
from paddle_tpu_torch.framework.checkpoint import (CheckpointError,
                                                   async_save, load_state,
                                                   probe, save_state)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.text import BertConfig, BertForSequenceClassification

TOL = dict(rtol=1e-6, atol=1e-6)
TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32, hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1)

OPTIMIZERS = {
    "AdamW": lambda ps, s: topt.AdamW(learning_rate=s, parameters=ps,
                                      grad_clip=ClipGradByGlobalNorm(1.0)),
    "Adam": lambda ps, s: topt.Adam(learning_rate=s, parameters=ps),
    "Momentum": lambda ps, s: topt.Momentum(learning_rate=s, parameters=ps),
    "Adafactor": lambda ps, s: topt.Adafactor(learning_rate=s,
                                              parameters=ps, beta1=0.9),
    "SGD": lambda ps, s: topt.SGD(learning_rate=s, parameters=ps),
    "Adagrad": lambda ps, s: topt.Adagrad(learning_rate=s, parameters=ps),
    "RMSProp": lambda ps, s: topt.RMSProp(learning_rate=s, parameters=ps,
                                          centered=True, momentum=0.5),
    "Adadelta": lambda ps, s: topt.Adadelta(learning_rate=s, parameters=ps),
    "Lamb": lambda ps, s: topt.Lamb(learning_rate=s, parameters=ps),
    "Adamax": lambda ps, s: topt.Adamax(learning_rate=s, parameters=ps),
    "NAdam": lambda ps, s: topt.NAdam(learning_rate=s, parameters=ps),
    "RAdam": lambda ps, s: topt.RAdam(learning_rate=s, parameters=ps),
    "ASGD": lambda ps, s: topt.ASGD(learning_rate=s, parameters=ps,
                                    batch_num=3),
    "Rprop": lambda ps, s: topt.Rprop(learning_rate=s, parameters=ps),
}


def _batch(seed=0, b=4, s=16):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, TINY["vocab_size"], (b, s)))
    lens = rng.integers(s // 2, s + 1, b)
    mask = torch.from_numpy((np.arange(s)[None] < lens[:, None])
                            .astype(np.float32))
    return ids, torch.zeros_like(ids), mask, torch.from_numpy(
        rng.integers(0, 2, b))


def _build(opt_name, seed):
    model = BertForSequenceClassification(
        BertConfig(**TINY), num_classes=2, device="cpu",
        generator=torch.Generator().manual_seed(seed))
    sched = topt.lr.LinearWarmup(
        topt.lr.PolynomialDecay(1e-2, decay_steps=8, end_lr=1e-3),
        warmup_steps=2, start_lr=0.0, end_lr=1e-2)
    opt = OPTIMIZERS[opt_name](model.parameters(), sched)
    return model, opt, sched, amp.GradScaler(init_loss_scaling=2.0 ** 10)


def _steps(model, opt, sched, scaler, n, batch):
    ids, seg, mask, labels = batch
    losses = []
    for _ in range(n):
        loss = PF.cross_entropy(model(ids, seg, attention_mask=mask), labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        sched.step()
        losses.append(loss.item())
    return losses


@pytest.mark.parametrize("how", ["save_state", "async_save"])
@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_resume_equals_an_unbroken_run_bit_for_bit(tmp_path, opt_name, how):
    batch = _batch()
    ptt.seed(7)
    model, opt, sched, scaler = _build(opt_name, 0)
    unbroken = _steps(model, opt, sched, scaler, 8, batch)
    final = {k: v.clone() for k, v in model.state_dict().items()}

    ptt.seed(7)
    model, opt, sched, scaler = _build(opt_name, 0)
    resumed = _steps(model, opt, sched, scaler, 4, batch)
    path = str(tmp_path / "ck")
    if how == "save_state":
        save_state(path, model=model, optimizer=opt, scaler=scaler, step=4)
    else:
        async_save(path, model=model, optimizer=opt, scaler=scaler,
                   step=4).wait_until_finished()
    model, opt, sched, scaler = _build(opt_name, 1)
    scaler.set_init_loss_scaling(3.0)
    ptt.seed(99)
    ids_before = [id(p) for p in model.parameters()]
    meta = load_state(path, model=model, optimizer=opt, scaler=scaler)
    assert meta["step"] == 4 and opt._step_count == 4
    assert [id(p) for p in model.parameters()] == ids_before
    resumed += _steps(model, opt, sched, scaler, 4, batch)
    assert resumed == unbroken
    for k, v in model.state_dict().items():
        assert torch.equal(v, final[k]), k


def test_the_loaded_state_equals_the_saved_state(tmp_path):
    """Parameters, slots, the scaler's scale and counters, the rate, the
    step and the random state, bit for bit, right after the load."""
    batch = _batch(1)
    ptt.seed(3)
    model, opt, sched, scaler = _build("AdamW", 0)
    _steps(model, opt, sched, scaler, 3, batch)
    save_state(str(tmp_path / "ck"), model=model, optimizer=opt,
               scaler=scaler, step=3, extra={"epoch": 2})
    saved = dict(params={k: v.clone() for k, v in model.state_dict().items()},
                 slots={k: v.clone() for k, v in opt.state_dict().items()
                        if isinstance(v, torch.Tensor)},
                 scaler=scaler.state_dict(), lr=opt.get_lr(),
                 step=opt._step_count, rng=ptt.get_rng_state())
    draw = torch.rand(5)
    model, opt, sched, scaler = _build("AdamW", 5)
    ptt.seed(11)
    meta = load_state(str(tmp_path / "ck"), model=model, optimizer=opt,
                      scaler=scaler)
    assert meta["extra"] == {"epoch": 2}
    assert all(torch.equal(v, saved["params"][k])
               for k, v in model.state_dict().items())
    slots = {k: v for k, v in opt.state_dict().items()
             if isinstance(v, torch.Tensor)}
    assert set(slots) == set(saved["slots"])
    assert all(torch.equal(v, saved["slots"][k]) for k, v in slots.items())
    assert scaler.state_dict() == saved["scaler"]
    assert opt.get_lr() == saved["lr"] and opt._step_count == saved["step"]
    st = ptt.get_rng_state()
    assert torch.equal(st["cpu"], saved["rng"]["cpu"])
    assert st["seed"] == saved["rng"]["seed"] == 3
    assert torch.equal(torch.rand(5), draw)


def _mlp_pair(seed=0):
    pt.seed(seed)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tm = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                             torch.nn.Linear(16, 4))
    with torch.no_grad():
        for (_, jp), (_, tp) in zip(jm.named_parameters(),
                                    tm.named_parameters()):
            a = np.asarray(jp._array)
            tp.copy_(torch.from_numpy((a.T if a.ndim == 2 else a).copy()))
    return jm, tm


def _jax_sched():
    return pt.optimizer.lr.LinearWarmup(
        pt.optimizer.lr.StepDecay(1e-2, step_size=2, gamma=0.5),
        warmup_steps=2, start_lr=0.0, end_lr=1e-2)


def _torch_sched():
    return topt.lr.LinearWarmup(topt.lr.StepDecay(1e-2, step_size=2,
                                                  gamma=0.5),
                                warmup_steps=2, start_lr=0.0, end_lr=1e-2)


def test_slots_after_a_resumed_run_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.standard_normal((16, 4)).astype(np.float32)
    jm, tm = _mlp_pair()

    js = _jax_sched()
    jopt = pt.optimizer.AdamW(learning_rate=js, parameters=jm.parameters())
    for _ in range(8):
        loss = ((jm(pt.to_tensor(x)) - pt.to_tensor(y)) ** 2).mean()
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        js.step()

    def torch_steps(model, opt, sched, n):
        for _ in range(n):
            loss = ((model(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2
                    ).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()

    ts = _torch_sched()
    topt_ = topt.AdamW(learning_rate=ts, parameters=tm.parameters())
    torch_steps(tm, topt_, ts, 4)
    save_state(str(tmp_path / "ck"), model=tm, optimizer=topt_, step=4)
    _, tm2 = _mlp_pair(seed=1)
    ts2 = _torch_sched()
    topt2 = topt.AdamW(learning_rate=ts2, parameters=tm2.parameters())
    load_state(str(tmp_path / "ck"), model=tm2, optimizer=topt2)
    torch_steps(tm2, topt2, ts2, 4)

    jstate = jopt.state_dict()
    tstate = topt2.state_dict()
    # the checkpoint named the slots after the model, as the JAX
    # package's are: "0.weight/moment1", ...
    assert set(tstate) == set(jstate)
    for name in jopt._param_names:
        for slot in ("moment1", "moment2"):
            j = np.asarray(jstate[f"{name}/{slot}"]._array)
            t = tstate[f"{name}/{slot}"].numpy()
            np.testing.assert_allclose(t, j.T if j.ndim == 2 else j, **TOL)
    for (_, jp), (_, tp) in zip(jm.named_parameters(),
                                tm2.named_parameters()):
        a = np.asarray(jp._array)
        np.testing.assert_allclose(tp.detach().numpy(),
                                   a.T if a.ndim == 2 else a, **TOL)
    assert tstate["step"] == jstate["step"] == 8


def test_meta_keys_equal_the_jax_packages(tmp_path):
    jm, tm = _mlp_pair()
    jopt = pt.optimizer.AdamW(learning_rate=_jax_sched(),
                              parameters=jm.parameters())
    topt_ = topt.AdamW(learning_rate=_torch_sched(),
                       parameters=tm.parameters())
    kw = dict(step=5, extra={"epoch": 1})
    pt.save_state(str(tmp_path / "j"), model=jm, optimizer=jopt,
                  scaler=pt.amp.GradScaler(), **kw)
    save_state(str(tmp_path / "t"), model=tm, optimizer=topt_,
               scaler=amp.GradScaler(), **kw)
    with open(tmp_path / "j" / "meta.json") as f:
        jmeta = json.load(f)
    with open(tmp_path / "t" / "meta.json") as f:
        tmeta = json.load(f)
    assert set(tmeta) == set(jmeta) == {"step", "optimizer", "scaler",
                                        "rng_seed", "extra",
                                        "commit_token"}
    assert set(tmeta["optimizer"]) == set(jmeta["optimizer"])
    assert set(tmeta["optimizer"]["LR_Scheduler"]) == \
        set(jmeta["optimizer"]["LR_Scheduler"])
    assert set(tmeta["scaler"]) == set(jmeta["scaler"])
    assert tmeta["step"] == jmeta["step"] == 5
    assert tmeta["extra"] == jmeta["extra"]
    assert len(tmeta["commit_token"]) == len(jmeta["commit_token"]) == 32


# ------------------------------------------------------ CheckpointError
def _saved(tmp_path):
    model = torch.nn.Linear(4, 2)
    opt = topt.Adam(parameters=model.parameters())
    model(torch.ones(1, 4)).sum().backward()
    opt.step()
    path = str(tmp_path / "ck")
    save_state(path, model=model, optimizer=opt, step=1)
    return path, model, opt


def _damage(path, case):
    if case == "empty":
        for f in os.listdir(path):
            os.unlink(os.path.join(path, f))
    elif case == "missing_arrays":
        os.unlink(os.path.join(path, "arrays.pt"))
    elif case == "orphaned_tmp":
        os.replace(os.path.join(path, "meta.json"),
                   os.path.join(path, "meta.json.tmp"))
    elif case == "inconsistent_token":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        meta["commit_token"] = "00" * 16
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
    else:
        chaos.corrupt_checkpoint(path, case)


# case -> (the half CheckpointError names, a fragment of its message)
CASES = {
    "empty": ("meta", "empty or partial"),
    "missing_arrays": ("arrays", "arrays.pt is missing"),
    "orphaned_tmp": ("meta", "meta.json.tmp"),
    "corrupt_meta": ("meta", "unreadable"),
    "truncate_meta": ("meta", "unreadable"),
    "delete_meta": ("meta", "meta.json is missing"),
    "delete_arrays": ("arrays", "arrays.pt is missing"),
    "truncate_arrays": ("arrays", "failed to load"),
    "inconsistent_token": (None, "inconsistent"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_damaged_checkpoint_raises_before_changing_anything(tmp_path,
                                                              case):
    path, _, _ = _saved(tmp_path)
    _damage(path, case)
    fresh = torch.nn.Linear(4, 2)
    fopt = topt.Adam(parameters=fresh.parameters())
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    missing, fragment = CASES[case]
    with pytest.raises(CheckpointError, match=fragment) as ei:
        load_state(path, model=fresh, optimizer=fopt)
    assert ei.value.missing == missing and ei.value.path == path
    assert all(torch.equal(v, before[k])
               for k, v in fresh.state_dict().items())
    assert fopt._step_count == 0


@pytest.mark.parametrize("case", ["empty", "missing_arrays",
                                  "orphaned_tmp"])
def test_checkpoint_error_names_the_half_the_jax_package_names(tmp_path,
                                                               case):
    """The same hand-made partial directories (an empty one, a meta.json
    with no arrays, an orphaned meta.json.tmp) fail on the same half in
    both packages."""
    from paddle_tpu.framework.checkpoint import CheckpointError as JaxError
    from paddle_tpu.framework.checkpoint import load_state as jax_load
    got = {}
    for lib, load, err in (("jax", jax_load, JaxError),
                           ("torch", load_state, CheckpointError)):
        d = tmp_path / lib
        d.mkdir()
        if case == "missing_arrays":
            (d / "meta.json").write_text("{}")
        elif case == "orphaned_tmp":
            (d / "meta.json.tmp").write_text("{}")
        with pytest.raises(err) as ei:
            load(str(d))
        got[lib] = (ei.value.missing, "meta.json.tmp" in str(ei.value))
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("what", ["model_shape", "model_key",
                                  "optimizer_slot", "scaler", "no_model"])
def test_a_checkpoint_that_does_not_fit_raises(tmp_path, what):
    path, model, opt = _saved(tmp_path)
    if what == "no_model":
        save_state(path, optimizer=opt, step=1)
    target = {"model_shape": torch.nn.Linear(4, 3),
              "model_key": torch.nn.Sequential(torch.nn.Linear(4, 2))}.get(
        what, torch.nn.Linear(4, 2))
    topt_ = topt.Adam(parameters=target.parameters())
    if what == "optimizer_slot":
        topt_ = topt.Momentum(parameters=target.parameters())
    before = {k: v.clone() for k, v in target.state_dict().items()}
    kw = dict(model=target, optimizer=topt_)
    if what == "scaler":
        kw["scaler"] = amp.GradScaler()
    with pytest.raises(CheckpointError, match="does not fit") as ei:
        load_state(path, **kw)
    assert ei.value.missing == "arrays"
    assert all(torch.equal(v, before[k])
               for k, v in target.state_dict().items())


def test_save_state_replaces_a_stale_stage(tmp_path):
    path, model, _ = _saved(tmp_path)
    stale = os.path.join(path, "meta.json.tmp")
    with open(stale, "w") as f:
        f.write("{stale}")
    save_state(path, model=model)
    assert not os.path.exists(stale)
    assert probe(path)["step"] == 0
    load_state(path, model=model)


def test_a_crash_between_arrays_and_meta_keeps_the_old_checkpoint(tmp_path):
    """Overwriting a checkpoint: crashed after the arrays committed, the
    old meta no longer pairs with the new arrays, and the load says so."""
    path, model, opt = _saved(tmp_path)
    with chaos.scoped("ckpt.crash_after_arrays@1"):
        with pytest.raises(chaos.ChaosInterrupt):
            save_state(path, model=model, optimizer=opt, step=2)
    with pytest.raises(CheckpointError, match="orphaned meta.json.tmp"):
        load_state(path, model=model, optimizer=opt)
    save_state(path, model=model, optimizer=opt, step=2)
    assert load_state(path, model=model, optimizer=opt)["step"] == 2


def test_an_async_save_is_not_torn_by_the_next_step(tmp_path, monkeypatch):
    """The host copies are made before async_save returns: the next
    step's in-place update of the parameters and the slots (which
    `state_dict` hands out without a copy) does not reach the file, even
    while the write is still running."""
    import threading
    gate = threading.Event()
    write = ck._write_arrays

    def slow_write(arrays, path):
        gate.wait(timeout=60)
        write(arrays, path)

    monkeypatch.setattr(ck, "_write_arrays", slow_write)
    batch = _batch(2)
    ptt.seed(5)
    model, opt, sched, scaler = _build("AdamW", 0)
    _steps(model, opt, sched, scaler, 2, batch)
    want_p = {k: v.clone() for k, v in model.state_dict().items()}
    want_s = [v.clone() for v in opt.state_dict().values()
              if isinstance(v, torch.Tensor)]
    handle = async_save(str(tmp_path / "ck"), model=model, optimizer=opt,
                        step=2)
    _steps(model, opt, sched, scaler, 1, batch)      # updates in place
    assert not torch.equal(next(model.parameters()),
                           want_p[next(iter(want_p))])
    gate.set()
    handle.wait_until_finished()
    fresh, fopt, _, _ = _build("AdamW", 9)
    load_state(str(tmp_path / "ck"), model=fresh, optimizer=fopt)
    assert all(torch.equal(v, want_p[k])
               for k, v in fresh.state_dict().items())
    got_s = [v for v in fopt.state_dict().values()
             if isinstance(v, torch.Tensor)]
    assert len(got_s) == len(want_s)
    assert all(torch.equal(a, b) for a, b in zip(got_s, want_s))


def test_an_async_write_that_fails_publishes_nothing(tmp_path, monkeypatch):
    def broken(arrays, path):
        raise OSError("disk full")

    path, model, _ = _saved(tmp_path)
    monkeypatch.setattr(ck, "_write_arrays", broken)
    handle = async_save(str(tmp_path / "b"), model=model)
    with pytest.raises(OSError, match="disk full"):
        handle.wait_until_finished()
    assert not os.path.exists(tmp_path / "b" / "meta.json")


def test_rng_and_scheduler_are_restored(tmp_path):
    """As tests/test_checkpoint.py's test_rng_restored and
    test_lr_scheduler_in_checkpoint: the draws after a load repeat the
    draws after the save, and the scheduler resumes its rate."""
    model = torch.nn.Linear(4, 4)
    sched = topt.lr.StepDecay(learning_rate=0.1, step_size=2)
    opt = topt.SGD(learning_rate=sched, parameters=model.parameters())
    for _ in range(5):
        sched.step()
    ptt.seed(42)
    save_state(str(tmp_path / "ck"), model=model, optimizer=opt)
    r1 = torch.randn(4)
    ptt.seed(7)
    sched2 = topt.lr.StepDecay(learning_rate=0.1, step_size=2)
    opt2 = topt.SGD(learning_rate=sched2,
                    parameters=torch.nn.Linear(4, 4).parameters())
    load_state(str(tmp_path / "ck"), optimizer=opt2)
    assert torch.equal(torch.randn(4), r1)
    assert sched2.get_lr() == pytest.approx(sched.get_lr())
    assert sched2.last_epoch == sched.last_epoch == 5
