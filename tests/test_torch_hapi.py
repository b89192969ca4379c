"""The port's `Model` (hapi) and callbacks against the JAX package's, on
the CPU.

Two networks, each built in the JAX package from a seed and carried into
the port (`load_paddle_tpu_state`): a 2-layer BERT classifier in a user
Layer whose forward(ids, mask) passes the padding mask, and a small
Conv2D + Linear classifier built from `nn` in both packages.  The same
datasets (numpy, from a seed) go through `Model.prepare(opt,
CrossEntropyLoss, Accuracy)`, `fit` with `shuffle=True` under one
`np.random` seed (two epochs, evaluation each epoch), `evaluate` and
`predict`: the loss of every step (`log_freq=1`), the epoch history, the
evaluation's loss and accuracy, and the predictions agree.

Tolerances (float32, the same formulas summed in another order): step
losses rtol 1e-5 / atol 1e-6 and accuracies equal, as in
`test_torch_bert.py`; after training, evaluation losses and
predictions within 1e-4 (AdamW and Momentum amplify rounding noise of
near-zero gradients into parameter steps of ~1e-3 x lr, see
`test_torch_gpt_training.py`).  The port's training loader runs in
worker processes in one case (`num_workers=2`) and in-process in the
others.

Then, each as the reference: `prepare` keeps `amp_configs` and ignores
them; `save(training=False)` raises ValueError (`jit.save` without an
`input_spec`); `save` / `load` round trips the training state, with
`skip_mismatch` and `reset_optimizer`; `train_batch` / `eval_batch` /
`predict_batch`; `summary`; `EarlyStopping` stops and `ModelCheckpoint`
writes its directories; `LRScheduler` steps the schedule; `MetricsLogger`
adds its percentiles, throughput and loader wait to the history and
exports a Chrome trace; `ResilienceCallback` saves every N steps and
resumes a relaunched fit.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import torch_io_data as data
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertForSequenceClassification as JaxBertCls
from paddle_tpu_torch import io, metric, nn
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW, Momentum
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.text import BertConfig, BertForSequenceClassification
from paddle_tpu_torch.weights import load_paddle_tpu_state

BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
OUT_TOL = dict(rtol=1e-4, atol=1e-4)


class _JaxBert(pt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.bert = JaxBertCls(JaxBertConfig(**BERT), num_classes=2)

    def forward(self, ids, mask):
        return self.bert(ids, attention_mask=mask)


class _Bert(nn.Layer):
    def __init__(self):
        super().__init__()
        self.bert = BertForSequenceClassification(
            BertConfig(**BERT), num_classes=2, device="cpu")

    def forward(self, ids, mask):
        return self.bert(ids, attention_mask=mask)


class _JaxConv(pt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = pt.nn.Conv2D(3, 4, 3, padding=1)
        self.fc = pt.nn.Linear(4 * 8 * 8, 3)

    def forward(self, x):
        y = pt.nn.functional.relu(self.conv(x))
        return self.fc(y.reshape([x.shape[0], -1]))


class _Conv(nn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2D(3, 4, 3, padding=1, device="cpu")
        self.fc = nn.Linear(4 * 8 * 8, 3, device="cpu")

    def forward(self, x):
        y = TF.relu(self.conv(x))
        return self.fc(y.reshape([x.shape[0], -1]))


def _pair(kind, seed=0):
    pt.seed(seed)
    jnet = _JaxBert() if kind == "bert" else _JaxConv()
    tnet = _Bert() if kind == "bert" else _Conv()
    load_paddle_tpu_state(tnet, {k: np.asarray(v)
                                 for k, v in jnet.state_dict().items()})
    return jnet, tnet


def _data(kind, n, seed, labels=True):
    if kind == "bert":
        return data.Sequences(n, 16, BERT["vocab_size"], seed, labels)
    return data.Images(n, seed=seed, labels=labels)


def _opts(kind, jnet, tnet):
    if kind == "bert":
        return (pt.optimizer.AdamW(learning_rate=1e-3,
                                   parameters=jnet.parameters()),
                AdamW(learning_rate=1e-3, parameters=tnet.parameters()))
    return (pt.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                  parameters=jnet.parameters()),
            Momentum(learning_rate=0.05, momentum=0.9,
                     parameters=tnet.parameters()))


def _loss_log(cb_mod):
    class LossLog(cb_mod.Callback):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
    return LossLog()


@pytest.mark.parametrize("kind,workers", [("bert", 0), ("bert", 2),
                                          ("conv", 0)])
def test_fit_evaluate_predict_match_jax(kind, workers):
    jnet, tnet = _pair(kind)
    jopt, topt = _opts(kind, jnet, tnet)
    jm = pt.Model(jnet).prepare(jopt, pt.nn.CrossEntropyLoss(),
                                pt.metric.Accuracy())
    tm = Model(tnet).prepare(topt, nn.CrossEntropyLoss(), metric.Accuracy())
    train, evals = _data(kind, 40, 1), _data(kind, 16, 2)
    tests = _data(kind, 16, 2, labels=False)
    jlog, tlog = _loss_log(jcb), _loss_log(tcb)
    np.random.seed(0)
    jhist = jm.fit(train, evals, batch_size=8, epochs=2, log_freq=1,
                   verbose=0, callbacks=[jlog])
    np.random.seed(0)
    loader = io.DataLoader(train, places="cpu", batch_size=8, shuffle=True,
                           num_workers=workers)
    thist = tm.fit(loader, evals, batch_size=8, epochs=2, log_freq=1,
                   verbose=0, callbacks=[tlog])
    assert len(tlog.losses) == len(jlog.losses) == 10
    np.testing.assert_allclose(tlog.losses, jlog.losses, **LOSS_TOL)
    for th, jh in zip(thist, jhist):
        assert set(th) == set(jh) == {"loss", "eval_loss", "eval_acc"}
        np.testing.assert_allclose(th["loss"], jh["loss"], **LOSS_TOL)
        np.testing.assert_allclose(th["eval_loss"], jh["eval_loss"],
                                   **OUT_TOL)
        assert th["eval_acc"] == jh["eval_acc"]
    tev, jev = tm.evaluate(evals, batch_size=8, verbose=0), \
        jm.evaluate(evals, batch_size=8, verbose=0)
    assert tev["acc"] == jev["acc"]
    np.testing.assert_allclose(tev["loss"], jev["loss"], **OUT_TOL)
    tp = tm.predict(tests, batch_size=8, stack_outputs=True)
    jp = jm.predict(tests, batch_size=8, stack_outputs=True)
    assert len(tp) == len(jp) == 1 and tp[0].shape == (16, jp[0].shape[1])
    np.testing.assert_allclose(tp[0], jp[0], **OUT_TOL)
    per_batch = tm.predict(tests, batch_size=8)
    assert len(per_batch) == 2 and isinstance(per_batch[0], np.ndarray)


def test_reference_behaviours_kept(tmp_path):
    """amp_configs are stored and ignored; save(training=False) raises
    ValueError, as jit.save without input_spec does in the reference."""
    jnet, tnet = _pair("conv")
    jopt, topt = _opts("conv", jnet, tnet)
    amp_cfg = {"level": "O2", "dtype": "bfloat16"}
    jm = pt.Model(jnet).prepare(jopt, pt.nn.CrossEntropyLoss(),
                                amp_configs=amp_cfg)
    tm = Model(tnet).prepare(topt, nn.CrossEntropyLoss(),
                             amp_configs=amp_cfg)
    assert tm._amp_configs == jm._amp_configs == amp_cfg
    x, y = _data("conv", 8, 3)[:8]
    assert tnet.conv.weight.dtype == torch.float32
    np.testing.assert_allclose(tm.train_batch([x], [y]),
                               jm.train_batch([x], [y]), **LOSS_TOL)
    for m in (tm, jm):
        with pytest.raises(ValueError, match="input_spec"):
            m.save(str(tmp_path / f"infer_{id(m)}"), training=False)
    assert tm.summary() == jm.summary() == {"total_params": 112 + 768 + 3}
    assert sum(p.numel() for p in tm.parameters()) == 883
    with pytest.raises(TypeError):
        tm.prepare(topt, nn.CrossEntropyLoss(), metrics=[object()])


def test_batch_api_save_load_skip_mismatch_and_reset(tmp_path):
    jnet, tnet = _pair("conv")
    jopt, topt = _opts("conv", jnet, tnet)
    tm = Model(tnet).prepare(topt, nn.CrossEntropyLoss(), metric.Accuracy())
    jm = pt.Model(jnet).prepare(jopt, pt.nn.CrossEntropyLoss(),
                                pt.metric.Accuracy())
    ds = _data("conv", 16, 4)
    x, y = ds.x[:8], ds.y[:8]
    for _ in range(2):
        np.testing.assert_allclose(tm.train_batch([x], [y]),
                                   jm.train_batch([x], [y]), **LOSS_TOL)
    tl, jl = tm.eval_batch([x], [y]), jm.eval_batch([x], [y])
    np.testing.assert_allclose(tl["loss"], jl["loss"], **OUT_TOL)
    np.testing.assert_allclose(tm.predict_batch([x]),
                               np.asarray(jm.predict_batch([x])), **OUT_TOL)
    tm.save(str(tmp_path / "ck"))
    fresh_net = _Conv()
    fresh_opt = Momentum(learning_rate=0.05, momentum=0.9,
                         parameters=fresh_net.parameters())
    fresh = Model(fresh_net).prepare(fresh_opt, nn.CrossEntropyLoss())
    fresh.load(str(tmp_path / "ck"))
    np.testing.assert_array_equal(fresh.predict_batch([x]),
                                  tm.predict_batch([x]))
    assert fresh_opt._step_count == topt._step_count == 2
    # a network whose head differs: skip_mismatch loads the rest
    other = _Conv()
    other.fc = nn.Linear(4 * 8 * 8, 5, device="cpu")
    head = other.fc.weight.detach().clone()
    om = Model(other).prepare(Momentum(learning_rate=0.05,
                                       parameters=other.parameters()),
                              nn.CrossEntropyLoss())
    om.load(str(tmp_path / "ck"), skip_mismatch=True, reset_optimizer=True)
    assert torch.equal(other.conv.weight, tnet.conv.weight)
    assert torch.equal(other.fc.weight, head)
    with pytest.raises(Exception):
        om.load(str(tmp_path / "ck"))


def test_callbacks(tmp_path):
    jnet, tnet = _pair("conv")
    sched = tlr.StepDecay(0.05, step_size=1, gamma=0.5)
    opt = Momentum(learning_rate=sched, momentum=0.9,
                   parameters=tnet.parameters())
    tm = Model(tnet).prepare(opt, nn.CrossEntropyLoss(), metric.Accuracy())
    train, evals = _data("conv", 32, 5), _data("conv", 16, 6)
    trace = tmp_path / "trace.json"
    stop = tcb.EarlyStopping(monitor="acc", mode="max", patience=0,
                             baseline=1.1, save_best_model=False)
    hist = tm.fit(train, evals, batch_size=8, epochs=4, log_freq=2,
                  verbose=0, save_dir=str(tmp_path / "ck"),
                  callbacks=[tcb.MetricsLogger(batch_size=8,
                                               trace_path=str(trace)),
                             tcb.LRScheduler(by_step=True), stop])
    assert len(hist) == 1 and tm.stop_training     # stopped after epoch 1
    assert sorted(os.listdir(tmp_path / "ck")) == ["0", "final"]
    assert opt.get_lr() == 0.05 * 0.5 ** 4         # stepped each batch
    logs = hist[0]
    for key in ("step_time_p50", "step_time_p99", "steps_per_s",
                "samples_per_s", "data_wait_p50", "data_wait_share"):
        assert key in logs and np.isfinite(logs[key]), key
    assert 0.0 <= logs["data_wait_share"] <= 1.0
    events = json.loads(trace.read_text())["traceEvents"]
    assert sum(e.get("name") == "train_step" for e in events) == 4
    from paddle_tpu_torch import observability as obs
    assert not obs.enabled()                       # released after fit
    # the reference's names and hooks
    assert set(tcb.__all__) == set(jcb.__all__)
    from paddle_tpu_torch import callbacks
    assert callbacks.EarlyStopping is tcb.EarlyStopping


def test_resilience_callback_saves_and_resumes(tmp_path):
    from paddle_tpu_torch.resilience import CheckpointManager

    def fresh():
        _, net = _pair("conv")
        opt = Momentum(learning_rate=0.05, momentum=0.9,
                       parameters=net.parameters())
        return Model(net).prepare(opt, nn.CrossEntropyLoss()), opt

    train = _data("conv", 32, 7)
    m, opt = fresh()
    mgr = CheckpointManager(str(tmp_path / "r"), max_to_keep=2)
    cb = tcb.ResilienceCallback(manager=mgr, save_every_steps=2,
                                handle_sigterm=False, async_save=False)
    np.random.seed(1)
    m.fit(train, batch_size=8, epochs=1, verbose=0, callbacks=[cb])
    assert mgr.all_steps() == [2, 4]
    m2, opt2 = fresh()
    cb2 = tcb.ResilienceCallback(manager=mgr, save_every_steps=0,
                                 handle_sigterm=False, async_save=False)
    m2._ensure_train_step()
    cb2.set_model(m2)
    cb2.on_train_begin()
    assert opt2._step_count == 4
    for a, b in zip(m.network.parameters(), m2.network.parameters()):
        assert torch.equal(a, b)
