"""The port's serving tier against the JAX package, on the CPU.

The router, framed transport and worker processes of
`paddle_tpu_torch.serving`, their helpers (`resilience.backoff`,
`distributed.launch.heartbeat`) and the five `serving.*` chaos sites,
held against `paddle_tpu.serving` on the JAX drills' tiny GPT (vocab 64,
hidden 32, 2 layers, 4 heads; the JAX package's weights from seed 0,
carried into the port by `load_paddle_tpu_state`):

* transport: the same bytes from `encode`, the same frames from any
  split of the wire, the same verdict on torn, oversized, undersized and
  garbage frames; the RPC timeout policy counts and raises; remote
  refusals come back as the engine's own exceptions;
* helpers: Backoff delays, CrashLoopDetector verdicts, BeatWatch
  staleness and spawn grace equal under the same clock;
* drills (`tools/torch_chaos_check.py`, run through each package's own
  classes): --serving and the in-process --router give equal tokens and
  equal counters in both packages, equal to the JAX package's
  `generate()`.

The worker processes and the --router --proc drill are in
`test_torch_serving_workers.py`.  Tolerances: tokens, counters and bytes
exact.
"""
import io
import os
import socket
import struct
import time
import types

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.distributed.launch import heartbeat as jax_hb
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.resilience import backoff as jax_backoff
from paddle_tpu.resilience import chaos as jax_chaos
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import Router as JaxRouter
from paddle_tpu.serving import ShedRequest as JaxShed
from paddle_tpu.serving import transport as jax_tr
from paddle_tpu.serving import worker as jax_sw
from paddle_tpu.text import GPTConfig as JaxGPTConfig
from paddle_tpu.text import GPTForCausalLM as JaxGPT
from paddle_tpu.text.generation import generate as jax_generate
from paddle_tpu_torch.distributed.launch import heartbeat as hb
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.resilience import backoff, chaos
from paddle_tpu_torch.serving import PoolExhausted, ReplicaGone, ShedRequest
from paddle_tpu_torch.serving import transport as tr
from paddle_tpu_torch.serving import worker as sw
from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.weights import load_paddle_tpu_state
from tools import torch_chaos_check as tcc


# ===================================================================
# models and kits
# ===================================================================
@pytest.fixture(scope="module")
def pair():
    """The JAX drills' GPT (seed 0) and the port's GPT on its weights."""
    pt.seed(0)
    jm = JaxGPT(JaxGPTConfig(tensor_parallel=False, **tcc.TINY))
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(**tcc.TINY), device="cpu")
    load_paddle_tpu_state(tm, arrays)
    return jm, tm.eval(), arrays


def jax_kit():
    return types.SimpleNamespace(LLMEngine=JaxEngine, Router=JaxRouter,
                                 ShedRequest=JaxShed,
                                 Backoff=jax_backoff.Backoff,
                                 chaos=jax_chaos,
                                 registry=jax_metrics.registry)


def jax_reference(jm):
    def reference(prompts, n):
        # bucketed (prompts padded to 16): token-identical to the plain
        # loop in the JAX package, and one compile instead of one a length
        return [jax_generate(jm, pt.to_tensor(np.asarray([p], "int64")),
                             max_new_tokens=n, shape_buckets=[16])
                .numpy()[0, len(p):].tolist() for p in prompts]
    return reference


# ===================================================================
# transport: the same bytes and verdicts in both packages
# ===================================================================
def _messages(rng, n=40):
    """Stream events, step summaries and replies, interleaved as on the
    real wire."""
    out = []
    for i in range(n):
        k = rng.randint(5)
        if k == 0:
            out.append({"ev": "tok", "rid": int(rng.randint(8)),
                        "tok": int(rng.randint(50304))})
        elif k == 1:
            out.append({"ev": "fin", "rid": int(rng.randint(8)),
                        "reason": "length"})
        elif k == 2:
            out.append({"ev": "step",
                        "summary": {"decoded": int(rng.randint(8)),
                                    "admitted": 0, "prefilled": 3},
                        "gauges": [int(rng.randint(9)), 0, 24]})
        elif k == 3:
            out.append({"reply": "add_request", "rid": i, "ok": True,
                        "gauges": [0, 1, 23]})
        else:
            out.append({"cmd": "add_request", "rid": i,
                        "prompt": rng.randint(64, size=5).tolist(),
                        "max_new_tokens": 8, "resume_tokens": None,
                        "params": {"temperature": 0.9, "top_p": None}})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_encode_gives_the_jax_bytes(seed):
    for m in _messages(np.random.RandomState(seed)):
        assert tr.encode(m) == jax_tr.encode(m)
    assert tr.MAX_FRAME == jax_tr.MAX_FRAME


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_split_points_give_the_same_frames(seed):
    rng = np.random.RandomState(seed)
    msgs = _messages(rng)
    blob = b"".join(tr.encode(m) for m in msgs)
    ours, theirs = tr.FrameDecoder(), jax_tr.FrameDecoder()
    got, ref = [], []
    i = 0
    while i < len(blob):
        j = i + int(rng.randint(1, 9))      # torn anywhere
        got += ours.feed(blob[i:j])
        ref += theirs.feed(blob[i:j])
        assert ours.pending == theirs.pending
        i = j
    assert got == ref == msgs
    ours.close()
    theirs.close()


def _verdict(decoder_cls, chunks, close=False):
    dec = decoder_cls(max_frame=64)
    frames = []
    try:
        for c in chunks:
            frames += dec.feed(c)
        if close:
            dec.close()
    except RuntimeError as e:
        return frames, type(e).__name__, str(e)
    return frames, None, None


FRAME_CASES = {
    "torn": ([jax_tr.encode({"ev": "tok", "tok": 1}),
              jax_tr.encode({"a": 1})[:-2]], True),
    "oversized": ([struct.pack("!I", 65)], False),
    "undersized": ([struct.pack("!I", 1) + b"{"], False),
    "garbage": ([struct.pack("!I", 4) + b"\xff\xfe\x00\x01"], False),
    "not_json": ([struct.pack("!I", 3) + b"{{}"], False),
    "clean_eof": ([jax_tr.encode({"x": [1, 2]})], True),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_frame_verdicts_match_jax(case):
    chunks, close = FRAME_CASES[case]
    ours = _verdict(tr.FrameDecoder, chunks, close)
    theirs = _verdict(jax_tr.FrameDecoder, chunks, close)
    assert ours == theirs
    assert (ours[1] is None) == (case == "clean_eof")


def test_sender_refuses_what_the_receiver_rejects():
    for mod in (tr, jax_tr):
        with pytest.raises(mod.FrameError, match="too large"):
            mod.encode({"pad": "x" * 128}, max_frame=64)


def test_channel_interleaving_eof_and_drop_site():
    a, b = socket.socketpair()
    parent, worker = tr.Channel(a, "r9"), tr.Channel(b, "w")
    seq = [{"ev": "tok", "rid": 0, "tok": 1},
           {"reply": "add_request", "rid": 1, "ok": True},
           {"ev": "tok", "rid": 0, "tok": 2}]
    for m in seq:
        worker.send(m)
    with chaos.scoped("serving.transport_drop@3#r9"):
        assert [parent.recv(timeout=5.0) for _ in seq[:2]] == seq[:2]
        with pytest.raises(tr.FrameError, match="transport_drop"):
            parent.recv(timeout=5.0)         # frame 3 dropped in transit
    worker.send({"ev": "fin", "rid": 0, "reason": "length"})
    assert parent.recv(timeout=5.0)["ev"] == "fin"
    assert parent.poll() is None
    worker.close()
    with pytest.raises(tr.ChannelClosed):
        parent.recv(timeout=5.0)
    parent.close()
    with pytest.raises(tr.ChannelClosed):
        parent.send({"x": 1})


class _SilentProc:
    """A worker that is alive and never answers."""
    pid = 0

    @staticmethod
    def poll():
        return None


def _silent_replica(mod, tmod):
    a, b = socket.socketpair()
    pr = object.__new__(mod.ProcReplica)
    pr.name = "silent"
    pr.ch = tmod.Channel(a, "silent")
    pr.proc = _SilentProc()
    pr.policy = tmod.TransportPolicy(timeout=0.05, retries=1,
                                     backoff_base=0.0)
    pr._pending_reply = None
    pr._reqs = {}
    pr._gauges = (0, 0, 0)
    pr._summary = None
    pr._exit_noted = False
    return pr, b


@pytest.mark.parametrize("which", ["port", "jax"])
def test_rpc_timeout_policy_counts_and_raises(which):
    mod, reg_mod, tmod = ((sw, metrics, tr) if which == "port"
                          else (jax_sw, jax_metrics, jax_tr))
    reg = reg_mod.registry()
    base = reg.counter("router_transport_timeouts_total").value
    pr, peer = _silent_replica(mod, tmod)
    t0 = time.monotonic()
    with pytest.raises(tmod.TransportTimeout, match="no reply"):
        pr._rpc("metrics_snapshot")
    # two attempts (retries + 1), each counted, and no wedge
    assert reg.counter("router_transport_timeouts_total").value - base == 2
    assert time.monotonic() - t0 < 5.0
    pr.ch.close()
    peer.close()


@pytest.mark.parametrize("err", [
    {"kind": "ShedRequest", "reason": "queue_depth",
     "detail": {"queue_depth": 5, "watermark": 2}},
    {"kind": "PoolExhausted", "message": "needs 9 blocks"},
    {"kind": "ValueError", "message": "nothing left to generate"},
    {"kind": "RuntimeError", "message": "engine is closed"},
])
def test_raise_remote_rebuilds_the_engine_exceptions(err):
    ours = theirs = None
    try:
        sw._raise_remote(err)
    except Exception as e:          # noqa: BLE001 (compared below)
        ours = e
    try:
        jax_sw._raise_remote(err)
    except Exception as e:          # noqa: BLE001
        theirs = e
    assert type(ours).__name__ == type(theirs).__name__
    assert str(ours) == str(theirs)
    expect = {"ShedRequest": ShedRequest, "PoolExhausted": PoolExhausted,
              "ValueError": ValueError,
              "RuntimeError": ReplicaGone}[err["kind"]]
    assert isinstance(ours, expect)
    if err["kind"] == "ShedRequest":
        assert (ours.reason, ours.detail) == (theirs.reason, theirs.detail)


def test_policy_from_env_matches_jax(monkeypatch):
    for env in ({}, {"PADDLE_TPU_TRANSPORT_TIMEOUT": "2.5",
                     "PADDLE_TPU_TRANSPORT_RETRIES": "3",
                     "PADDLE_TPU_TRANSPORT_BACKOFF": "0.2"}):
        for k in ("PADDLE_TPU_TRANSPORT_TIMEOUT",
                  "PADDLE_TPU_TRANSPORT_RETRIES",
                  "PADDLE_TPU_TRANSPORT_BACKOFF"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        ours, theirs = tr.policy_from_env(), jax_tr.policy_from_env()
        assert (ours.timeout, ours.retries) == \
            (theirs.timeout, theirs.retries)
        assert [ours.backoff.delay(k) for k in range(6)] == \
            [theirs.backoff.delay(k) for k in range(6)]


# ===================================================================
# helpers: the same answers under the same clock
# ===================================================================
@pytest.mark.parametrize("kw", [
    {}, {"base": 0.05, "factor": 2.0, "max_delay": 0.2},
    {"base": 0.5, "factor": 3.0, "max_delay": 30.0},
    {"base": 0.0}, {"base": 1.0, "factor": 1.0, "max_delay": 0.5}])
def test_backoff_delays_match_jax(kw):
    slept, jslept = [], []
    ours = backoff.Backoff(sleep=slept.append, **kw)
    theirs = jax_backoff.Backoff(sleep=jslept.append, **kw)
    assert [ours.delay(k) for k in range(12)] == \
        [theirs.delay(k) for k in range(12)]
    assert [ours.wait(k) for k in range(4)] == \
        [theirs.wait(k) for k in range(4)]
    assert slept == jslept


@pytest.mark.parametrize("threshold,window", [(3, 60.0), (2, 5.0),
                                              (0, 10.0), (4, 1.0)])
def test_crash_loop_verdicts_match_jax(threshold, window):
    clock = {"t": 0.0}
    ours = backoff.CrashLoopDetector(threshold, window,
                                     clock=lambda: clock["t"])
    theirs = jax_backoff.CrashLoopDetector(threshold, window,
                                           clock=lambda: clock["t"])
    verdicts = []
    for dt in (0.0, 0.4, 0.7, 6.0, 0.1, 0.1, 30.0, 31.0, 0.5, 0.2, 0.2):
        clock["t"] += dt
        v = ours.record_failure()
        assert v == theirs.record_failure()
        assert ours.recent_failures == theirs.recent_failures
        verdicts.append(v)
    assert any(verdicts) == (threshold > 0)


def _beat_script(tmp_path, mod, leftover):
    """Staleness verdicts of one BeatWatch through a fixed sequence of
    clock steps and beats (a beat sets the file's mtime to a new value)."""
    clock = {"t": 100.0}
    path = str(tmp_path / f"hb_{mod.__name__}_{leftover}")
    if leftover:
        with open(path, "w"):
            pass                      # a dead predecessor's file
    w = mod.BeatWatch(path, timeout=5.0, grace=30.0,
                      clock=lambda: clock["t"])
    out = [w.grace]
    mtime = 1000
    for step in (20.0, "beat", 4.0, 2.0, "beat", 11.0, 6.0, "beat",
                 0.5, 4.9, 0.2):
        if step == "beat":
            mtime += 1
            with open(path, "a"):
                pass
            os.utime(path, (mtime, mtime))
        else:
            clock["t"] += step
        out.append((w.stale(), round(w.silent_for, 6)))
    return out


@pytest.mark.parametrize("leftover", [False, True])
def test_beatwatch_staleness_and_grace_match_jax(tmp_path, leftover):
    ours = _beat_script(tmp_path, hb, leftover)
    theirs = _beat_script(tmp_path, jax_hb, leftover)
    assert ours == theirs
    # inside the grace before the first beat, stale 6 s after a beat
    assert ours[1][0] is False and True in [v for v, _ in ours[2:]]


def test_beatwatch_default_grace_and_grace_expiry(tmp_path):
    clock = {"t": 0.0}
    w = hb.BeatWatch(str(tmp_path / "none"), timeout=5.0,
                     clock=lambda: clock["t"])
    assert w.grace == 5.0
    clock["t"] = 5.5
    assert w.stale()                  # no grace past the timeout
    g = hb.BeatWatch(str(tmp_path / "none"), timeout=5.0, grace=30.0,
                     clock=lambda: clock["t"])
    clock["t"] += 29.0
    assert not g.stale()
    clock["t"] += 1.5
    assert g.stale()                  # a start that never beats is hung


def test_heartbeat_thread_mode_beats_until_stopped(tmp_path):
    path = str(tmp_path / "hb")
    beat = hb.Heartbeat(path, interval=0.02).start()
    assert os.path.exists(path)       # the first beat is synchronous
    first = os.stat(path).st_mtime_ns
    deadline = time.monotonic() + 5.0
    while os.stat(path).st_mtime_ns == first:
        assert time.monotonic() < deadline, "the thread never beat"
        time.sleep(0.01)
    beat.stop()
    beat._thread.join(timeout=5.0)
    assert not beat._thread.is_alive()


# ===================================================================
# engine-side chaos sites and the --serving drill
# ===================================================================
@pytest.fixture(scope="module")
def serving_drills(pair):
    jm, tm, _ = pair
    ours = tcc.run_serving(tm, tcc.port_reference(tm))
    theirs = tcc.run_serving(jm, jax_reference(jm), kit=jax_kit())
    return ours, theirs


def test_serving_drill_is_green_in_both(serving_drills):
    ours, theirs = serving_drills
    assert theirs["failures"] == []
    assert ours["failures"] == []


def test_serving_drill_tokens_match_jax(serving_drills, pair):
    ours, theirs = serving_drills
    assert ours["streams"] == theirs["streams"]
    assert ours["finish"] == theirs["finish"]
    # the survivors are JAX generate()'s tokens
    prompts = tcc.drill_prompts(7, tcc.SERVING_LENS)
    refs = jax_reference(pair[0])(prompts, 8)
    for i, (s, r) in enumerate(zip(ours["streams"], refs)):
        if i != 2:
            assert s == r


def test_serving_drill_poison_fails_alone_with_jax_reason(serving_drills):
    ours, theirs = serving_drills
    assert ours["poisoned"] == theirs["poisoned"] == [2]
    assert ours["finish"][2] == theirs["finish"][2] == "error"
    assert [f for i, f in enumerate(ours["finish"]) if i != 2] == \
        ["length"] * 7


def test_serving_drill_counters_and_leaks_match_jax(serving_drills):
    ours, theirs = serving_drills
    assert ours["counters"] == theirs["counters"]
    assert ours["leaks"] == theirs["leaks"] == ([], [])
    assert ours["free_blocks"] == theirs["free_blocks"] == 7


def test_pool_exhausted_site_refuses_then_recovers():
    from paddle_tpu_torch.serving import BlockPool
    pool = BlockPool(1, 4, 4, 2, 8, device="cpu")
    reg = metrics.registry()
    base = reg.counter("serving_pool_exhausted_total").value
    with chaos.scoped("serving.pool_exhausted@2"):
        a = pool.allocate(1)
        assert pool.allocate(1) is None          # injected refusal
        b = pool.allocate(1)
    assert reg.counter("serving_pool_exhausted_total").value - base == 1
    pool.free(a + b)
    assert pool.check_leaks() == ([], [])


# ===================================================================
# the in-process --router drill, side by side with the JAX Router
# ===================================================================
@pytest.fixture(scope="module")
def router_drills(pair):
    jm, tm, _ = pair
    ours = tcc.run_router(tm, tcc.port_reference(tm))
    theirs = tcc.run_router(jm, jax_reference(jm), kit=jax_kit())
    return ours, theirs


def test_router_drill_is_green_in_both(router_drills):
    ours, theirs = router_drills
    assert theirs["failures"] == []
    assert ours["failures"] == []


@pytest.mark.parametrize("phase", ["kill", "shed", "hang"])
def test_router_drill_streams_match_jax(router_drills, pair, phase):
    ours, theirs = router_drills
    assert ours[phase]["streams"] == theirs[phase]["streams"]
    if phase != "shed":
        prompts = tcc.drill_prompts(11, tcc.ROUTER_LENS)
        refs = jax_reference(pair[0])(prompts, 16)
        assert ours[phase]["streams"] == refs[:len(ours[phase]["streams"])]


@pytest.mark.parametrize("phase", ["kill", "hang"])
def test_router_drill_counters_match_jax(router_drills, phase):
    ours, theirs = router_drills
    assert ours[phase]["counts"] == theirs[phase]["counts"]
    if phase == "kill":
        assert ours["kill"]["failovers"] == theirs["kill"]["failovers"]
        assert ours["kill"]["states"] == theirs["kill"]["states"] == \
            {"r0": "abandoned", "r1": "healthy"}
    else:
        assert ours["hang"]["evictions"] == \
            theirs["hang"]["evictions"] == ["hang"]


def test_router_drill_shedding_matches_jax(router_drills):
    ours, theirs = router_drills
    assert ours["shed"]["admitted"] == theirs["shed"]["admitted"]
    assert ours["shed"]["refused"] == theirs["shed"]["refused"]
    assert ours["shed"]["refused"]


# ===================================================================
# the tool's command line
# ===================================================================
@pytest.mark.parametrize("flag", ["--serving", "--router"])
def test_tool_cli_runs_the_drill_on_the_cpu(flag):
    buf = io.StringIO()
    assert tcc.main([flag, "--device", "cpu"], out=buf) == 0, buf.getvalue()
    assert f"torch_chaos_check {flag} OK" in buf.getvalue()


def test_tool_cli_without_a_card_fails(monkeypatch):
    monkeypatch.setattr(tcc.torch.cuda, "is_available", lambda: False)
    assert tcc.main(["--serving"], out=io.StringIO()) == 1
    with pytest.raises(SystemExit):
        tcc.main([], out=io.StringIO())
