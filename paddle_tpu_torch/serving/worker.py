"""Process-per-replica serving: the worker process and its parent-side
handle.

Counterpart: `paddle_tpu/serving/worker.py`, ported.  Each replica slot
of the router becomes an OS process running the engine's step loop, so
a segfault, an OOM kill or a wedged kernel launch in one replica cannot
take the other replicas, or the router, down with it.  Two halves:

* **the worker** (``python -c "from paddle_tpu_torch.serving.worker
  import main; ..."``, a fresh interpreter started by exec, never a
  fork: CUDA is initialised only in the child): builds a model and an
  :class:`~paddle_tpu_torch.serving.LLMEngine` from the JSON spec the
  parent ships in the ``init`` frame, on the spec's device and dtype,
  then loops: handle commands, beat the heartbeat file *from the loop*
  (a wedged engine must look wedged), step the engine, stream
  ``tok``/``fin``/``step`` events up.
* **:class:`ProcReplica`**: the ``router.ReplicaHandle`` the parent
  drives.  It builds the CUDA kernels in the parent first (two fresh
  workers would otherwise each run every nvcc), spawns the worker in
  its own session and process group, speaks the framed transport, and
  maps process-world failures onto the router's eviction machinery:

  ============================  =====================================
  failure                       surfaces as
  ============================  =====================================
  worker exits (kill -9,        ``step()`` raises :class:`WorkerDied`
  SIGSEGV, OOM kill, exit N)    (waitpid exit code) -> crash eviction,
                                ``router_worker_exits_total{signal}``
  worker wedges (stuck kernel,  heartbeat file goes stale -> hang
  deadlock)                     eviction; ``abort()`` TERM->KILLs it
  frame torn/oversized/dropped  FrameError -> crash eviction,
  (``serving.transport_drop``)  ``router_transport_frame_errors_total``
  reply never comes             TransportTimeout after the policy
                                budget (timeout x retries x backoff),
                                each expired attempt counted in
                                ``router_transport_timeouts_total``
  ============================  =====================================

  Every path that gives up on a worker (``abort()`` on eviction,
  ``close()`` after collecting the engine's leak report over the wire)
  escalates SIGTERM -> SIGKILL on the worker's process group and reaps
  it: no orphan survives the router.

A spec's ``load_aot`` names a directory of exported serving artifacts
(`serving.aot`): the worker loads them into its engine once it is built
and reports how many it loaded as ``aot_loaded`` in its ready event.
A spec with ``lazy=True`` builds the model under ``LazyGuard``, as the
JAX worker does: its parameters materialise on the device when the
guard exits, the same values as an eager build.
`tools/torch_chaos_check.py --router --proc` drills the tier with 3x
SIGKILL mid-stream, a dropped frame and a wedged worker.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
import warnings

import torch

from ..observability import metrics as _metrics
from .block_pool import PoolExhausted
from .engine import ShedRequest
from .router import ReplicaGone, ReplicaHandle
from .transport import (Channel, ChannelClosed, FrameError,
                        TransportError, TransportTimeout, policy_from_env)


def describe_exit(returncode):
    """Human/label form of a waitpid return code: the signal name for
    signal deaths (``SIGKILL``, ``SIGSEGV`` — how the drill asserts 3
    kills), ``exit:N`` otherwise."""
    if returncode is None:
        return "running"
    if returncode < 0:
        try:
            return signal.Signals(-returncode).name
        except ValueError:
            return f"signal:{-returncode}"
    return f"exit:{returncode}"


class WorkerDied(ReplicaGone):
    """The worker process exited: detected by waitpid, the process-world
    spelling of the in-process replica's step raising."""

    def __init__(self, name, returncode):
        self.returncode = returncode
        super().__init__(f"worker {name} died "
                         f"({describe_exit(returncode)})")


class RemoteRequest:
    """Parent-side proxy for one request living in a worker's engine.
    Mirrors exactly the fields the router reads off an engine Request:
    ``generated`` (seeded with the resume tokens, so its length is the
    absolute stream position the failover-overlap dedup needs) and
    ``finish_reason``; ``on_token(req, tok)`` / ``on_finish(req)`` fire
    as the worker's events arrive, in stream order."""

    def __init__(self, rid, resume_tokens=None, on_token=None,
                 on_finish=None):
        self.id = self.rid = rid
        self.generated = [int(t) for t in (resume_tokens or [])]
        self.resumed = resume_tokens is not None
        self.finish_reason = None
        self.on_token = on_token
        self.on_finish = on_finish

    def __repr__(self):
        return (f"RemoteRequest(rid={self.rid}, "
                f"gen={len(self.generated)}, "
                f"finish={self.finish_reason!r})")


def gpt_spec(config=None, preset=None, overrides=None, seed=0,
             engine=None, load_aot=None, lazy=False, step_delay_s=0.0,
             device=None, dtype="float32"):
    """A worker spec for a GPT replica (JSON-serializable end to end).

    The worker builds the replica as the port always builds GPT:
    ``GPTForCausalLM(cfg, device=, dtype=, generator=torch.Generator(
    device).manual_seed(seed))`` with ``GPTConfig(**config)`` (or
    ``from_preset(preset, **overrides)``), so every worker, and every
    respawn, holds the same weights bit for bit as a parent that built
    the model the same way on the same device: that is what keeps
    failover streams byte-identical across processes.  `device` is where
    the worker builds and serves (None: the CUDA device; a worker that
    finds no card raises and exits), `dtype` a torch dtype name.
    ``engine`` holds LLMEngine kwargs.  A custom model: put ``{"builder":
    "pkg.mod:fn"}`` in the returned dict; the worker calls ``fn(spec)``
    and expects an LLMEngine back.  ``load_aot`` is a directory of
    exported serving artifacts: the worker warm-starts from it (best
    effort: a refused program is served eagerly) and reports
    ``aot_loaded`` in its ready event.  ``step_delay_s`` throttles the
    worker loop (drills use it to hold streams open long enough to kill
    them mid-stream).  ``lazy`` builds the model under ``LazyGuard``."""
    return {"seed": int(seed),
            "model": {"kind": "gpt", "preset": preset,
                      "config": dict(config or {}),
                      "overrides": dict(overrides or {}),
                      "lazy": bool(lazy)},
            "engine": dict(engine or {}),
            "load_aot": load_aot,
            "device": None if device is None else str(device),
            "dtype": str(dtype),
            "step_delay_s": float(step_delay_s)}


def _raise_remote(err):
    """Re-raise a worker-side add_request refusal as the exception type
    the in-proc engine would have raised — the router's shed/validation
    handling must not care which side of the socket refused."""
    kind = err.get("kind")
    if kind == "ShedRequest":
        raise ShedRequest(err.get("reason", "remote"),
                          **(err.get("detail") or {}))
    if kind == "PoolExhausted":
        raise PoolExhausted(err.get("message", "pool exhausted"))
    if kind == "ValueError":
        raise ValueError(err.get("message", "invalid request"))
    raise ReplicaGone(f"worker refused add_request: "
                      f"{err.get('message', err)!r}")


class ProcReplica(ReplicaHandle):
    """ReplicaHandle over a spawned worker process (see module doc).

    The constructor returns as soon as the worker is started (after the
    kernel build, for a CUDA spec); import and model build happen in the
    child.  Until its ``ready`` event arrives, ``add_request`` sheds
    with reason ``replica_warming`` (the router then places on warm
    survivors); drivers that submit a whole trace up front call
    ``wait_ready`` first.
    """

    def __init__(self, spec, name, hb_path, policy=None, env=None):
        self.name = name
        self.hb_path = hb_path
        self.policy = policy if policy is not None else policy_from_env()
        self.ready = False
        self.ready_info = None
        self._reqs = {}              # rid -> RemoteRequest
        self._next_rid = 0
        self._gauges = (0, 0, 0)     # (queue_depth, running, free)
        self._summary = None
        self._pending_reply = None
        self._exit_noted = False
        _build_kernels(spec)
        parent_sock, child_sock = socket.socketpair()
        wenv = dict(os.environ if env is None else env)
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        wenv["PYTHONPATH"] = repo + (
            os.pathsep + wenv["PYTHONPATH"]
            if wenv.get("PYTHONPATH") else "")
        # a fresh interpreter by exec, never a fork of this process (which
        # may hold a CUDA context).  start_new_session: the worker gets
        # its own session and process group, so terminal signals aimed
        # at the router do not race its orderly shutdown, and TERM/KILL
        # by killpg() also sweeps anything the worker itself started.
        # -c (not -m): serving/__init__ imports this module, and runpy
        # re-executing an already-imported submodule warns
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from paddle_tpu_torch.serving.worker import "
             "main; sys.exit(main())",
             "--fd", str(child_sock.fileno()), "--name", name],
            pass_fds=(child_sock.fileno(),), start_new_session=True,
            env=wenv)
        child_sock.close()
        self.ch = Channel(parent_sock, name=name)
        self.ch.send({"cmd": "init",
                      "spec": dict(spec, name=name, hb_path=hb_path)})

    # ------------------------------------------------------------- events
    def _dispatch(self, msg):
        if "reply" in msg:
            self._pending_reply = msg
            return
        ev = msg.get("ev")
        if ev == "tok":
            rq = self._reqs.get(msg["rid"])
            if rq is None:
                return               # stream of an already-dropped req
            tok = int(msg["tok"])
            rq.generated.append(tok)
            if rq.on_token is not None:
                rq.on_token(rq, tok)
        elif ev == "fin":
            rq = self._reqs.pop(msg["rid"], None)
            if rq is None:
                return
            rq.finish_reason = msg.get("reason")
            if rq.on_finish is not None:
                rq.on_finish(rq)
        elif ev == "step":
            self._summary = msg.get("summary")
            g = msg.get("gauges")
            if g:
                self._gauges = (int(g[0]), int(g[1]), int(g[2]))
        elif ev == "ready":
            self.ready = True
            self.ready_info = msg
            g = msg.get("gauges")
            if g:
                self._gauges = (int(g[0]), int(g[1]), int(g[2]))
        # unknown events are ignored (forward compatibility)

    def _pump(self):
        """Dispatch every frame the kernel already buffered.  Frame
        damage is counted, then surfaces to the caller — whose job is
        to escalate it into an eviction."""
        try:
            while True:
                msg = self.ch.poll()
                if msg is None:
                    return
                self._dispatch(msg)
        except FrameError:
            _metrics.registry().counter(
                "router_transport_frame_errors_total").inc()
            raise

    def _note_exit(self, rc):
        if rc is None or self._exit_noted:
            return
        self._exit_noted = True
        _metrics.registry().counter("router_worker_exits_total",
                                    signal=describe_exit(rc)).inc()

    def _died(self, rc):
        self._note_exit(rc)
        raise WorkerDied(self.name, rc)

    # -------------------------------------------------------------- RPCs
    def _rpc(self, cmd, timeout=None):
        """Wait for `cmd`'s reply, dispatching interleaved stream
        events while waiting.  The wait runs under the transport policy:
        per-attempt timeout, `retries` extra attempts with backoff
        between them, every expired attempt counted in
        ``router_transport_timeouts_total``."""
        pol = self.policy
        attempts = pol.retries + 1
        per_attempt = pol.timeout if timeout is None else float(timeout)
        for attempt in range(attempts):
            deadline = time.monotonic() + per_attempt
            while True:
                # pump FIRST, check the stash SECOND: a worker that
                # replied then exited (close) must have its flushed
                # reply honored — EOF alone is not "no answer"
                closed = False
                try:
                    self._pump()
                except ChannelClosed:
                    closed = True
                if self._pending_reply is not None:
                    reply, self._pending_reply = self._pending_reply, None
                    if reply.get("reply") != cmd:
                        raise FrameError(
                            f"out-of-order reply "
                            f"{reply.get('reply')!r} to {cmd!r} on "
                            f"{self.name!r}")
                    return reply
                rc = self.proc.poll()
                if rc is not None:
                    self._died(rc)
                if closed:
                    # EOF, no reply, no exit status yet: wait for the
                    # status instead of spinning on a dead pipe
                    try:
                        rc = self.proc.wait(timeout=2.0)
                    except subprocess.TimeoutExpired:
                        raise ReplicaGone(
                            f"worker {self.name} closed its transport "
                            f"while still running") from None
                    self._died(rc)
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self.ch.wait_readable(min(left, 0.1))
            _metrics.registry().counter(
                "router_transport_timeouts_total").inc()
            if attempt + 1 < attempts:
                pol.backoff.wait(attempt)
        raise TransportTimeout(
            f"worker {self.name}: no reply to {cmd!r} after "
            f"{attempts} attempt(s) x {per_attempt:g}s")

    # ---------------------------------------------- ReplicaHandle methods
    def _pump_or_gone(self):
        """_pump with the replica-level contract: transport damage on a
        still-alive peer is ReplicaGone (the caller/router must evict),
        clean EOF defers to the process check."""
        try:
            self._pump()
        except ChannelClosed:
            pass
        except FrameError as e:
            raise ReplicaGone(f"worker {self.name} transport damaged: "
                              f"{e}") from e

    def wait_ready(self, timeout=None):
        deadline = None if timeout is None else \
            time.monotonic() + float(timeout)
        while not self.ready:
            self._pump_or_gone()
            if self.ready:
                break
            rc = self.proc.poll()
            if rc is not None:
                self._died(rc)
            if deadline is not None and time.monotonic() >= deadline:
                return False
            self.ch.wait_readable(0.1)
        return True

    def step(self):
        """One router-driver iteration: pump streamed events, then
        check the process.  A waitpid exit code raises WorkerDied —
        landing in the router's crash-eviction path exactly as an
        in-proc step raise does."""
        try:
            self._pump()
        except ChannelClosed:
            # EOF: the exit code below tells the story; give waitpid a
            # beat to observe an exit that raced the socket close
            try:
                rc = self.proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                raise ReplicaGone(
                    f"worker {self.name} closed its transport while "
                    f"still running") from None
            self._died(rc)
        rc = self.proc.poll()
        if rc is not None:
            self._died(rc)
        summary, self._summary = self._summary, None
        return summary

    def add_request(self, prompt_ids, max_new_tokens=20, on_token=None,
                    on_finish=None, resume_tokens=None, **params):
        if not self.ready:
            self._pump_or_gone()     # the ready event may be buffered
            rc = self.proc.poll()
            if rc is not None:
                self._died(rc)
            if not self.ready:
                raise ShedRequest("replica_warming", replica=self.name)
        rid = self._next_rid
        self._next_rid += 1
        rq = RemoteRequest(rid, resume_tokens=resume_tokens,
                           on_token=on_token, on_finish=on_finish)
        self._reqs[rid] = rq
        try:
            self.ch.send({
                "cmd": "add_request", "rid": rid,
                "prompt": [int(t) for t in prompt_ids],
                "max_new_tokens": int(max_new_tokens),
                "resume_tokens": (None if resume_tokens is None
                                  else [int(t) for t in resume_tokens]),
                "params": params})
            reply = self._rpc("add_request")
        except ReplicaGone:
            self._reqs.pop(rid, None)
            raise
        except TransportError as e:
            self._reqs.pop(rid, None)
            raise ReplicaGone(f"worker {self.name} lost during "
                              f"add_request: {e}") from e
        if not reply.get("ok"):
            self._reqs.pop(rid, None)
            _raise_remote(reply.get("error") or {})
        g = reply.get("gauges")
        if g:
            self._gauges = (int(g[0]), int(g[1]), int(g[2]))
        return rq

    def cancel(self, req):
        """Best-effort: a dead transport is step()'s problem to
        report."""
        try:
            self.ch.send({"cmd": "cancel", "rid": req.rid})
        except TransportError:
            pass

    def load(self):
        q, r, free = self._gauges
        return (q, r, -free)

    def metrics_snapshot(self):
        try:
            self.ch.send({"cmd": "metrics_snapshot"})
            return self._rpc("metrics_snapshot").get("metrics", [])
        except TransportError as e:
            raise ReplicaGone(f"worker {self.name} lost during "
                              f"metrics_snapshot: {e}") from e

    def drain(self, ttl_s=None):
        try:
            self.ch.send({"cmd": "drain", "ttl_s": ttl_s})
            # the worker drains inline, so allow the budget on top of
            # the per-attempt policy timeout
            reply = self._rpc("drain",
                              timeout=self.policy.timeout + (ttl_s or 0))
            return reply.get("summary", {})
        except TransportError as e:
            raise ReplicaGone(f"worker {self.name} lost during "
                              f"drain: {e}") from e

    # ---------------------------------------------------------- teardown
    def _signal_group(self, sig):
        try:
            os.killpg(self.proc.pid, sig)   # pgid == pid (new session)
        except (ProcessLookupError, PermissionError):
            pass

    def _reap(self, term_timeout=5.0, kill_timeout=5.0):
        """TERM→KILL escalation on the worker's process group, then
        waitpid — the no-orphans contract.  TERM first: a healthy
        worker exits its loop cleanly; one stuck in native code ignores
        it and eats the KILL."""
        p = self.proc
        if p.poll() is None:
            self._signal_group(signal.SIGTERM)
            try:
                p.wait(term_timeout)
            except subprocess.TimeoutExpired:
                self._signal_group(signal.SIGKILL)
                try:
                    p.wait(kill_timeout)
                except subprocess.TimeoutExpired:
                    pass             # kernel-stuck: nothing more a
                                     # parent can do from userspace
        self._note_exit(p.poll())

    def abort(self):
        """Evicted (crash or hang): make sure the process is gone and
        reaped.  Never raises."""
        try:
            self._reap(term_timeout=2.0)
        except Exception:
            pass
        try:
            self.ch.close()
        except Exception:
            pass

    def close(self, reap_timeout=5.0):
        """Graceful shutdown: ask the worker to close its engine and
        report leaks, then reap with TERM→KILL escalation regardless of
        how that went.  Returns the worker's ``check_leaks()`` tuple,
        or ``(None, None)`` when it could not report (killed while
        starting, wedged): unknown, not known-clean."""
        leaks = None
        if self.proc.poll() is None and not self.ch.closed:
            try:
                self.ch.send({"cmd": "close"})
                reply = self._rpc("close")
                lk = reply.get("leaks")
                if lk is not None:
                    leaks = (list(lk[0]), list(lk[1]))
            except Exception:
                pass                 # escalation below still reaps
        self._reap(term_timeout=reap_timeout)
        try:
            self.ch.close()
        except Exception:
            pass
        return leaks if leaks is not None else (None, None)


def _build_kernels(spec):
    """Compile the kernel sources in THIS process before a CUDA worker
    starts: two fresh workers would each run every nvcc (the build is
    per process), and a slow start can outlast the spawn grace.  Sources
    already built are skipped."""
    if str(spec.get("device") or "cuda").startswith("cpu"):
        return
    from ..ops import _build
    _build.build()


# ======================================================================
# the worker process
# ======================================================================
def build_gpt(spec):
    """The GPTForCausalLM a `gpt_spec` describes, built on the spec's
    device from a generator seeded with the spec's seed (under
    `LazyGuard` when the spec says ``lazy``)."""
    import contextlib

    from ..device import resolve_device
    from ..framework.lazy import LazyGuard
    from ..text import GPTConfig, GPTForCausalLM
    m = spec.get("model") or {}
    if m.get("preset"):
        cfg = GPTConfig.from_preset(m["preset"],
                                    **(m.get("overrides") or {}))
    else:
        cfg = GPTConfig(**(m.get("config") or {}))
    device = resolve_device(spec.get("device"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"worker spec asks for {device} and this "
                           f"process sees no CUDA device")
    gen = torch.Generator(device=device).manual_seed(
        int(spec.get("seed", 0)))
    with LazyGuard() if m.get("lazy") else contextlib.nullcontext():
        model = GPTForCausalLM(cfg, device=device,
                               dtype=getattr(torch, spec.get("dtype")
                                             or "float32"),
                               generator=gen)
    return model


def _build(spec):
    """(engine, heartbeat, aot_loaded) from the init spec, in the WORKER
    process; the spec's ``load_aot`` artifacts are loaded into the
    engine after it is built."""
    import importlib

    from ..distributed.launch import heartbeat as hb
    from .engine import LLMEngine

    entry = spec.get("builder")
    if entry:
        mod, fn = entry.split(":", 1)
        eng = getattr(importlib.import_module(mod), fn)(spec)
    else:
        eng = LLMEngine(build_gpt(spec), **(spec.get("engine") or {}))
    heartbeat = hb.Heartbeat(spec["hb_path"]) \
        if spec.get("hb_path") else None
    aot_loaded = 0
    if spec.get("load_aot"):
        from .aot import load_serving_artifacts
        t0 = time.perf_counter()
        try:
            aot_loaded = len(load_serving_artifacts(eng,
                                                    spec["load_aot"]))
            _metrics.registry().gauge("serving_aot_load_seconds").set(
                time.perf_counter() - t0)
        except Exception as e:       # warm start is best-effort
            warnings.warn(f"worker AOT warm start failed ({e}); "
                          f"serving eagerly", UserWarning)
    return eng, heartbeat, aot_loaded


class _WorkerLoop:
    """The engine step loop on the worker side of the socket."""

    def __init__(self, ch, engine, heartbeat, aot_loaded=0,
                 step_delay_s=0.0):
        self.ch = ch
        self.engine = engine
        self.heartbeat = heartbeat
        self.aot_loaded = aot_loaded
        self.step_delay_s = float(step_delay_s)
        self._reqs = {}              # rid -> engine Request
        self._stop_sig = None
        self._closing = False

    def _record_signal(self, signum, frame):
        self._stop_sig = signum

    def _beat(self):
        if self.heartbeat is None:
            return
        try:
            self.heartbeat.beat()
        except OSError:
            pass                     # a vanished hb dir must not kill us

    def _gauges(self):
        eng = self.engine
        return [eng.scheduler.queue_depth, len(eng.scheduler.running),
                eng.pool.free_blocks]

    def run(self):
        # from here on SIGTERM means "finish the iteration, close the
        # engine, exit 0" — the startup handler (exit immediately) has
        # done its job once the engine exists
        signal.signal(signal.SIGTERM, self._record_signal)
        self.ch.send({"ev": "ready", "pid": os.getpid(),
                      "aot_loaded": self.aot_loaded,
                      "gauges": self._gauges()})
        self._beat()
        eng = self.engine
        while not self._closing:
            self._drain_commands()
            if self._closing:
                break
            if self._stop_sig is not None:
                self._do_close(reply=False)
                break
            self._beat()
            if eng.has_work:
                summary = eng.step()
                self.ch.send({"ev": "step", "summary": summary,
                              "gauges": self._gauges()})
                if self.step_delay_s:
                    time.sleep(self.step_delay_s)
            else:
                msg = self.ch.recv(timeout=0.02)
                if msg is not None:
                    self._handle(msg)
        return 0

    def _drain_commands(self):
        while not self._closing:
            msg = self.ch.poll()
            if msg is None:
                return
            self._handle(msg)

    def _handle(self, msg):
        cmd = msg.get("cmd")
        if cmd == "add_request":
            self._on_add(msg)
        elif cmd == "cancel":
            req = self._reqs.get(msg.get("rid"))
            if req is not None:
                self.engine.cancel(req)
        elif cmd == "drain":
            summary = self.engine.drain(ttl_s=msg.get("ttl_s"))
            self.ch.send({"reply": "drain", "summary": summary,
                          "gauges": self._gauges()})
        elif cmd == "metrics_snapshot":
            self.ch.send({"reply": "metrics_snapshot",
                          "metrics": self.engine.metrics_snapshot()})
        elif cmd == "close":
            self._do_close(reply=True)
        elif cmd == "_wedge":
            self._wedge()
        else:
            self.ch.send({"reply": cmd, "ok": False,
                          "error": {"kind": "RuntimeError",
                                    "message": f"unknown command "
                                               f"{cmd!r}"}})

    def _on_add(self, msg):
        rid = int(msg["rid"])
        ch = self.ch

        def on_token(req, tok):
            ch.send({"ev": "tok", "rid": rid, "tok": int(tok)})

        def on_finish(req):
            self._reqs.pop(rid, None)
            ch.send({"ev": "fin", "rid": rid,
                     "reason": req.finish_reason})

        try:
            req = self.engine.add_request(
                msg["prompt"],
                max_new_tokens=msg.get("max_new_tokens", 20),
                on_token=on_token, on_finish=on_finish,
                resume_tokens=msg.get("resume_tokens"),
                **dict(msg.get("params") or {}))
        except ShedRequest as e:
            detail = {k: v if isinstance(v, (int, float, bool, str,
                                             type(None))) else str(v)
                      for k, v in e.detail.items()}
            ch.send({"reply": "add_request", "rid": rid, "ok": False,
                     "error": {"kind": "ShedRequest", "reason": e.reason,
                               "detail": detail}})
            return
        except (PoolExhausted, ValueError, RuntimeError) as e:
            ch.send({"reply": "add_request", "rid": rid, "ok": False,
                     "error": {"kind": type(e).__name__,
                               "message": str(e)}})
            return
        self._reqs[rid] = req
        ch.send({"reply": "add_request", "rid": rid, "ok": True,
                 "req_id": req.id, "gauges": self._gauges()})

    def _do_close(self, reply):
        leaks = self.engine.close()
        if reply:
            try:
                self.ch.send({"reply": "close",
                              "leaks": [list(leaks[0]), list(leaks[1])]})
            except TransportError:
                pass
        self._closing = True

    def _wedge(self):
        """Debug/chaos hook: become a WEDGED worker.  Stop beating,
        stepping and reading, and ignore SIGTERM (a thread stuck in
        native code never runs Python signal handlers), so only the
        parent's KILL escalation can clear the slot: what the hang
        eviction and abort() are drilled against."""
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        while True:
            time.sleep(3600)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="paddle_tpu_torch serving worker (started by "
                    "ProcReplica; not a user-facing entry point)")
    ap.add_argument("--fd", type=int, required=True,
                    help="inherited socketpair fd to the parent")
    ap.add_argument("--name", default="worker")
    args = ap.parse_args(argv)

    # SIGTERM during startup (import, CUDA init, model build): nothing to
    # flush, so leave at once, without interpreter teardown, and the
    # parent's reap never has to escalate to KILL for a slow start
    signal.signal(signal.SIGTERM, lambda *_: os._exit(143))

    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM,
                         fileno=args.fd)
    ch = Channel(sock, name=args.name)
    init = ch.recv(timeout=60.0)
    if not init or init.get("cmd") != "init":
        print(f"worker {args.name}: no init frame", file=sys.stderr)
        return 2
    spec = init.get("spec") or {}
    eng, heartbeat, aot_loaded = _build(spec)
    loop = _WorkerLoop(ch, eng, heartbeat, aot_loaded=aot_loaded,
                       step_delay_s=spec.get("step_delay_s", 0.0))
    try:
        return loop.run()
    except ChannelClosed:
        # the parent went away: release the engine and leave quietly
        try:
            eng.close()
        except Exception:
            pass
        return 0
    except FrameError as e:
        print(f"worker {args.name}: transport damage ({e})",
              file=sys.stderr)
        return 3


if __name__ == "__main__":
    sys.exit(main())
