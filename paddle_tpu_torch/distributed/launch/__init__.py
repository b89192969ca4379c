"""The process launcher (counterpart: `paddle_tpu/distributed/launch`).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node N \\
        script.py [script args]

starts N worker processes of `script.py` on this node, each with the
environment `torch.distributed` reads (MASTER_ADDR, MASTER_PORT, RANK,
WORLD_SIZE, LOCAL_RANK; `--master` is host:port of node 0), which
`distributed.init_parallel_env()` joins, plus the JAX package's names
for the same (PT_COORDINATOR, PT_NUM_PROCESSES, PT_PROCESS_ID,
PT_LOCAL_RANK, PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM) and
PT_RESTART_COUNT.  It watches them:

- a worker that exits non-zero is restarted after an exponential backoff
  (`resilience.backoff`), up to `--max_restarts`; past that the others
  are stopped and the launcher exits with its code;
- `--crash_loop_threshold` failures within `--crash_loop_window`
  seconds abort at once (a deterministic failure restarts for nothing);
- with `--heartbeat_timeout`, a worker whose heartbeat file (beaten by
  `init_parallel_env`) goes stale is killed as hung and restarted;
- with `--elastic`, a worker past its budget is dropped and the
  survivors restart in a world one smaller.

`--cache_dir` becomes TORCHINDUCTOR_CACHE_DIR for every worker: the
Inductor cache is the port's counterpart of the JAX package's
persistent compile cache, so a restarted worker reuses what its
predecessor compiled.  `--devices` is taken for the reference's command
line and unused: each worker takes the card of its LOCAL_RANK.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

from .heartbeat import BeatWatch


def _parse_args(argv):
    import argparse
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch distributed training, a process a rank")
    p.add_argument("--nnodes", type=int, default=1, help="number of hosts")
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PT_NODE_RANK", "0")),
                   help="this host's index")
    p.add_argument("--master", default=os.environ.get("PT_MASTER",
                                                      "127.0.0.1:8476"),
                   help="rendezvous host:port (node 0)")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="worker processes on this host (one a card)")
    p.add_argument("--log_dir", default=None,
                   help="per-rank stdout/stderr capture directory")
    p.add_argument("--cache_dir", default=None,
                   help="shared Inductor cache directory "
                        "(TORCHINDUCTOR_CACHE_DIR of every worker)")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="restart a failed worker this many times")
    p.add_argument("--restart_backoff", type=float, default=1.0,
                   help="base seconds of the exponential backoff before a "
                        "restart (0 disables)")
    p.add_argument("--restart_backoff_max", type=float, default=30.0,
                   help="backoff ceiling in seconds")
    p.add_argument("--crash_loop_threshold", type=int, default=3,
                   help="abort when this many worker failures land within "
                        "--crash_loop_window seconds; 0 disables")
    p.add_argument("--crash_loop_window", type=float, default=60.0,
                   help="crash-loop detection window in seconds")
    p.add_argument("--heartbeat_timeout", type=float, default=0.0,
                   help="kill and restart a worker whose heartbeat goes "
                        "stale this many seconds (0 disables)")
    p.add_argument("--heartbeat_interval", type=float, default=1.0,
                   help="seconds between worker heartbeats")
    p.add_argument("--elastic", action="store_true",
                   help="past its restart budget, drop a worker and "
                        "restart the survivors in the smaller world")
    p.add_argument("--devices", default=None,
                   help="taken for the reference's command line; unused")
    p.add_argument("script", help="training script")
    p.add_argument("script_args", nargs="...",
                   help="arguments passed through to the script")
    args = p.parse_args(argv)
    if args.elastic and args.nnodes > 1:
        p.error("--elastic requires --nnodes=1: supervisors do not "
                "coordinate a downsize across hosts")
    return args


def _worker_env(args, local_rank, restarts=0, world=None, hb_path=None):
    """One worker's environment; `world` overrides the per-node count
    after an elastic downsize."""
    env = dict(os.environ)
    nproc = world if world is not None else args.nproc_per_node
    world_total = args.nnodes * nproc
    rank = args.node_rank * nproc + local_rank
    host, _, port = args.master.rpartition(":")
    env.update(MASTER_ADDR=host or "127.0.0.1", MASTER_PORT=port,
               RANK=str(rank), WORLD_SIZE=str(world_total),
               LOCAL_RANK=str(local_rank), LOCAL_WORLD_SIZE=str(nproc),
               PT_COORDINATOR=args.master,
               PT_NUM_PROCESSES=str(world_total), PT_PROCESS_ID=str(rank),
               PT_LOCAL_RANK=str(local_rank),
               PT_RESTART_COUNT=str(restarts),
               PADDLE_TRAINER_ID=str(rank),
               PADDLE_TRAINERS_NUM=str(world_total))
    if hb_path:
        env["PT_HEARTBEAT_FILE"] = hb_path
        env["PT_HEARTBEAT_INTERVAL"] = str(args.heartbeat_interval)
    if args.cache_dir:
        env["TORCHINDUCTOR_CACHE_DIR"] = os.path.abspath(args.cache_dir)
    return env


class _Worker:
    def __init__(self, args, local_rank, hb_dir=None):
        self.args = args
        self.local_rank = local_rank
        self.restarts = 0
        self.restart_at = 0.0   # monotonic time of a pending restart
        self.proc = None
        self.log = None
        self.watch = None
        self.hb_path = (os.path.join(hb_dir, f"hb.{local_rank}")
                        if hb_dir else None)

    def start(self, world=None):
        cmd = [sys.executable, self.args.script] + self.args.script_args
        out = None
        if self.args.log_dir:
            os.makedirs(self.args.log_dir, exist_ok=True)
            rank = self.args.node_rank * self.args.nproc_per_node + \
                self.local_rank
            if self.log:
                self.log.close()
            self.log = open(os.path.join(self.args.log_dir,
                                         f"worker.{rank}.log"), "ab")
            out = self.log
        if self.hb_path and os.path.exists(self.hb_path):
            os.unlink(self.hb_path)     # a stale beat from the last life
        self.proc = subprocess.Popen(
            cmd, env=_worker_env(self.args, self.local_rank,
                                 restarts=self.restarts, world=world,
                                 hb_path=self.hb_path),
            stdout=out, stderr=out)
        if self.hb_path:
            # silence is measured from the start: a worker that never
            # beats is not "participating" and never goes stale
            self.watch = BeatWatch(self.hb_path,
                                   self.args.heartbeat_timeout)

    def poll(self):
        return self.proc.poll()

    def hung(self):
        """Beating once, then silent past the timeout: a hang, not a
        crash."""
        if self.watch is None or self.proc.poll() is not None or \
                not os.path.exists(self.hb_path):
            return False
        return self.watch.stale()

    def kill(self):
        if self.proc and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def terminate(self):
        if self.proc and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self.log:
            self.log.close()
            self.log = None


def run(argv=None):
    """Run the launcher; returns its exit code (0 when every worker
    exited 0, else the failing worker's code)."""
    import tempfile

    from ...resilience.backoff import Backoff, CrashLoopDetector
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    hb_dir = None
    if args.heartbeat_timeout > 0:
        hb_dir = args.log_dir or tempfile.mkdtemp(prefix="pt_launch_hb_")
        os.makedirs(hb_dir, exist_ok=True)
    workers = [_Worker(args, lr, hb_dir=hb_dir)
               for lr in range(args.nproc_per_node)]
    world = None
    backoff = Backoff(base=args.restart_backoff,
                      max_delay=args.restart_backoff_max)
    detector = CrashLoopDetector(threshold=args.crash_loop_threshold,
                                 window=args.crash_loop_window)
    for w in workers:
        w.start(world=world)
    try:
        while True:
            running = False
            now = time.monotonic()
            for w in workers:
                if w.proc is None:          # a restart waits its backoff
                    running = True
                    if now >= w.restart_at:
                        w.start(world=world)
                    continue
                if w.hung():
                    print(f"[launch] worker {w.local_rank} heartbeat stale "
                          f"> {args.heartbeat_timeout:.1f}s — hung, not "
                          f"crashed; killing for restart", file=sys.stderr)
                    w.kill()
                code = w.poll()
                if code is None:
                    running = True
                    continue
                if code == 0:
                    continue
                if args.crash_loop_threshold > 0 and \
                        detector.record_failure():
                    print(f"[launch] worker {w.local_rank} exited {code}: "
                          f"{detector.recent_failures} failures within "
                          f"{args.crash_loop_window:.0f}s — crash loop, "
                          f"aborting instead of restarting", file=sys.stderr)
                    for o in workers:
                        if o is not w:
                            o.terminate()
                    return code
                if w.restarts < args.max_restarts:
                    w.restarts += 1
                    delay = backoff.delay(w.restarts - 1)
                    print(f"[launch] worker {w.local_rank} exited {code}; "
                          f"restart {w.restarts}/{args.max_restarts} in "
                          f"{delay:.1f}s", file=sys.stderr)
                    w.proc = None
                    w.restart_at = now + delay
                    running = True
                elif args.elastic and len(workers) > 1:
                    workers.remove(w)
                    if w.log:
                        w.log.close()
                        w.log = None
                    world = len(workers)
                    print(f"[launch] worker {w.local_rank} failed with code "
                          f"{code}, restart budget exhausted; elastic "
                          f"downsize to world {world}", file=sys.stderr)
                    for i, o in enumerate(workers):
                        o.terminate()
                        o.local_rank = i
                        if o.hb_path:
                            o.hb_path = os.path.join(hb_dir, f"hb.{i}")
                        o.restarts += 1
                        o.proc = None
                        o.restart_at = now
                    running = True
                    break
                else:
                    print(f"[launch] worker {w.local_rank} failed with code "
                          f"{code}; stopping all", file=sys.stderr)
                    for o in workers:
                        if o is not w:
                            o.terminate()
                    return code
            if not running:
                return 0
            time.sleep(0.2)
    except KeyboardInterrupt:
        for w in workers:
            w.terminate()
        return 130
    finally:
        for w in workers:
            if w.log:
                w.log.close()
                w.log = None


def launch():
    sys.exit(run())
