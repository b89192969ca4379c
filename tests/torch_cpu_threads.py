"""One torch CPU thread pool per test worker that fits the machine.

Each pytest-xdist worker is a process with torch's default intra-op
pool, one thread per core; six workers on an 8-core host then run 48
OpenMP threads that spin against each other, and a small torch op waits
on the others' spinning (the port's checkpoint resume tests: 15 s with
one thread a worker, 700 s with eight, six workers at once).  `limit()`
gives each worker cores // workers threads (at least 1).  The processes
a test starts keep their own settings (the gloo ranks run one thread;
the serving and loader drills' workers time their faults as they did).
It changes no result a test checks: a test that compares two torch runs
makes both in one process, and the comparisons with the JAX package
carry tolerances.  A port test module calls it when it is imported,
which every worker does while it collects.
"""
import os

import torch


def limit():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // workers)
    if torch.get_num_threads() > n:
        torch.set_num_threads(n)
