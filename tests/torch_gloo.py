"""Run checks in gloo ranks on the CPU, for the port's distributed tests.

The parent (a module-scoped fixture) writes a job, a JSON list of
{"name", "fn", "kw"}, and starts `nproc` ranks with the port's launcher
(`python -m paddle_tpu_torch.distributed.launch`).  Each rank runs this
file as a script: it joins one gloo process group, runs every check of
the job in it (`torch_gloo_checks.<fn>(**kw)`), and rank 0 saves what a
check returns as `<name>.npz`; a check that raises leaves
`<name>.<rank>.err` with its traceback.  At the end each rank writes the
JAX modules it holds (none may be) to `modules.<rank>.json`.  The ranks
import torch, numpy and the port only.
"""
import json
import os
import socket
import subprocess
import sys
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu", "paddle"}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """The results of one launched job: `ranks[name]` is the dict rank 0
    saved; a check that failed on any rank raises with its traceback."""

    def __init__(self, nproc, cases, tmp, timeout=600):
        self.nproc, self.out = nproc, str(tmp)
        job = os.path.join(self.out, "job.json")
        with open(job, "w") as f:
            json.dump(cases, f)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", str(nproc), "--master",
             f"127.0.0.1:{_free_port()}", "--log_dir",
             os.path.join(self.out, "logs"), __file__, job, self.out],
            cwd=REPO, env=env, timeout=timeout, capture_output=True,
            text=True)

    def log(self):
        d = os.path.join(self.out, "logs")
        return "\n".join(open(os.path.join(d, n)).read()[-4000:]
                         for n in sorted(os.listdir(d)))

    def __getitem__(self, name):
        errs = sorted(n for n in os.listdir(self.out)
                      if n.startswith(name + ".") and n.endswith(".err"))
        if errs:
            raise AssertionError("\n".join(
                open(os.path.join(self.out, n)).read() for n in errs))
        path = os.path.join(self.out, name + ".npz")
        assert os.path.exists(path), \
            f"{name}: no result (launcher rc {self.proc.returncode})\n" \
            f"{self.log()}"
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def modules(self):
        return {r: json.load(open(os.path.join(self.out,
                                               f"modules.{r}.json")))
                for r in range(self.nproc)}


def _main(job, out):
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(1)
    import torch_gloo_checks as checks
    from paddle_tpu_torch import distributed as dist
    dist.init_parallel_env(backend="gloo", timeout=60)
    rank = dist.get_rank()
    for case in json.load(open(job)):
        try:
            res = getattr(checks, case["fn"])(**case.get("kw", {}))
            if rank == 0 and res is not None:
                np.savez(os.path.join(out, case["name"] + ".npz"),
                         **{k: np.asarray(v) for k, v in res.items()})
        except Exception:
            with open(os.path.join(out, f"{case['name']}.{rank}.err"),
                      "w") as f:
                f.write(f"rank {rank}: " + traceback.format_exc())
        finally:
            checks.reset()
    with open(os.path.join(out, f"modules.{rank}.json"), "w") as f:
        json.dump(sorted(m for m in sys.modules
                         if m.split(".")[0] in FORBIDDEN), f)
    dist.destroy_process_group()


if __name__ == "__main__":
    _main(*sys.argv[1:3])
