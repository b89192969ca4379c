#!/usr/bin/env python3
"""Which collectives gloo carries on CUDA tensors, two ranks on one card.

    python3 tools/torch_gloo_cuda_probe.py

NCCL refuses two ranks on one device, so two ranks sharing one card
would have to talk over gloo.  This starts two processes on card 0, joins
them in one gloo group, and tries each collective that the port's
tensor, data and context parallelism call on CUDA tensors (all_reduce,
broadcast, reduce, all_gather, reduce_scatter_tensor, batch_isend_irecv,
send / recv), each in a fresh pair of processes (an op that gloo cannot
take may abort its process), checked against the expected values.  It
prints one JSON line, {"torch": ..., "device": ..., "ops": {name: "ok",
the error's first line, or the ranks' exit codes when they died}}, and
exits 0 whatever gloo refuses.
"""
import json
import os
import socket
import sys


def _try(name, fn, out):
    try:
        fn()
        out[name] = "ok"
    except Exception as e:          # noqa: BLE001 — the refusal is data
        out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _rank(rank, port, path, only):
    import datetime

    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    out = {}

    def all_reduce():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        assert t.tolist() == [3.0] * 4

    def broadcast():
        t = torch.full((4,), float(rank), device=dev)
        dist.broadcast(t, src=1)
        assert t.tolist() == [1.0] * 4

    def reduce():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.reduce(t, dst=0)
        assert rank != 0 or t.tolist() == [3.0] * 4

    def all_gather():
        parts = [torch.empty(2, device=dev) for _ in range(2)]
        dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
        assert [p.tolist() for p in parts] == [[0.0] * 2, [1.0] * 2]

    def reduce_scatter_tensor():
        out_t = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out_t, torch.arange(4.0, device=dev))
        assert out_t.tolist() == [2.0 * 2 * rank, 2.0 * (2 * rank + 1)]

    def batch_isend_irecv():
        send = torch.full((3,), float(rank), device=dev)
        recv = torch.empty(3, device=dev)
        ops = [dist.P2POp(dist.isend, send, 1 - rank),
               dist.P2POp(dist.irecv, recv, 1 - rank)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        assert recv.tolist() == [float(1 - rank)] * 3

    def send_recv():
        t = torch.full((3,), 7.0, device=dev)
        if rank == 0:
            dist.send(t, 1)
        else:
            dist.recv(t, 0)
        assert t.tolist() == [7.0] * 3

    fn = {f.__name__: f for f in (all_reduce, broadcast, reduce, all_gather,
                                  reduce_scatter_tensor, batch_isend_irecv,
                                  send_recv)}[only]
    _try(only, fn, out)
    dist.barrier()
    if rank == 0:
        with open(path, "w") as f:
            json.dump({"torch": torch.__version__,
                       "device": torch.cuda.get_device_name(0),
                       "ops": out}, f)
    dist.destroy_process_group()


OPS = ("all_reduce", "broadcast", "reduce", "all_gather",
       "reduce_scatter_tensor", "batch_isend_irecv", "send_recv")


def main():
    import subprocess
    import tempfile
    rec = {"ops": {}}
    for op in OPS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        path = os.path.join(tempfile.mkdtemp(), "probe.json")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), str(port), path,
             op], stderr=subprocess.DEVNULL) for r in range(2)]
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=120))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append("timeout")
        if os.path.exists(path):
            with open(path) as f:
                got = json.load(f)
            rec.update(torch=got["torch"], device=got["device"])
            rec["ops"][op] = got["ops"][op]
        else:
            rec["ops"][op] = f"the ranks died: exit codes {codes}"
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
    else:
        sys.exit(main())
