"""The port's launcher, `spawn` and DataParallel, on the CPU (as
`tests/test_launch.py:19-75` holds the JAX package's).

The launcher's environment, restart, crash-loop and failure propagation
run small scripts that import nothing of the port; the coordination
check and DataParallel run in one 2-rank gloo launch (`torch_gloo`),
DataParallel held against one process taking the whole batch.
`spawn` starts its processes (an intended divergence: the JAX package
runs the function once, inline).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed.launch import _parse_args, _worker_env, run
from paddle_tpu_torch.optimizer import Adam
from torch_gloo import REPO, Ranks


def test_parse_and_env():
    args = _parse_args(["--nnodes", "2", "--node_rank", "1",
                        "--master", "10.0.0.1:1234", "--nproc_per_node",
                        "2", "--cache_dir", "/tmp/ic", "train.py", "--lr",
                        "0.1"])
    assert args.script == "train.py"
    assert args.script_args == ["--lr", "0.1"]
    env = _worker_env(args, 1)
    assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == ("10.0.0.1", "1234")
    assert (env["RANK"], env["WORLD_SIZE"], env["LOCAL_RANK"]) == \
        ("3", "4", "1")
    assert (env["PT_COORDINATOR"], env["PT_NUM_PROCESSES"],
            env["PT_PROCESS_ID"], env["PADDLE_TRAINER_ID"]) == \
        ("10.0.0.1:1234", "4", "3", "3")
    assert env["TORCHINDUCTOR_CACHE_DIR"] == "/tmp/ic"
    assert _worker_env(args, 0, restarts=2, world=1)["WORLD_SIZE"] == "2"
    with pytest.raises(SystemExit):
        _parse_args(["--elastic", "--nnodes", "2", "x.py"])


def test_elastic_restart(tmp_path):
    marker = tmp_path / "ran_once"
    script = tmp_path / "flaky.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        if not os.path.exists({str(marker)!r}):
            open({str(marker)!r}, "w").close()
            sys.exit(1)
        assert os.environ["PT_RESTART_COUNT"] == "1"
    """))
    assert run(["--max_restarts", "1", "--restart_backoff", "0",
                str(script)]) == 0
    assert marker.exists()


def test_failure_propagates_and_stops_the_others(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import os, sys, time
        if os.environ["RANK"] == "1":
            sys.exit(3)
        time.sleep(60)
    """))
    assert run(["--nproc_per_node", "2", str(bad)]) == 3


def test_crash_loop_aborts_before_the_budget(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import sys; sys.exit(5)")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--max_restarts", "10", "--restart_backoff", "0",
         "--crash_loop_threshold", "2", str(bad)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=60)
    assert proc.returncode == 5
    assert "crash loop" in proc.stderr


def test_a_hung_worker_is_killed_and_restarted(tmp_path):
    """The worker beats once, then hangs; the supervisor kills it as hung
    and the restarted worker exits 0."""
    script = tmp_path / "hang.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys, time
        sys.path.insert(0, {REPO!r})
        from paddle_tpu_torch.distributed.launch import heartbeat
        if os.environ["PT_RESTART_COUNT"] == "0":
            heartbeat.Heartbeat(os.environ["PT_HEARTBEAT_FILE"]).beat()
            time.sleep(60)
    """))
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--max_restarts", "1", "--restart_backoff", "0",
         "--heartbeat_timeout", "1", str(script)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "hung, not crashed" in proc.stderr


def _spawned(out):
    with open(os.path.join(out, f"rank{os.environ['RANK']}.txt"), "w") as f:
        f.write(f"{os.environ['RANK']}/{os.environ['WORLD_SIZE']}/"
                f"{dist.get_world_size()}")


def test_spawn_starts_a_process_a_rank(tmp_path):
    """The divergence: two processes, each its own rank of a world of 2
    (the JAX package would call `_spawned` once in this process)."""
    dist.spawn(_spawned, args=(str(tmp_path),), nprocs=2, backend="gloo")
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["rank0.txt", "rank1.txt"]
    assert (tmp_path / "rank1.txt").read_text() == "1/2/2"


def test_init_parallel_env_needs_a_card_or_gloo(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        dist.init_parallel_env()
    assert not dist.is_initialized()
    assert (dist.get_rank(), dist.get_world_size()) == (0, 1)


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.RandomState(3)
    torch.manual_seed(5)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 8))
    arrays = {k: v.numpy() for k, v in net.state_dict().items()}
    arrays.update(x=rng.standard_normal((8, 8)).astype(np.float32),
                  y=rng.standard_normal((8, 8)).astype(np.float32))
    np.savez(tmp / "dp.npz", **arrays)
    ranks = Ranks(2, [{"name": "dp", "fn": "data_parallel", "kw": dict(
        inputs=str(tmp / "dp.npz"), steps=3, lr=0.05)}], tmp)
    return arrays, ranks


def test_data_parallel_matches_one_process(dp_ranks):
    arrays, ranks = dp_ranks
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 8))
    net.load_state_dict({k: torch.from_numpy(arrays[k])
                         for k in net.state_dict()})
    model = dist.DataParallel(net)        # one rank: a no-op
    opt = Adam(learning_rate=0.05, parameters=model.parameters())
    x, y = torch.from_numpy(arrays["x"]), torch.from_numpy(arrays["y"])
    losses = []
    for _ in range(3):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        model.apply_collective_grads()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    got = ranks["dp"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for k, v in net.state_dict().items():
        np.testing.assert_allclose(got[k], v.detach().numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_launched_ranks_coordinate_and_load_no_jax(dp_ranks):
    _, ranks = dp_ranks
    assert ranks.proc.returncode == 0
    assert ranks.modules() == {0: [], 1: []}
