"""The port's persistent compile cache (`paddle_tpu_torch.jit.
compile_cache`) against the JAX package's (`paddle_tpu.jit.compile_cache`).

The store is held to the reference on the same byte payloads and the same
sequence of put / get / gc / corrupt: the same survivors, GC victims,
quarantined entries and warning count; `corrupt_cache_entry` in each of
its modes; `config_fingerprint` moving for the same changes; the
lock-free race between two processes; the four chaos sites; and the
compile tracker's persistent-hit event and counter.  The reference's
`FunctionCache.lookup` flow is not used (its own tests,
`tests/test_compile_cache.py::test_lookup_miss_mem_hit_flow` and
`test_aot_roundtrip_serves_without_compilation`, fail with the installed
jax); the port's own flow runs once, cold then warm, in two fresh
interpreters over one store (`torch_cache_child.py`): a 2-layer GPT of
width 64 under `to_static` with Inductor on the CPU, the static
Executor's program, and a function whose tensor `if` becomes a
`torch.cond` (a graph Inductor's FX-graph cache does not take).  The warm
interpreter gets a fresh FX-graph and AOTAutograd cache, and the C++
kernels' shared objects that the cold one built: on the card the Triton
kernels' binaries travel inside the store's entries, on the CPU Inductor
keeps the C++ objects beside its caches, outside the carrier.
"""
import hashlib
import inspect
import json
import os
import shutil
import subprocess
import sys
import textwrap
import warnings

import pytest
import torch

from paddle_tpu import observability as jobs
from paddle_tpu.jit import compile_cache as jcc
from paddle_tpu.observability import compile_tracker as jct
from paddle_tpu.observability.metrics import MetricsRegistry as JRegistry
from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu_torch import jit, observability as tobs
from paddle_tpu_torch.jit import compile_cache as tcc
from paddle_tpu_torch.observability import compile_tracker as tct
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.resilience import chaos as tchaos

import torch_cpu_threads

torch_cpu_threads.limit()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jcc, jchaos), "torch": (tcc, tchaos)}


@pytest.fixture(autouse=True)
def _registries():
    """A fresh metrics registry in each package; no cache configured
    after the test."""
    jobs.enable(JRegistry())
    tobs.enable(MetricsRegistry())
    yield
    jobs.disable()
    tobs.disable()
    jcc.reset()
    tcc.reset()


def _digest(s):
    return hashlib.sha256(s.encode()).hexdigest()


# ===================================================================
# the store, step for step against the reference
# ===================================================================
def _store_run(pkg, root, mode):
    """One sequence of puts (deterministic ages), a corruption of the
    newest entry, gets of every key, a last put that GCs: what it left."""
    cc, chaos = PACKAGES[pkg]
    c = cc.CompileCache(str(root), max_bytes=3200)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for i in range(4):
            c.put(_digest(f"e{i}"), bytes([i]) * 600, meta={"label": "t"})
            os.utime(c._path(_digest(f"e{i}")), (i + 1, i + 1))
        victim = os.path.basename(chaos.corrupt_cache_entry(str(root),
                                                            mode=mode))
        got = {i: c.get(_digest(f"e{i}")) for i in range(4)}
        c.put(_digest("e4"), b"\x04" * 900)
    warned = [x for x in w if issubclass(x.category,
                                         cc.CacheUnavailableWarning)]
    q = root / "quarantine"
    return {"victim": victim,
            "got": {i: None if v is None else len(v)
                    for i, v in got.items()},
            "survivors": sorted(n for n in os.listdir(root)
                                if n.endswith(".ccx")),
            "quarantined": sorted(n.split(".")[0] for n in os.listdir(q))
            if q.is_dir() else [],
            "warnings": len(warned), "stats": {
                k: cc.stats()[k] for k in ("quarantined", "evictions",
                                           "puts")}}


@pytest.mark.parametrize("mode", ["flip", "truncate", "garbage"])
def test_store_matches_the_reference_step_for_step(tmp_path, mode):
    runs = {}
    for pkg in PACKAGES:
        (tmp_path / pkg).mkdir()
        runs[pkg] = _store_run(pkg, tmp_path / pkg, mode)
    assert runs["torch"] == runs["jax"]
    r = runs["torch"]
    assert r["victim"] == _digest("e3") + ".ccx"
    assert r["got"] == {0: 600, 1: 600, 2: 600, 3: None}
    assert r["quarantined"] == [_digest("e3")] and r["warnings"] == 1
    # the budget of 3200 bytes keeps the fresh entry and the newest
    # survivors: e0 went first
    assert _digest("e4") + ".ccx" in r["survivors"]
    assert _digest("e0") + ".ccx" not in r["survivors"]


def test_entries_are_read_by_either_package(tmp_path):
    """One format: an entry either package wrote, the other reads."""
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        d = tmp_path / writer
        d.mkdir()
        PACKAGES[writer][0].CompileCache(str(d)).put(_digest("k"),
                                                     b"\x07" * 999)
        assert PACKAGES[reader][0].CompileCache(str(d)).get(
            _digest("k")) == b"\x07" * 999


def test_unwritable_dir_degrades_with_one_warning_as_the_reference(
        tmp_path):
    counts = {}
    for pkg, (cc, _) in PACKAGES.items():
        blocker = tmp_path / f"{pkg}_file"
        blocker.write_text("occupied")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            c = cc.configure(str(blocker))
            c.put(_digest("m"), b"mem-only")
            assert c.get(_digest("m")) == b"mem-only"
            c.put(_digest("m2"), b"more")
        counts[pkg] = (sum(issubclass(x.category,
                                      cc.CacheUnavailableWarning)
                           for x in w), cc.stats()["degraded"])
        cc.reset()
    assert counts["torch"] == counts["jax"] == (1, 1)


def test_corrupt_cache_entry_picks_by_age_and_rejects_a_bad_mode(
        tmp_path):
    for pkg, (cc, chaos) in PACKAGES.items():
        d = tmp_path / pkg
        d.mkdir()
        c = cc.CompileCache(str(d))
        for i in range(3):
            c.put(_digest(f"a{i}"), b"x" * 100)
            os.utime(c._path(_digest(f"a{i}")), (i + 1, i + 1))
        assert os.path.basename(chaos.corrupt_cache_entry(
            str(d), which=1, mode="truncate")) == _digest("a1") + ".ccx"
        with pytest.raises(ValueError, match="unknown corruption mode"):
            chaos.corrupt_cache_entry(str(d), mode="melt")
        with pytest.raises(FileNotFoundError):
            chaos.corrupt_cache_entry(str(tmp_path))


# ===================================================================
# keys
# ===================================================================
class _Hyper:
    """A plain object: both packages fingerprint its simple state."""

    def __init__(self, momentum, nested=None, **extra):
        self.momentum = momentum
        self.scales = [1.0, 2.0]
        self.opts = {"b": 1, "a": "x", "t": object()}
        self.nested = nested
        self._step_count = 0
        self.__dict__.update(extra)


@pytest.mark.parametrize("change,moves", [
    (lambda o: setattr(o, "momentum", 0.5), True),
    (lambda o: o.scales.append(3.0), True),
    (lambda o: o.opts.update(a="y"), True),
    (lambda o: setattr(o.nested, "eps", 1e-6), True),
    (lambda o: setattr(o, "_step_count", 7), False),      # runtime state
    (lambda o: setattr(o, "training", False), False),
    (lambda o: o.opts.update(t=object()), False),         # not simple
])
def test_config_fingerprint_moves_for_the_same_changes(change, moves):
    out = {}
    for pkg, (cc, _) in PACKAGES.items():
        o = _Hyper(0.9, nested=_Hyper(0.1, eps=1e-8), training=True)
        before = cc.config_fingerprint(o)
        change(o)
        out[pkg] = (before, cc.config_fingerprint(o))
    assert out["torch"] == out["jax"]
    assert (out["torch"][0] != out["torch"][1]) is moves


def test_digest_keys_signature_static_code_and_device():
    fc = tcc.FunctionCache("t", fingerprint=("src",))
    a = ((torch.ones(2, 3),), {})
    d = fc.digest(a, device="cpu")
    assert d == fc.digest(((torch.zeros(2, 3),), {}), device="cpu")
    for other in (((torch.ones(2, 4),), {}),
                  ((torch.ones(2, 3, dtype=torch.float64),), {}),
                  ((torch.ones(2, 3, requires_grad=True),), {}),
                  ((torch.ones(2, 3), True), {}),
                  ((), {"x": torch.ones(2, 3)})):
        assert fc.digest(other, device="cpu") != d, other
    assert fc.digest(a, static=("train",), device="cpu") != d
    assert tcc.FunctionCache("t", fingerprint=("other",)).digest(
        a, device="cpu") != d
    fp = tcc.env_fingerprint("cpu")
    assert {"torch", "cuda", "platform", "device_kind", "capability",
            "n_devices", "kernels", "package"} <= set(fp)
    assert fp["torch"] == torch.__version__ and fp["package"] == "0.1.0"


def test_no_donated_twin_is_an_intended_divergence():
    """torch has no buffer donation: the port has no donated twin, no
    PADDLE_TPU_CACHE_DONATED, and what a process compiles is what it
    publishes."""
    assert jcc._ENV_DONATED == "PADDLE_TPU_CACHE_DONATED"
    assert "plain_jit" in inspect.signature(
        jcc.FunctionCache.lookup).parameters
    assert not hasattr(tcc, "_ENV_DONATED")
    assert not hasattr(tcc.FunctionCache, "lookup")
    assert "PADDLE_TPU_CACHE_DONATED" not in open(tcc.__file__).read() \
        .split('"""', 2)[2]


# ===================================================================
# the lock-free race between two processes
# ===================================================================
def test_two_processes_race_without_torn_reads(tmp_path):
    """Two writers hammer the same digests with different payload sizes;
    last-writer-wins never publishes a torn entry (a reader would
    quarantine it), leaves no temp file, and either package reads every
    surviving entry."""
    worker = textwrap.dedent(f"""
        import sys, hashlib
        sys.path.insert(0, {REPO!r})
        from paddle_tpu_torch.jit.compile_cache import CompileCache
        c = CompileCache(sys.argv[1], max_bytes=1 << 30)
        payload = sys.argv[2].encode() * int(sys.argv[3])
        for i in range(250):
            d = hashlib.sha256(str(i % 7).encode()).hexdigest()
            c.put(d, payload, meta={{"writer": sys.argv[2]}})
            assert c.get(d) is not None, "published entry vanished"
        print("OK", flush=True)
    """)
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(tmp_path), tag, size],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag, size in (("a", "400"), ("b", "90000"))]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        assert "OK" in out
    live = [n for n in os.listdir(tmp_path) if n.endswith(".ccx")]
    assert len(live) == 7
    for cc, _ in PACKAGES.values():
        reader = cc.CompileCache(str(tmp_path))
        for n in live:
            assert reader.get(n[:-len(".ccx")]) in (b"a" * 400,
                                                    b"b" * 90000)
    assert not (tmp_path / "quarantine").exists()
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


# ===================================================================
# the chaos sites
# ===================================================================
@pytest.mark.parametrize("site", ["cache.corrupt", "cache.race",
                                  "cache.evict_inflight"])
def test_cache_sites_act_as_the_reference(tmp_path, site):
    out = {}
    for pkg, (cc, chaos) in PACKAGES.items():
        (tmp_path / pkg).mkdir()
        c = cc.CompileCache(str(tmp_path / pkg))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", cc.CacheUnavailableWarning)
            with chaos.scoped(f"{site}@1") as plan:
                c.put(_digest("s"), b"\x05" * 500)
                got = c.get(_digest("s"))
            fired = [e[0] for e in plan.log]
        out[pkg] = (fired, None if got is None else len(got),
                    cc.stats()["quarantined"], cc.stats()["evictions"],
                    sorted(os.listdir(tmp_path / pkg)))
    assert out["torch"] == out["jax"]
    fired, got, quarantined, evictions, _ = out["torch"]
    assert fired == [site]
    assert got == {"cache.corrupt": None, "cache.race": 500,
                   "cache.evict_inflight": None}[site]
    assert quarantined == (site == "cache.corrupt")
    assert evictions == (site == "cache.evict_inflight")


def test_compile_fail_once_raises_once_then_compiles(monkeypatch):
    monkeypatch.setattr(jit, "_BACKEND", "aot_eager")
    tct.reset()
    st = jit.to_static(lambda x: x * 3.0)
    with tchaos.scoped("compile.fail_once@1") as plan:
        with pytest.raises(tchaos.ChaosInterrupt):
            st(torch.ones(2))
        assert tct.compile_count(st._label) == 0    # rolled back
        assert torch.equal(st(torch.ones(2)), torch.full((2,), 3.0))
    assert plan.log == [("compile.fail_once", None, 1)]
    assert [e.cause for e in tct.events(st._label)] == ["first compile"]
    # a seen signature does not reach the site
    with tchaos.scoped("compile.fail_once@1") as plan:
        st(torch.ones(2))
    assert plan.log == []


# ===================================================================
# the tracker's persistent-hit event, as the reference's
# ===================================================================
def test_tracker_marks_a_persistent_hit_as_the_reference():
    from paddle_tpu.observability import trace as jtrace
    from paddle_tpu_torch.observability import trace as ttrace
    out = {}
    for pkg, ct, obs, trace in (("jax", jct, jobs, jtrace),
                                ("torch", tct, tobs, ttrace)):
        ct.reset()
        trace.clear()
        tok = ct.on_call("f", ct.signature_of([torch.ones(2).numpy()]),
                         owner=None)
        ev = ct.finish(tok, cache_hit=True)
        snap = {r["name"]: r["value"] for r in obs.registry().snapshot()
                if r["name"].startswith("jit_")}
        spans = [e["name"] for e in trace.events()
                 if e["name"].endswith(":f")]
        out[pkg] = (ev.cause, [e.cause for e in ct.events("f")], snap,
                    spans)
    assert out["torch"] == out["jax"] == (
        "persistent cache hit", ["persistent cache hit"],
        {"jit_persistent_cache_hits_total": 1}, ["cache-hit:f"])


# ===================================================================
# cold, then warm: two fresh interpreters over one store
# ===================================================================
def _child(store, inductor_dir):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "torch_cache_child.py"),
         str(store)], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, TORCHINDUCTOR_CACHE_DIR=str(inductor_dir),
                 PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cold_warm(tmp_path_factory):
    root = tmp_path_factory.mktemp("cold_warm")
    store = root / "store"
    cold = _child(store, root / "inductor_cold")
    entries = sorted(n for n in os.listdir(store) if n.endswith(".ccx"))
    # the warm interpreter's Inductor cache: no FX graph, no AOTAutograd
    # entry, the C++ kernels' shared objects the cold one built
    warm_dir = root / "inductor_warm"
    shutil.copytree(root / "inductor_cold", warm_dir, ignore=lambda d, n: [
        x for x in n if d == str(root / "inductor_cold")
        and x in ("fxgraph", "aotautograd", "locks")])
    assert not (warm_dir / "fxgraph").exists()
    warm = _child(store, warm_dir)
    return cold, warm, entries


def test_cold_run_publishes_what_it_compiled(cold_warm):
    cold, _, entries = cold_warm
    s = cold["stats"]
    # the GPT and the Executor's program published; the cond graph was
    # an uncacheable miss, nothing published for it
    assert (s["misses"], s["puts"], s["uncacheable"], s["hits"]) == \
        (3, 2, 1, 0)
    assert len(entries) == 2
    assert cold["uncacheable"] == ["Can't cache HigherOrderOperator: cond"]
    assert cold["inductor"]["fxgraph_cache_miss"] == 4     # fwd + bwd, x2
    assert [c for _, c in cold["events"]] == ["first compile"] * 3


def test_warm_restart_compiles_nothing_and_gives_equal_losses(cold_warm):
    cold, warm, _ = cold_warm
    assert warm["inductor"].get("fxgraph_cache_miss", 0) == 0
    assert warm["inductor"]["fxgraph_cache_hit"] == 4
    assert warm["aot"].get("autograd_cache_miss", 0) == 0
    assert warm["aot"]["autograd_cache_hit"] == 2
    s = warm["stats"]
    assert (s["hits"], s["hit_graphs"], s["puts"], s["stale"]) == \
        (2, 4, 0, 0)
    assert warm["gpt"] == cold["gpt"]             # bit for bit
    assert warm["executor"] == cold["executor"]
    assert warm["gate"] == cold["gate"] == [2.0] * 4
    causes = dict(warm["events"])
    assert causes["to_static(GPTForCausalLM)"] == "persistent cache hit"
    assert causes["to_static_fn(Program1)"] == "persistent cache hit"
    assert warm["compiles"]["to_static(GPTForCausalLM)"] == 0
    assert warm["compiles"]["to_static_fn(Program1)"] == 0


def test_uncacheable_graph_is_a_counted_miss_on_restart_too(cold_warm):
    _, warm, _ = cold_warm
    assert warm["stats"]["misses"] == warm["stats"]["uncacheable"] == 1
    assert warm["uncacheable"] == ["Can't cache HigherOrderOperator: cond"]
    assert warm["inductor"]["fxgraph_cache_bypass"] == 1
    assert dict(warm["events"])["to_static_fn(gate)"] == "first compile"
