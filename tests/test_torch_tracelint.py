"""tracelint of the port (`paddle_tpu_torch.analysis`) against the JAX
package's (`paddle_tpu.analysis`).

Each carried rule fires on its seeded hazard in torch spelling and on
nothing else, at the rule id, line and function where the reference's
`lint_source` reports the same hazard in JAX spelling (pairs built on
`tests/test_tracelint.py`'s HAZARDS corpus); suppression and a syntax
error reported, not raised; `to_static(check=True)` and
PADDLE_TPU_TRACELINT=1 warn while what is traced does not change (the
outputs equal the unchecked run's and the JAX package's), `check=False`
stays silent; RecompileWarning names the rule; the CLI's `--json` and
`--self` against the port's baseline; zero error findings over the
port's `text`, `nn` and `vision`; the registry audit clean on the live
port and flagging each seeded fault; and one test for each intended
divergence (`analysis.DYNAMO_DIVERGENCES`: the rules reworded or silent
under Dynamo).
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import analysis as janalysis
from paddle_tpu_torch import analysis, jit
from paddle_tpu_torch.analysis import cli
from paddle_tpu_torch.analysis import registry_audit as raudit
from paddle_tpu_torch.observability import compile_tracker as ct
from test_tracelint import HAZARDS

import torch_cpu_threads

torch_cpu_threads.limit()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the same hazards in torch spelling, on the same lines as the JAX ones
TORCH_HAZARDS = {
    "TL001": "def forward(x):\n    v = x.item()\n    return v\n",
    "TL002": "def forward(x):\n    return float(x.sum())\n",
    "TL003": ("import time\n"
              "def forward(x):\n    t = time.perf_counter()\n"
              "    return x * t\n"),
    "TL004": ("import numpy as np\n"
              "def forward(x):\n"
              "    return x + torch.as_tensor(np.random.randn(4))\n"),
    "TL005": "def forward(x):\n    print(x.size())\n    return x\n",
    "TL006": ("def forward(x):\n"
              "    global STEP\n    STEP = STEP + 1\n    return x\n"),
    "TL007": ("def forward(x):\n"
              "    if torch.any(x > 0):\n        return x\n"
              "    return x * 2\n"),
    "TL009": ("def forward(x,\n"
              "            scales=[1.0, 2.0]):\n"
              "    return x * scales[0]\n"),
    "TL010": ("def forward(x):\n"
              "    if x.size(0) > 128:\n        x = x * 2\n"
              "    return x\n"),
    "TL011": ("def forward(self, x):\n"
              "    if x.mean() > 0:\n        self.cache[0] = x\n"
              "    return x\n"),
    "TL012": ("def forward(x):\n    assert torch.all(x > 0)\n"
              "    return x\n"),
}
JAX_TL013 = ("import jax.numpy as jnp\n"
             "def decode(model, ids, b, d, max_new):\n"
             "    for t in range(max_new):\n"
             "        k = jnp.zeros((b, t + 1, d))\n"
             "        ids = model(ids, k)\n"
             "    return ids\n")
TORCH_TL013 = JAX_TL013.replace("import jax.numpy as jnp",
                                "import torch").replace("jnp.", "torch.")
PAIRS = {r: (HAZARDS[r], TORCH_HAZARDS[r]) for r in TORCH_HAZARDS}
PAIRS["TL013"] = (JAX_TL013, TORCH_TL013)
# torch idioms a forward may hold with no hazard
CLEAN = ("import torch\n"
         "def forward(self, x, mask=None, dim: int = -1):\n"
         "    b, s = x.size(0), x.shape[1]\n"
         "    h = torch.zeros(b, s, 4, device=x.device)\n"
         "    if mask is not None:\n"
         "        h = h + mask\n"
         "    if x.device.type == 'cuda':\n"
         "        h = h * 2\n"
         "    y = torch.where(x > 0, x, -x).reshape(b, s)\n"
         "    for layer in self.layers:\n"
         "        y = layer(y)\n"
         "    return torch.softmax(y + torch.randn_like(y), dim=dim)\n")


def _where(findings, rule):
    return [(f.rule, f.line, f.func) for f in findings if f.rule == rule]


# ===================================================================
# the rules against the reference
# ===================================================================
def test_catalog_keeps_the_reference_ids_and_severities():
    ours, ref = analysis.all_rules(), janalysis.all_rules()
    assert sorted(ours) == sorted(ref)
    for rid, rule in ours.items():
        assert (rule.severity, rule.name, rule.host) == \
            (ref[rid].severity, ref[rid].name, ref[rid].host), rid
    assert set(analysis.DYNAMO_DIVERGENCES) <= set(ours)
    assert set(analysis.DYNAMO_DIVERGENCES.values()) == {"reworded",
                                                         "silent"}


@pytest.mark.parametrize("rule_id", sorted(PAIRS))
def test_rule_fires_where_the_reference_does(rule_id):
    jax_src, torch_src = PAIRS[rule_id]
    ours = analysis.lint_source(torch_src, "<t>")
    ref = janalysis.lint_source(jax_src, "<t>")
    assert _where(ours, rule_id), f"{rule_id} did not fire"
    assert _where(ours, rule_id) == _where(ref, rule_id)
    # and on nothing else: the torch fixture trips no other rule
    assert {f.rule for f in ours} == {rule_id}


def test_clean_torch_idioms_fire_nothing():
    assert analysis.lint_source(CLEAN, "<t>") == []


def test_taint_reads_torch_metadata_and_creators():
    import ast
    from paddle_tpu_torch.analysis import core, taint
    src = ("def forward(x, axis: int, flag=True):\n"
           "    n = x.size(0)\n    m = x.numel()\n    d = x.device\n"
           "    z = torch.zeros(3)\n    p = x is None\n    return n\n")
    fctx = core.FunctionContext(ast.parse(src).body[0], "<t>", "forward",
                                trace_path=True)
    env = taint.TaintPass(fctx).run()
    assert (env["x"], env["z"]) == (taint.TENSOR, taint.TENSOR)
    assert (env["n"], env["m"]) == (taint.SHAPE, taint.SHAPE)
    assert (env["d"], env["p"], env["axis"], env["flag"]) == \
        (taint.UNTAINTED,) * 4


def test_suppression_and_host_functions_as_the_reference():
    src = ("def forward(x):\n"
           "    a = x.item()  # tracelint: disable=TL001\n"
           "    b = x.tolist()  # tracelint: disable\n"
           "    c = x.numpy()  # tracelint: disable=TL999\n"
           "    return a, b, c\n")
    assert [f.line for f in analysis.lint_source(src)] == \
        [f.line for f in janalysis.lint_source(src)] == [4]
    assert analysis.lint_source("def load(p):\n    return p.item()\n") \
        == []


def test_syntax_error_is_reported_not_raised():
    fs = analysis.lint_source("def broken(:\n", "bad.py")
    assert [(f.rule, f.severity, f.file) for f in fs] == \
        [("TL999", "error", "bad.py")]


# ===================================================================
# to_static(check=True), the env switch, the recompile cross-reference
# ===================================================================
class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 4)

    def forward(self, x):
        print("tracing")
        return self.fc(x)


def test_check_true_warns_and_keeps_semantics(monkeypatch):
    """check=True warns (TL005 on the print) and what is traced does not
    change: the checked and unchecked runs give the same outputs, and so
    does the JAX package's to_static(check=True) on the same weights.
    Eager (enable_to_static(False)) on both sides: a print breaks
    Dynamo's graph, which full_graph=True raises on."""
    net = _Net()
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)

    class JNet(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pt.nn.Linear(4, 4)

        def forward(self, x):
            print("tracing")
            return self.fc(x)

    jnet = JNet()
    jnet.fc.weight.set_value(net.fc.weight.detach().numpy().T)
    jnet.fc.bias.set_value(net.fc.bias.detach().numpy())
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        checked = jit.to_static(net, check=True)
        jchecked = pt.jit.to_static(jnet, check=True)
    ours = [str(i.message) for i in w
            if issubclass(i.category, analysis.TraceLintWarning)]
    assert len(ours) == 1 and "TL005" in ours[0]
    jit.enable_to_static(False)
    try:
        got = checked(torch.from_numpy(x))
        plain = jit.to_static(net)(torch.from_numpy(x))
    finally:
        jit.enable_to_static(True)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(jchecked(pt.to_tensor(x))._array),
        rtol=1e-5, atol=1e-6)


def test_check_true_on_a_function_compiles_as_unchecked(monkeypatch):
    monkeypatch.setattr(jit, "_BACKEND", "aot_eager")

    def f(x, scales=[2.0]):
        return x * scales[0]

    with pytest.warns(analysis.TraceLintWarning, match="TL009"):
        checked = jit.to_static(f, check=True)
    x = torch.arange(3.0)
    assert torch.equal(checked(x), jit.to_static(f)(x))


def test_env_switch(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TRACELINT", "1")

    @jit.not_to_static
    def f(x):
        t = x.item()
        return x * t

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jit.to_static(f)
    assert any("TL001" in str(i.message) for i in w
               if issubclass(i.category, analysis.TraceLintWarning))
    monkeypatch.setenv("PADDLE_TPU_TRACELINT", "0")
    assert not analysis.env_enabled()


def test_check_false_stays_silent(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TRACELINT", "1")

    def f(x):
        return x.item()

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jit.to_static(f, check=False)
        jit.to_static(f)       # check=None without the switch
        monkeypatch.delenv("PADDLE_TPU_TRACELINT")
        jit.to_static(f)
    assert [str(i.message) for i in w
            if issubclass(i.category, analysis.TraceLintWarning)] == \
        ["tracelint: " + analysis.lint_function(f)[0].render()]


def test_recompile_warning_names_the_static_rule(monkeypatch):
    assert analysis.static_rule_for_cause("shape change") == \
        janalysis.static_rule_for_cause("shape change") == "TL010"
    assert analysis.static_rule_for_cause("new static arg") == "TL009"
    assert analysis.static_rule_for_cause("guard failure") == "TL006"
    assert analysis.static_rule_for_cause("dtype change") is None
    monkeypatch.setattr(jit, "_BACKEND", "aot_eager")
    ct.reset()
    ct.set_warn_after(2)
    try:
        st = jit.to_static(lambda x: x + 1.0)
        with pytest.warns(ct.RecompileWarning, match="TL010"):
            for n in range(1, 5):
                st(torch.ones(n))
    finally:
        ct.set_warn_after(5)
        ct.reset()


# ===================================================================
# the CLI and the self-lint
# ===================================================================
def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))


def test_cli_json_and_self(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def forward(x):\n    return x.item()\n")
    r = _run_cli("--json", str(bad))
    assert r.returncode == 1, r.stderr
    data = json.loads(r.stdout)
    assert [(d["rule"], d["line"], d["func"]) for d in data] == \
        [("TL001", 2, "forward")]
    r = _run_cli("--self", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "registry audit OK" in r.stdout and " 0 new" in r.stdout


def test_self_lint_matches_the_package_baseline():
    assert cli.default_baseline_path() == os.path.join(
        REPO, "paddle_tpu_torch", "analysis", "tracelint_baseline.json")
    baseline = cli.load_baseline(cli.default_baseline_path())
    assert baseline
    fresh = [f.render() for target in cli.self_lint_targets()
             for f in analysis.lint_path(target)
             if cli.finding_key(f, REPO) not in baseline]
    assert fresh == []


@pytest.mark.parametrize("target", ["text", "nn", "vision"])
def test_port_has_zero_error_findings(target):
    fs = analysis.lint_path(os.path.join(REPO, "paddle_tpu_torch", target))
    assert [f.render() for f in fs if f.severity == "error"] == []


# ===================================================================
# the registry audit
# ===================================================================
def test_audit_is_clean_on_the_live_port():
    assert set(raudit.operator_names()) == {
        "paddle_tpu_torch::flash_fwd", "paddle_tpu_torch::flash_bwd",
        "paddle_tpu_torch::paged_decode",
        "paddle_tpu_torch::count_plain_sdpa"}
    assert analysis.audit_registry(device="cpu") == []


@pytest.fixture
def probe_op():
    """A seeded operator in the port's namespace, removed after the test
    (the live audit reads every `paddle_tpu_torch::` operator)."""
    from torch._library import custom_ops
    made = []

    def make(name, **kw):
        op = torch.library.custom_op(f"paddle_tpu_torch::{name}",
                                     mutates_args=(), **kw)(
            lambda x: x.clone())
        made.append(op)
        return op, f"paddle_tpu_torch::{name}"

    yield make
    for op in made:
        op._lib._destroy()
        custom_ops.OPDEFS.pop(op._qualname, None)


def test_audit_flags_a_missing_body_fake_and_sample(probe_op):
    probe, lib = probe_op("_audit_probe", device_types="cpu",
                          schema="(Tensor x) -> Tensor")
    ids = [(f.rule, f.message) for f in raudit.audit_live_registry("cpu")
           if f.func == lib]
    assert [r for r, _ in ids] == ["REG005", "REG005"]
    assert "CUDA body" in ids[0][1] and "fake implementation" in ids[1][1]
    probe.register_fake(lambda x: torch.empty_like(x))
    probe.register_kernel("cuda")(lambda x: x.clone())
    ids = [(f.rule, f.message) for f in raudit.audit_live_registry("cpu")
           if f.func == lib]
    assert ids == [("REG005", f"operator '{lib}' has no audit sample")]


def test_audit_flags_a_body_that_disagrees_with_its_fake(monkeypatch,
                                                         probe_op):
    samples = raudit._samples
    bad, lib = probe_op("_audit_bad_fake", schema="(Tensor x) -> Tensor")
    bad.register_fake(lambda x: x.new_empty(x.shape[0] + 1))
    monkeypatch.setattr(raudit, "_samples", lambda d: dict(
        samples(d), **{lib: (torch.ones(3),)}))
    found = [f for f in raudit.audit_live_registry("cpu") if f.func == lib]
    assert [f.rule for f in found] == ["REG004"]
    assert "opcheck" in found[0].message
    assert [f for f in raudit.audit_live_registry("cpu")
            if f.func != lib] == []


def test_audit_source_flags_each_seeded_fault(tmp_path):
    ops = tmp_path / "ops"
    ops.mkdir()
    (ops / "kern.py").write_text("def good():\n    pass\n")
    (ops / "__init__.py").write_text(
        "import torch\n"
        "from . import kern as _k\n"
        "def route(x):\n"
        "    _amp.cast_inputs('sdpa', 'sometimes', x)\n"
        "    return _k.good(x) + _k.gone(x)\n"
        "@torch.library.custom_op('paddle_tpu_torch::dup', mutates_args=())\n"
        "def a(x): ...\n"
        "@torch.library.custom_op('paddle_tpu_torch::dup', mutates_args=())\n"
        "def b(x): ...\n")
    found = {(f.rule, f.line) for f in raudit.audit_ops_source(str(ops))}
    assert found == {("REG001", 4), ("REG003", 5), ("REG002", 8)}
    assert raudit.audit_ops_source() == []


# ===================================================================
# the intended divergences under Dynamo
# ===================================================================
def test_tl008_is_silent_because_dynamo_lifts_closure_tensors(monkeypatch):
    """The reference bakes a closure tensor (TL008); Dynamo lifts it as a
    graph input, so an in-place update is seen by the next call."""
    monkeypatch.setattr(jit, "_BACKEND", "aot_eager")
    w = torch.ones(2)
    jw = pt.ones([2])

    def f(x):
        return x * w

    def jf(x):
        return x.matmul(jw)

    assert "TL008" in {f.rule for f in janalysis.lint_function(jf)}
    assert analysis.lint_function(f) == []
    assert analysis.DYNAMO_DIVERGENCES["TL008"] == "silent"
    assert analysis.all_rules()["TL008"].interests == ()
    st = jit.to_static(f)
    assert torch.equal(st(torch.ones(2)), torch.ones(2))
    w.mul_(3.0)
    assert torch.equal(st(torch.ones(2)), torch.full((2,), 3.0))


@pytest.mark.parametrize("rule_id", sorted(
    r for r, how in analysis.DYNAMO_DIVERGENCES.items() if how == "reworded"))
def test_reworded_rules_describe_dynamo(rule_id):
    jax_src, torch_src = PAIRS[rule_id]
    [ours] = [f for f in analysis.lint_source(torch_src)
              if f.rule == rule_id]
    [ref] = [f for f in janalysis.lint_source(jax_src)
             if f.rule == rule_id]
    assert (ours.line, ours.func, ours.severity) == \
        (ref.line, ref.func, ref.severity)
    assert ours.message != ref.message
    assert "Dynamo" in ours.message
    assert "jax" not in (ours.message + ours.hint).lower()


def test_reworded_hazards_hold_at_run_time(monkeypatch):
    """What the reworded messages say: a clock read, `random.*` and
    `print` break the graph (full_graph=True raises); a mutation of
    closure state is replayed on every call."""
    import random
    import time
    monkeypatch.setattr(jit, "_BACKEND", "aot_eager")
    for body in (lambda x: x * time.time(), lambda x: x * random.random(),
                 lambda x: (print(x.shape), x * 2)[1]):
        with pytest.raises(Exception, match="(?i)unsupported|skipped|"
                                            "graph break|trace"):
            jit.to_static(body)(torch.ones(2))
    history = []

    def g(x):
        history.append(1)
        return x * 2

    st = jit.to_static(g)
    for _ in range(3):
        st(torch.ones(2))
    assert history == [1, 1, 1]
