"""The port's public surface against the JAX package's (ROADMAP.md C8).

For every module of `paddle_tpu_torch/` with a same-path module in
`paddle_tpu/`, the reference's public names are read with `ast`: the
functions, classes and assignments at module level, a package's
relative re-exports, and the names its `_LAZY` table binds on first use.
Each must exist on the imported port module, and each reference
callable's parameter names must be parameters of the port's callable
(a class: its `__init__`).  `LEFT_OUT` lists what is not ported yet,
each entry under its ROADMAP.md queue item (A11 distributed, A13a the
`nn` surface, A13b the rest of the surface) or "jax" for a name of the
JAX machinery itself (PRNG keys, the op registry and its kernels,
PartitionSpec helpers, pytree selects), which has no counterpart in
torch.  An entry that the port has gained fails the test too, so the
list only shrinks.  A star-imported name is checked on the importing
module; one that `LEFT_OUT` lists under the module it comes from is not
listed again under the importer.  Then one call each for the C8 items.
"""
import ast
import importlib
import inspect
import os

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUEUE_ITEMS = {"A11", "A13a", "A13b", "jax"}


# (module, queue item): names not ported yet
LEFT_OUT = {
    ("__init__.py", "A13b"): (
        "audio distribution geometric hub onnx quantization sparse "
        "sysconfig utils version"
    ),
    # JAX's own 64-bit switch: the port keeps torch's real 64-bit types
    ("__init__.py", "jax"): "enable_x64 x64_enabled",
    ("distributed/__init__.py", "A11"): (
        "Partial PipelineLayer Placement ProcessMesh Replicate Shard "
        "auto_parallel dtensor_from_fn gpipe_spmd pipeline_apply "
        "reshard shard_tensor"
    ),
    ("distributed/fleet_engine.py", "jax"): "param_pspec state_pspec",
    ("dtypes.py", "jax"): "enable_x64 x64_enabled",
    ("distributed/mesh.py", "jax"): "replicated sharding",
    ("distributed/ring_attention.py", "jax"): "make_ring_flash_local",
    ("framework/checkpoint.py", "A11"): "load_state(resharder)",
    ("framework/random.py", "jax"): "default_key key_context next_key",
    # the functional bridge and the tape engine are JAX machinery: Dynamo
    # and torch's autograd take their places
    ("jit/__init__.py", "jax"): "FB engine",
    ("jit/save_load.py", "jax"): (
        "TranslatedLayer(exported,params,buffers,aot_exec)"
    ),
    # jax.jit's lowering / compile split: torch.compile compiles in the
    # first call
    ("observability/compile_tracker.py", "jax"): "aot_profile",
    ("ops/__init__.py", "jax"): (
        "call call_raw dispatch kernels override pallas register"
    ),
    ("ops/nn_kernels.py", "jax"): (
        "adaptive_avg_pool2d_k adaptive_avg_pool2d_nhwc_k "
        "adaptive_max_pool2d_k avg_pool2d_k avg_pool2d_nhwc_k "
        "avg_pool3d_k batch_norm_infer_k batch_norm_train_k "
        "bce_with_logits_k conv1d_k conv2d_k conv2d_transpose_k "
        "conv3d_k conv3d_transpose_k ctc_loss_k embedding_k fold_k "
        "gather_tree_k group_norm_k instance_norm_k interpolate_k "
        "layer_norm_k local_response_norm_k max_pool2d_index_k "
        "max_pool2d_k max_pool2d_nhwc_k max_pool3d_k max_unpool2d_k "
        "paged_attention_k paged_write_k pixel_shuffle_k rms_norm_k "
        "s2d_stem_conv_k s2d_stem_conv_nhwc_k sdpa_k softmax_ce_k "
        "temporal_shift_k"
    ),
    ("resilience/__init__.py", "A11"): "ReshardPlan Resharder reshard",
    ("resilience/guard.py", "jax"): "select_tree",
    ("text/__init__.py", "A13b"): (
        "BPETokenizer CharTokenizer ViterbiDecoder datasets tokenizer "
        "viterbi_decode"
    ),
    ("text/decode.py", "jax"): (
        "jit_generate(seed_key) speculative_generate(seed_key)"
    ),
    ("vision/__init__.py", "A13b"): "ops",
    ("vision/models/__init__.py", "A13b"): (
        "AlexNet DenseNet GoogLeNet InceptionV3 LeNet MobileNetV1 "
        "MobileNetV2 MobileNetV3Large MobileNetV3Small ShuffleNetV2 "
        "SqueezeNet VGG alexnet densenet121 densenet161 densenet169 "
        "densenet201 densenet264 googlenet inception_v3 mobilenet_v1 "
        "mobilenet_v2 mobilenet_v3_large mobilenet_v3_small resnet152 "
        "resnext50_32x4d shufflenet_v2_swish shufflenet_v2_x0_25 "
        "shufflenet_v2_x0_33 shufflenet_v2_x0_5 shufflenet_v2_x1_0 "
        "shufflenet_v2_x1_5 shufflenet_v2_x2_0 squeezenet1_0 "
        "squeezenet1_1 vgg11 vgg13 vgg16 vgg19 wide_resnet50_2"
    ),
    ("vision/models/resnet.py", "A13b"): (
        "resnet152 resnext50_32x4d wide_resnet50_2"
    ),
}


def _params(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _inner_params(factory):
    """The parameters of the function a factory def returns."""
    for node in ast.walk(factory):
        if node is not factory and isinstance(node, ast.FunctionDef):
            return _params(node)
    return None


def _loop_names(node, defs):
    """{name: params} of `for _n in (<strings>): globals()[_n] = f(_n)`."""
    if not (isinstance(node.iter, (ast.Tuple, ast.List)) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in node.iter.elts)):
        return {}
    for stmt in node.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Subscript) and \
                isinstance(stmt.targets[0].value, ast.Call) and \
                getattr(stmt.targets[0].value.func, "id", None) == \
                "globals":
            call = stmt.value
            factory = defs.get(getattr(getattr(call, "func", None), "id",
                                       None))
            params = _inner_params(factory) if factory is not None else None
            return {e.value: params for e in node.iter.elts}
    return {}


def _star_source(path, node):
    """The file a `from .x import *` in `path` reads."""
    base = os.path.dirname(path)
    for _ in range(node.level - 1):
        base = os.path.dirname(base)
    stem = os.path.join(base, *(node.module or "").split("."))
    return stem + ".py" if os.path.exists(stem + ".py") else \
        os.path.join(stem, "__init__.py")


def _star_all(path):
    """The source module's `__all__` (a literal list), or None."""
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            try:
                return set(ast.literal_eval(node.value))
            except ValueError:
                return None
    return None


def _reference_names(path, star_sources=None):
    """{public name: parameter names, or None for a non-callable}; a
    star-imported name's source file goes into `star_sources`."""
    tree = ast.parse(open(path).read())
    package = os.path.basename(path) == "__init__.py"
    defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    names = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            init = [b for b in node.body if isinstance(b, ast.FunctionDef)
                    and b.name == "__init__"]
            names[node.name] = _params(init[0]) if init else None
        elif isinstance(node, ast.For):
            for k, v in _loop_names(node, defs).items():
                names.setdefault(k, v)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.setdefault(t.id, None)
            if any(isinstance(t, ast.Name) and t.id == "_LAZY"
                   for t in node.targets):
                v = node.value
                keys = v.keys if isinstance(v, ast.Dict) else \
                    getattr(v, "elts", [])
                for k in keys:
                    names.setdefault(k.value, None)
        elif isinstance(node, ast.ImportFrom) and node.level and package:
            for a in node.names:
                if a.name != "*":
                    names.setdefault(a.asname or a.name, None)
                    continue
                src = _star_source(path, node)
                public = _star_all(src)
                for k, v in _reference_names(src).items():
                    if public is None or k in public:
                        names.setdefault(k, v)
                        if star_sources is not None:
                            star_sources.setdefault(k, src)
    return {k: v for k, v in names.items() if not k.startswith("_")}


def _pairs():
    root = os.path.join(REPO, "paddle_tpu_torch")
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            ref = os.path.join(REPO, "paddle_tpu", rel)
            if f.endswith(".py") and f != "__main__.py" and \
                    os.path.exists(ref):
                yield rel, ref


def _module(rel):
    mod = rel[:-3].replace(os.sep, ".")
    if mod.endswith("__init__"):
        mod = mod[:-len("__init__")].rstrip(".")
    return importlib.import_module(
        "paddle_tpu_torch" + ("." + mod if mod else ""))


def _port_params(obj):
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return list(sig.parameters)


def surface_gaps():
    """{(module, name or name(params)) ...} the port lacks; a
    star-imported name that `LEFT_OUT` lists under its source module is
    left to that entry."""
    gaps = set()
    listed = _left_out()
    ref_root = os.path.join(REPO, "paddle_tpu")
    for rel, ref in _pairs():
        mod = _module(rel)
        sources = {}
        for name, params in _reference_names(ref, sources).items():
            if name in sources and any(
                    r == os.path.relpath(sources[name], ref_root)
                    and e.split("(")[0] == name for r, e in listed):
                continue
            if not hasattr(mod, name):
                gaps.add((rel, name))
                continue
            ours = _port_params(getattr(mod, name))
            if params is None or ours is None:
                continue
            missing = [p for p in params if p not in ours]
            if missing:
                gaps.add((rel, f"{name}({','.join(missing)})"))
    return gaps


def _left_out():
    return {(rel, name): item for (rel, item), names in LEFT_OUT.items()
            for name in names.split()}


def test_left_out_names_a_queue_item():
    assert {item for _, item in LEFT_OUT} <= QUEUE_ITEMS


def test_public_names_and_parameters_match_the_reference():
    gaps = surface_gaps()
    listed = set(_left_out())
    assert sorted(gaps - listed) == [], "missing from the port"
    assert sorted(listed - gaps) == [], "listed but ported: drop them"


# ----------------------------------------------------- the C8 items, a call
def test_text_exports_lora_and_the_converters():
    from paddle_tpu_torch import text
    from paddle_tpu_torch.text import convert, peft
    assert text.LoRAConfig is peft.LoRAConfig
    assert text.get_peft_model is peft.get_peft_model
    assert text.LoRAModel is peft.LoRAModel
    assert text.LoRALinear is peft.LoRALinear
    for arch in ("llama", "qwen2", "gpt2", "bert", "ernie"):
        name = f"convert_hf_{arch}"
        assert getattr(text, name) is getattr(convert, name)


def test_resilience_exports_backoff():
    from paddle_tpu_torch import resilience
    assert resilience.Backoff(base=0.5).delay(1) == 1.0
    assert resilience.CrashLoopDetector(threshold=2).record_failure() is \
        False
    assert resilience.backoff.Backoff is resilience.Backoff


def test_subpackages_bind_lazily():
    import subprocess
    import sys
    code = ("import sys, paddle_tpu_torch as p\n"
            "assert 'paddle_tpu_torch.serving' not in sys.modules\n"
            "assert p.jit.train_step and p.serving.LLMEngine\n"
            "assert p.vision.models.resnet18 and p.inference.Config\n"
            "assert p.DataParallel is p.distributed.DataParallel\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=120)


def test_train_step_takes_donate_in_the_reference_position():
    from paddle_tpu_torch.jit import TrainStep, train_step
    from paddle_tpu_torch.optimizer import SGD
    model = torch.nn.Linear(2, 1)
    opt = SGD(parameters=model.parameters())
    loss_fn = lambda m, x: m(x).sum()          # noqa: E731
    step = train_step(model, loss_fn, opt, donate=False)
    assert step(torch.ones(1, 2)).shape == ()
    assert list(inspect.signature(TrainStep).parameters)[:5] == \
        ["model", "loss_fn", "optimizer", "donate", "guard"]


def test_resnet_blocks_take_norm_layer():
    from paddle_tpu_torch.vision.models.resnet import (BasicBlock,
                                                       BottleneckBlock)
    norm = lambda c: torch.nn.GroupNorm(2, c)  # noqa: E731
    b = BasicBlock(8, 8, norm_layer=norm, device="cpu")
    assert isinstance(b.bn1, torch.nn.GroupNorm)
    assert b(torch.zeros(1, 8, 4, 4)).shape == (1, 8, 4, 4)
    bb = BottleneckBlock(32, 8, norm_layer=norm, device="cpu")
    assert isinstance(bb.bn3, torch.nn.GroupNorm)


def test_gauge_inc_dec_and_input_spec_from_tensor():
    from paddle_tpu_torch.jit.save_load import InputSpec
    from paddle_tpu_torch.observability.metrics import Gauge
    g = Gauge()
    g.inc(3)
    g.dec()
    assert g.value == 2
    spec = InputSpec.from_tensor(torch.zeros(2, 5, dtype=torch.int64), "ids")
    assert (spec.shape, spec.dtype, spec.name) == ((2, 5), torch.int64,
                                                   "ids")
