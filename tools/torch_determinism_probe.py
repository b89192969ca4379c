#!/usr/bin/env python3
"""Which op of BERT-base's training step is not bit-reproducible on the
card, and what `torch.use_deterministic_algorithms` changes.

    python3 tools/torch_determinism_probe.py [--deterministic]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA sources (`chip_smoke.phase_build`), then, for
float32, O1 bfloat16 and O1 float16 (the loss scaled by 2**15, as
`chip_smoke.py`'s `bert_resume` scales it, and by 1): two forward and
backward passes of `BertForSequenceClassification(BertConfig())` (batch
32, seq 128, `chip_smoke.bert_batch`'s padded rows under a float mask,
dropout 0.1, TF32 off) from the same parameters and random state.  It
prints, per dtype, the first module (in forward order) whose output
differs between the passes, the first module (in backward order) whose
output gradient differs, and the parameters whose gradients differ, with
the largest difference.  Then `bert_resume`'s leg-1 loop (AdamW under
LinearWarmup(PolynomialDecay), ClipGradByGlobalNorm(1.0), O1 float16,
GradScaler(2**15)) runs 8 steps twice from one state, and its losses are
compared.  With `--deterministic`, CUBLAS_WORKSPACE_CONFIG=:4096:8 is set
before CUDA starts and `torch.use_deterministic_algorithms(True)`.
"""
import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def passes(model, batch, dtype, scale):
    """Forward outputs and output gradients of every module, and the
    parameter gradients, of one forward and backward pass."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as PF

    outs, grads, hooks = {}, {}, []

    def fwd(name):
        def hook(mod, inp, out):
            if isinstance(out, torch.Tensor):
                outs[name] = out.detach().clone()
                if out.requires_grad:
                    out.register_hook(
                        lambda g: grads.__setitem__(name, g.clone()))
        return hook

    for name, mod in model.named_modules():
        if name:
            hooks.append(mod.register_forward_hook(fwd(name)))
    ids, seg, mask, labels = batch
    try:
        with amp.auto_cast(enable=dtype != "float32", dtype=dtype):
            loss = PF.cross_entropy(model(ids, seg, attention_mask=mask),
                                    labels)
        (loss * scale).backward()
    finally:
        for h in hooks:
            h.remove()
    pgrads = {n: p.grad.clone() for n, p in model.named_parameters()
              if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), outs, grads, pgrads


def diff(a, b):
    return float((a.float() - b.float()).abs().max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    if args.deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available():
        print("torch_determinism_probe: no CUDA device", file=sys.stderr)
        return 1
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as lr_sched
    from paddle_tpu_torch.text import (BertConfig,
                                       BertForSequenceClassification)

    cs.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = BertConfig()
    ids, seg, labels, mask = cs.bert_batch(cfg, 32, 128, 3)
    batch = (ids, seg, mask.float(), labels)
    order = [n for n, _ in BertForSequenceClassification(
        cfg, device="cuda").named_modules() if n]
    rec = {"phase": "determinism", "deterministic": args.deterministic,
           "blas": str(torch.backends.cuda.preferred_blas_library())}
    for dtype, scale in (("float32", 1.0), ("bfloat16", 1.0),
                         ("float16", 1.0), ("float16", 2.0 ** 15)):
        model = BertForSequenceClassification(
            cfg, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(0))
        runs = []
        try:
            for _ in range(2):
                ptt.seed(1234)
                runs.append(passes(model, batch, dtype, scale))
        except RuntimeError as e:   # an op without a deterministic version
            rec[f"{dtype}_x{scale:g}"] = {"error": str(e)[:400]}
            del model
            cs.release()
            continue
        (l1, o1, g1, p1), (l2, o2, g2, p2) = runs
        fwd_bad = [n for n in order if n in o1 and diff(o1[n], o2[n])]
        bwd_bad = [n for n in reversed(order) if n in g1 and n in g2
                   and diff(g1[n], g2[n])]
        par_bad = {n: diff(p1[n], p2[n]) for n in p1 if diff(p1[n], p2[n])}
        rec[f"{dtype}_x{scale:g}"] = {
            "loss_equal": l1 == l2,
            "first_forward_output_differing": fwd_bad[:1],
            "forward_outputs_differing": len(fwd_bad),
            "first_output_grads_differing_in_backward_order": bwd_bad[:3],
            "output_grads_differing": len(bwd_bad),
            "param_grads_differing": len(par_bad),
            "param_grads_max_diff": max(par_bad.values(), default=0.0),
            "param_grads_differing_names": sorted(par_bad)[:8]}
        del model, runs
        cs.release()

    def loop():
        model = BertForSequenceClassification(
            cfg, num_classes=2, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(0))
        sched = lr_sched.LinearWarmup(
            lr_sched.PolynomialDecay(2e-5, decay_steps=16, end_lr=2e-6),
            warmup_steps=2, start_lr=0.0, end_lr=2e-5)
        opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
        ptt.seed(1234)
        losses = []
        for _ in range(8):
            with amp.auto_cast(dtype="float16"):
                loss = PF.cross_entropy(
                    model(ids, seg, attention_mask=batch[2]), labels)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            sched.step()
            losses.append(loss.item())
        return losses

    try:
        a, b = loop(), loop()
        rec["leg1_loop"] = {"a": a, "b": b, "equal": a == b}
    except RuntimeError as e:
        rec["leg1_loop"] = {"error": str(e)[:400]}
    cs.emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
