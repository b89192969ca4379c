#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA kernels from `paddle_tpu_torch/csrc/` into
`build/kernels/`, then:

1. build         — times the nvcc build (one nvcc per source, in
                   parallel) and prints ptxas's registers, shared memory
                   and spills for each sm90 flash kernel, each decode
                   kernel and each fp32 forward and backward kernel (the
                   fp32 backward's 12 with 0 spills, asserted);
1a. aot_compile  — exports and compiles with AOTInductor every package
                   that 4a, 5a, 5b and 23 load, four processes at once
                   (serve_aot's 2 programs, serve_aot_e2e's 2, ERNIE's
                   float32 and bf16 packages) at the lowest CPU
                   priority, started after the build and waited for
                   after 31: each job's seconds, the seconds they ran
                   beside other phases and the seconds waited;
2. kernels       — holds the paged decode kernel (context split across
                   blocks) against its plain PyTorch version on the card
                   at the serving path's shapes and at the split edges
                   (a row inside one partition, an empty row, a last
                   partition of one token, GQA groups 1 to 16 and
                   Qwen2's 6 and 7, bs 1), and against its one-pass
                   layout (`_splits=1`), with stated tolerances;
3. flash_kernels — holds the flash-attention forward (o, lse) and backward
                   (dq, dk, dv, given the same lse and delta) kernels
                   against their plain versions: the training shape in
                   bf16, fp16 and fp32, non-causal, Lq < Lk, ragged
                   lengths, GQA, masks, a window, D 64, Lq 1, a fully
                   masked row, the strided q/k/v views of a fused qkv,
                   and the generation paths' bool masks (a prefill into
                   a longer buffer, per-row decode and speculative
                   verify masks, with and without a window band, at GQA
                   32/8 and 28/4); every case through the routes,
                   asserting which family launched (forward: decode for
                   Lq <= 16, sm90 for bf16 / fp16 masked or not, fp32 for
                   float32, sm80 for the rest; backward: sm90 for bf16 /
                   fp16 masked or not, fp32 for float32, sm80 for the
                   rest), and through every other family that takes it
                   (the decode kernel also against its own plain version,
                   the same splits and merge; sm80 beside every fp32
                   backward; the fp32 forward and backward each twice,
                   equal bits);
                   each backward comparison beside a negative control
                   (the same comparison against the plain gradients of a
                   dO with one element moved must read a nonzero error),
                   and each float32 case's kernel and plain gradients
                   against a float64 plain backward;
3a. tensor_api   — every public function of the port's tensor_api,
                   linalg, fft and signal on the card, from the case
                   table the CPU tests read (tests/
                   torch_tensor_api_cases.py): each result on the card
                   and within its stated tolerance of the same function
                   on the CPU over the same inputs (TF32 off; the
                   decompositions by their invariants), random functions
                   by shape, dtype, range and seed determinism, as many
                   functions run as there are public names; the
                   functions that synchronised with the host printed;
4. serve         — GPT-3 1.3B (full width, 12 of its 24 layers:
                   SERVE_LAYERS, bf16, random weights
                   from a seed) served by LLMEngine: 16 requests, 32 greedy
                   tokens each; every request must finish, the pool must be
                   leak-free, and the paged kernel must have launched once
                   per layer per decode step; then a profile of a few
                   steady decode steps (device time by kernel);
4a. serve_aot    — serve's model, engine and requests from AOTInductor
                   packages: the inventory (decode, prefill 512: serve's
                   chunk of 512 with the one-bucket ladder [512], 2
                   programs, so that the compiles fit the script's time;
                   a shorter chunk pads to 512) compiled (seconds and
                   bytes a program, each package under 5 % of the
                   weight bytes: the weights are inputs), loaded strictly into a fresh
                   engine and served: tokens/s, decode step, TTFT, peak
                   memory beside serve's, a profile of AOT decode steps;
                   every call through a package, paged launches (called
                   back from the packages) = steps x 12, no plain sdpa,
                   no leak, bf16 tokens within MARGIN_TOL of a float32
                   forward's maximum;
5. e2e           — the same width at 2 layers in float32: the engine's
                   tokens are checked against a dense teacher-forced
                   forward of the same weights on the CPU;
5a. serve_aot_e2e — that model and engine with the ladder [128]: the
                   engine serving from packages compiled on the card
                   against the eager engine on the card and on the CPU,
                   token for token;
5b. serve_router — serve's traffic through a Router over two worker
                   processes (ProcReplica, each its own CUDA context),
                   GPT-3 1.3B bf16: tokens/s and the router's TTFT beside
                   serve's, each worker's decode steps, paged launches
                   (= steps x 12), plain sdpa calls (0), peak memory,
                   build, first-step and spawn-to-ready seconds; every
                   request finishes, no leak, no orphan, the workers'
                   probe logits equal the parent's bit for bit; worker
                   r1 starts from serve_aot's packages (`load_aot`): its
                   ready event reports all of them loaded, it serves
                   through them alone, and its start prints beside r0's;
5c. router_drill — `tools/torch_chaos_check.py --router --proc` at that
                   width, 4 layers (ROUTER_DRILL_LAYERS), in float32:
                   r0 SIGKILLed mid-stream 3x
                   (evictions / respawns / aborts 3 / 2 / 1), a dropped
                   frame, a wedged worker hang-evicted and KILLed; every
                   stream byte-identical to one uninterrupted in-process
                   engine, dedup >= 1, 0 mismatches, no leak, no orphan;
                   the smallest top-2 logit margin of the reference;
6. train         — GPT-3 1.3B trained as bench.py::run_gpt trains it: seq
                   1024, batch 4, AMP O2 bf16 without master weights,
                   Adafactor(1e-4), TrainStep; 3 warm-up and 10 timed
                   steps (tokens/s, step p50/p99, MFU, peak memory, the
                   loss series); each flash kernel must have launched 24
                   times a step, all three on the sm90 kernels, and sdpa
                   must have taken its plain path no time; then
                   check_numerics: TrainSteps with the flag off and on
                   in turns of 3 steps (off, on, on, off; the flagged
                   p50 beside the unflagged: the check's cost a step),
                   the check's device time alone, and a step whose loss
                   is multiplied by
                   NaN raises FloatingPointError naming `loss`, every
                   parameter bit-equal to its value before it; then a
                   profile of 2 steps through the port's
                   profiler.Profiler (a RecordEvent a step, counted),
                   its busy ms a step within 10 % of 2 more steps under
                   a bare torch.profiler window, and
                   profiler.program_stats of one forward and backward
                   within 0.85-1.15 of the model flops, the flash
                   operators' registered formulas giving the attention
                   term;
6a. fleet        — the distributed slice at world size 1 over NCCL:
                   `fleet.build_train_step` (dp 1, mp 1, sharding_stage
                   2) trains train's GPT-3 1.3B from the same weights and
                   batch, 10 steps: the losses equal TrainStep's bit for
                   bit, 24 sm90 forward, dK/dV and dQ launches a step,
                   step p50 and busy share; then `ring_attention` at the
                   training shape equals `flash_attention` (output and
                   the three gradients, bit for bit), one sm90 forward,
                   dK/dV and dQ a call;
7. train_e2e     — the same width at 2 layers in float32, AdamW, 3 steps:
                   the port on the card (through the kernels) against the
                   port on the CPU (through the plain versions), same
                   weights and batch: loss series and final parameters
                   (float32 runs the fp32 forward, dK/dV and dQ);
8. generate      — Mistral-7B (full width, 4 of its 32 layers:
                   GENERATE_LAYERS, bf16, random weights
                   from a seed), batch 4, 512-token prompts, 64 greedy
                   tokens: `generate(use_jit=True)` (the decode step
                   captured as a CUDA graph) against the eager loop
                   (concat caches) and the uncaptured static step, with
                   tokens/s, step p50/p99, prefill ms, peak memory and a
                   profile of each; beam search (4 beams, batch 1) and
                   speculative decoding (k 4, a 2-layer draft); each
                   path's flash launches by family (0 on sm80: decode
                   steps on the decode kernel, masked prefills on sm90),
                   sdpa's plain calls, and each bf16 token against a
                   dense float32 forward (`MARGIN_TOL`);
9. serve_llama   — Qwen2-7B (full width and depth, bf16, GQA 28/4) served
                   by LLMEngine with the serve phase's request mix:
                   tokens/s, decode step, TTFT, paged launches, and the
                   served tokens against a dense float32 forward;
10. generate_e2e — Mistral width at 2 layers, float32, window 64, 16
                   new tokens a row (32 before PR 21): the
                   captured `jit_generate`, eager and bucketed
                   `generate`, speculative greedy and `jit_beam_search`
                   on the card token for token against the CPU (the
                   decode steps through the decode kernel in float32),
                   and the captured step against the eager loop and the
                   uncaptured step;
11. timings      — paged kernel, plain version, library yardstick and the
                   memory bound at the phase-4 decode shapes; the one-pass
                   layout and the chosen split in turns (one, split,
                   split, one), and a sweep of split counts;
12. flash_timings — the same for each flash kernel at the training shape,
                   the sm80 and sm90 forward, dK/dV and dQ in turns on the
                   same inputs (sm80, sm90, sm90, sm80); the decode and
                   sm80 forward at the Mistral-7B decode shape in turns
                   with SDPA under the same mask, and a sweep of split
                   counts; the sm90 and sm80 forward at generation's
                   masked prefill (B 4, Lq 512, Lk 576) in turns, with
                   SDPA under the same mask; the fp32 and sm80 forward
                   and float32 SDPA at ERNIE's shape and at the
                   train_fp32 shape, and the float32 fp32 and sm80 dK/dV
                   and dQ beside float32 SDPA's backward (below);
13. train_llama  — LLaMA as bench.py::run_llama trains it on one card
                   (hidden 2048, 16 layers, 16 heads, intermediate 5504,
                   vocab 32000, seq 1024, batch 4, recompute, AMP O2 bf16
                   without master weights, Adafactor(1e-4), TrainStep):
                   3 warm-up and 10 timed steps, tokens/s, step p50/p99,
                   MFU, peak memory, losses; recompute launches the flash
                   forward twice a layer a step and dK/dV and dQ once,
                   all on sm90, and sdpa its plain path no time;
14. train_llama_e2e — 2 layers, hidden 512, GQA 4/2, recompute, float32,
                   AdamW, 3 steps: card against CPU (losses, parameters);
15. lora         — LLaMA-7B (full width, 4 of its 32 layers:
                   LORA_LAYERS, bf16) with LoRA r 16 / alpha 32
                   on q/k/v/o, AdamW(1e-4) with float32 masters of the
                   adapters only, seq 1024, batch 4, recompute: tokens/s,
                   step p50, peak memory, the optimizer's state bytes
                   (the adapters' slots only), the base bit-identical and
                   every lora_B moved; then captured jit_generate ->
                   merge() -> jit_generate, in bf16 (the program rebuilt,
                   equal to the uncaptured step) and in float32 (tokens
                   identical before and after the merge);
16. weight_only  — Mistral-7B (the generate phase's shape at 4 of its 32
                   layers: WEIGHT_ONLY_LAYERS) in bf16, then
                   converted to weight-only int8 and int4 (lm_head kept):
                   captured generate of each, tokens/s, step p50/p99,
                   weight bytes, peak memory; every quantized token
                   within MARGIN_TOL under a float32 forward of its
                   dequantized weights;
17. resnet       — ResNet-50 as bench.py::run_resnet trains it (batch 256,
                   s2d_stem, bf16 O2 without master weights,
                   Momentum(0.1, 0.9), TrainStep), NCHW then NHWC:
                   images/s, step p50/p99, MFU, peak memory, losses;
18. resnet_e2e   — resnet18 in float32, NCHW and NHWC: an eval forward,
                   then 3 steps with batch norm in train mode, card
                   against CPU (logits, losses, parameters, running
                   statistics);
19. bert         — BERT-base fine-tuned as bench.py::run_bert runs it
                   (BertConfig(), 2 classes, AdamW(2e-5), AMP O2 bf16
                   without master weights, TrainStep, batch 32, seq 128):
                   3 warm-up and 20 timed steps, sequences/s, tokens/s,
                   step p50/p99, MFU, peak memory, losses, a profile;
                   the first loss against the float32 plain forward of
                   the same weights, batch and dropout masks (5e-2);
                   each flash kernel 12 times a step, all sm90, no plain
                   sdpa; then padded rows (64-128 tokens) under
                   LinearWarmup(PolynomialDecay) and two parameter groups
                   (the sm90 forward, dK/dV and dQ under the mask); then
                   float16 with a GradScaler whose first
                   scale overflows (skipped steps move nothing, the scale
                   halves until steps go through);
20. bert_e2e     — 2 layers at BERT width, float32, AdamW, padded rows,
                   3 steps: card against CPU (losses, parameters);
21. bert_fp32_train — BERT-base fine-tuned in float32 (no AMP, TF32 off,
                   AdamW(2e-5), batch 32, seq 128, padded rows), as
                   examples/finetune_bert_cls.py runs it: 3 warm-up and
                   10 timed steps, sequences/s, step p50/p99, MFU against
                   the float32 peak, busy share and flash device time a
                   step, 12 fp32 forward, dK/dV and dQ launches a step
                   and none on sm80, the first loss within 1e-5 of the
                   plain forward's (same weights, batch, dropout); then the step with the backward on
                   fp32 and sm80 in turns (fp32, sm80, sm80, fp32) from
                   one starting point: step p50, the flash backward's
                   device time a step, losses within 1e-5;
22. bert_resume  — the training state, on that BERT-base under
                   AMP O1 (float32 parameters, `amp.auto_cast`, AdamW(2e-5)
                   under LinearWarmup(PolynomialDecay), global-norm clip,
                   `torch.use_deterministic_algorithms` on): float16 with a
                   GradScaler, 8 steps unbroken twice, then 4, a
                   CheckpointManager save, a fresh model restored, 4 more
                   (restored state and resumed run bit-equal to the
                   unbroken one); bfloat16 through TrainStep with a
                   NonfiniteGuard (a poisoned step leaves the parameters
                   bit for bit; two roll back and replay a clean run bit
                   for bit); torn checkpoints (crash after the meta stage,
                   after the arrays, truncated arrays) fall back to the
                   good one; the eleven newest optimizers card against
                   CPU within 1e-6 of the largest parameter (LBFGS:
                   twice the CPU's own spread when its sums are
                   reordered); each step 12 sm90 forward, dK/dV and dQ
                   launches; O1 step
                   p50 / p99 and busy share beside bert_fp32_train's, save
                   and load seconds and bytes, the guard's cost a step;
23. ernie_infer  — ERNIE-3.0-medium as bench.py::run_ernie_infer runs it
                   (float32, batch 32, seq 128): save_inference ->
                   create_predictor -> copy_from_cpu / run /
                   copy_to_cpu, 5 warm-up and 30 timed runs, sequences/s,
                   run p50, a profile; the exported graph holds the flash
                   operator once a layer, each run launches the forward
                   6 times (fp32), the logits equal the eager model's,
                   and the flash forward's device time a run;
                   then the same in bf16 (sm90), logits near float32's;
                   in each dtype also save_inference(aot=True) ->
                   load_inference(strict_aot=True): is_aot, run p50/p99
                   in turns with the exported program's, the same flash
                   launches, logits within ERNIE_AOT_TOL of its;
24. ernie_e2e    — 2 layers, float32: the predictor on the card against
                   the eager model on the CPU, logits within 1e-4, at two
                   batch sizes of one dynamic-batch program;
25. moe_train    — GPT-MoE 4.1B (GPT-3 1.3B at full width and depth, a
                   top-2 MoE FFN of 8 experts in every other block,
                   capacity factor 1.25, aux weight 0.01) trained as
                   `train` trains GPT-3 1.3B: tokens/s, step p50/p99,
                   MFU over the active parameters, peak memory, the loss
                   and aux series; the first loss and each routed
                   layer's aux against the float32 plain forward, each
                   aux in MOE_AUX_BAND, every expert's w1 moved, 24 sm90
                   forward, dK/dV and dQ launches a step, no plain sdpa;
                   a profile naming the MoE stages (routing, dispatch,
                   expert GEMMs, combine), forward and backward;
26. moe_generate — GPT-MoE 4.1B bf16, batch 4, 512-token prompts, 64
                   greedy tokens: the captured step against the
                   uncaptured one and the first call (identical tokens),
                   the eager loop's share of equal tokens, tokens/s, step
                   p50/p99, prefill ms, peak memory, launches by family;
27. moe_serve    — GPT-MoE 4.1B bf16 served by LLMEngine with serve's
                   request mix: tokens/s, decode step, TTFT; every
                   request finishes, no leak, paged launches = decode
                   steps x 24, no plain sdpa;
28. moe_e2e      — 2 layers at that width in float32, E 4, top-2, every
                   block routed: 3 AdamW steps card against CPU (losses
                   with aux, parameters), LLMEngine tokens against a
                   dense float32 forward on the CPU, the captured
                   jit_generate card against CPU token for token (and
                   the eager loop on the card against it), and the
                   smallest router probability gap met;
29. mt_train     — Transformer-base MT (Vaswani et al. 2017, Table 3:
                   d_model 512, 8 heads, 6 + 6 layers, d_inner 2048,
                   dropout 0.1; a shared 37,000-token vocabulary, tied
                   embedding; random weights from a seed) trained under
                   AMP O1 bf16 with Adam (beta2 0.98, eps 1e-9),
                   NoamDecay(512, 4000) and label smoothing 0.1 through
                   TrainStep: 32 sources of 128 tokens (rows padded to
                   ragged lengths), 32 targets of 97; 3 warm-up and 10
                   timed steps (step p50/p99, tokens/s, peak memory,
                   losses), then a profile (busy share); each step 18
                   sm90 forward, dK/dV and dQ launches (encoder and
                   decoder self-attention, cross-attention), no plain
                   sdpa;
30. mt_generate  — that model cast to bf16 greedy-decodes 64 tokens for
                   the 32 sources through the concat self-attention
                   caches and the memory's StaticCache: 6 sm90 forwards
                   (the encoder), 12 decode-kernel launches a step, the
                   number of steps and the step p50;
31. mt_e2e       — 2 + 2 layers at that width in float32 (TF32 off,
                   dropout 0): 3 Momentum steps and a 16-token greedy
                   decode on the card (fp32 forward, dK/dV, dQ; decode
                   kernel) against the CPU (plain versions): losses
                   within 1e-5, parameters within 1e-3 of how far they
                   moved, tokens equal;
32. hapi_bert    — BERT-base (BertConfig(), 2 classes, bf16 through
                   amp.decorate without master weights, AdamW under
                   LinearWarmup(PolynomialDecay)) fine-tuned through the
                   high-level API as examples/finetune_bert_cls.py does:
                   Model.prepare(opt, CrossEntropyLoss, Accuracy).fit over
                   an io.DataLoader of 2,048 ragged sequences (batch 32,
                   shuffled, 4 worker processes through the shared-memory
                   ring, the pinned staging reader), 256 for evaluation,
                   one epoch, MetricsLogger, EarlyStopping,
                   LRScheduler(by_step) and a save_dir: sequences/s, step
                   p50 / p99 beside bert's, the loader-wait share, peak
                   memory, eval accuracy; evaluate, predict, save, load
                   into a fresh Model (predictions bit-equal); BERT-base
                   under LazyGuard equal to the eager build bit for bit
                   (and the CUDA generator's state); the float32 workflow
                   at 2 layers on the card against the CPU (losses within
                   1e-5, accuracies equal); 12 sm90 forward, dK/dV and dQ
                   launches a training step, 12 forwards an evaluation or
                   prediction batch, no plain sdpa, no thread fallback;
33. hapi_resnet  — ResNet-50 (NHWC, bf16 O2, Momentum) as resnet trains
                   it, fed by Model.fit from 8 worker processes (batch
                   256, rings of two batches) of uint8 images made from
                   the index through Compose([RandomHorizontalFlip(),
                   ToTensor(), Normalize()]) (one fused native pass): 12
                   steps, 3 not timed, images/s beside resnet's and the
                   loader-wait share; then loader.worker_kill@2#1 kills
                   worker 1 at its second batch: it is respawned and every
                   batch arrives once, in the sampler's order;
34. to_static_train — GPT-3 1.3B at full width (2 of its 24 layers:
                   Inductor's compile grows with the depth), seq 1024,
                   batch 4, pure bf16, Adafactor, as train builds it,
                   through jit.to_static (full_graph, Inductor), each step
                   loss.backward(); opt.step(); opt.clear_grad(); an eager
                   copy with the same weights runs the same steps: the
                   sm90 forward, dK/dV and dQ launch layers x steps times
                   inside the compiled graphs, no plain sdpa, one compile
                   and no graph break (the compile tracker), losses
                   within TO_STATIC_LOSS_TOL of the eager ones and the
                   first step's gradients within TO_STATIC_GRAD_TOL of
                   the eager copy's; compile seconds, compiled and eager
                   step p50; the persistent compile cache (jit.
                   compile_cache) configured in a fresh directory, so
                   the compile publishes: publish seconds and the
                   store's bytes beside the compile seconds;
34a. compile_cache — the restart: a fresh interpreter (`chip_smoke.py
                   --cache-warm STORE SETTINGS`, under 34's torch
                   settings) with Inductor's and Triton's caches of its
                   own, empty, builds the same model from
                   the same seed, wraps it in to_static against 34's
                   store and takes 3 steps on the same batch: 0 Inductor
                   compiles (FX-graph cache misses and bypasses 0, the
                   AOTAutograd cache's hits beside them), a store hit for
                   each graph (forward and backward) and 0 misses, 0
                   tracker compiles and a "persistent cache hit" event,
                   the sm90 forward, dK/dV and dQ 2 x 3 times each inside
                   the loaded graphs, no plain sdpa, the first loss equal
                   to 34's in every bit and the others within
                   TO_STATIC_LOSS_TOL; the warm wall from to_static to
                   the first step's end beside 34's compile seconds, with
                   the share of it that Dynamo's trace takes; then, in
                   this process, one entry damaged by
                   chaos.corrupt_cache_entry reads as a miss and moves to
                   quarantine/;
35. dy2static    — a Layer's tensor if (torch.cond), a bounded while with
                   its gradient (while_max_iters) and an unbounded
                   forward-only while (while_loop), compiled, each against
                   the same code under enable_to_static(False);
36. static_graph — examples/static_mnist.py's program (784-128-10, Adam,
                   batch 64) through enable_static / Executor.run, its
                   losses against the same Sequential trained eagerly,
                   then save_inference_model / load_inference_model: the
                   same logits.

flash_kernels also holds BERT's shape (B 32, L 128, H 12, D 64,
non-causal; unmasked and under its additive padding mask) in bf16, fp16
and fp32 through every family that takes it, and flash_timings times
the sm90 and sm80 forward and dK/dV and dQ there, unmasked and masked,
in turns (sm80, sm90, SDPA, SDPA, sm90, sm80) with SDPA under the same
mask, each beside its bound; the float32 forward at ERNIE's shape (the
same shape and mask, float32), on fp32 and sm80 in turns with float32
SDPA, TF32 off (fp32, sm80, SDPA, SDPA, sm80, fp32), and once at the
train_fp32 shape (D 128, causal); and the float32 dK/dV and dQ, fp32
and sm80, at bert_e2e's shape (B 8) and ERNIE's (B 32), unmasked and
masked, and at the train_fp32 shape, in turns with float32 SDPA's
backward through autograd (fp32, sm80, SDPA, SDPA, sm80, fp32).

The kernels line counts the flash launches of phases 4a, 5b-5c, 6-10
(6a's fleet step and ring),
13-16, 19-32, 34 and 34a (bert_resume's: its first unbroken run;
34a's read from the restarted process's report; ernie_infer's
exported and AOT runs; the worker processes' read from their metrics,
the killed workers' lost with them); the sm80 forward, dK/dV and dQ
launch on none of them (asserted, `on_main_paths: false`).  The paged
kernel's launches are serve's, serve_aot's, serve_aot_e2e's,
serve_llama's, the workers' of 5b-5c, moe_serve's and moe_e2e's.
The phases run in this order: 1, 1a's start, 2, 3, 3a, 5, 6-7, 8, 9, 10,
13-22, 24-34, 34a, 35, 36 (beside 1a's compiles), 1a's wait, 4, 4a,
5a, 5b, 5c, 23,
11, 12.  Each phase prints one JSON line.  Then a phase_seconds line
(each phase's wall seconds, the build and the wait for the compiles
included), one {"kernels": [...]} line, the
card's name and power limit from nvidia-smi, and last
{"ok": true, "device": {...}}.  Any failure raises and exits nonzero
before the last line; without a CUDA device it exits 1 at once.
"""
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 flop/s and
# float32 flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# kernel vs plain: both accumulate in float32 in another order, then round
# once to the working type (2 units in the last place of a bfloat16 or
# float16 output; a few float32 roundings otherwise)
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1.6e-2, 1e-3),
       torch.float16: (2e-3, 1e-4)}

# flash kernels vs plain (the same as tests/test_torch_flash_kernel.py).
# Forward o, (rtol, atol): both versions round p to the working type
# before P.V but against another running maximum (a kernel's per key
# tile or token group, the plain version's per row), and o rounds once: 2
# units in the last place of bf16 / fp16 at the scale of the unit-normal
# v.  lse is float32 in every dtype: (1e-5, 1e-5).  Backward dq, dk, dv:
# the kernels round p and dS to bf16 / fp16 before the tensor-core
# products where the plain version keeps float32, and dS cancels, so the
# error is taken against the largest element: max |kernel - plain| / max
# |plain|.
FLASH_FWD_TOL = {torch.float32: (1e-5, 1e-5),
                 torch.bfloat16: (1.6e-2, 1.6e-2),
                 torch.float16: (2e-3, 2e-3)}
FLASH_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2,
                 torch.float16: 4e-3}
# BERT-base's first O2 bf16 step (no master weights) against the float32
# plain forward of the same weights, batch and dropout masks: the weights
# and every activation round to bf16 (unit roundoff 2^-9, about 2e-3) in
# some 25 stages in series over 12 layers, so the logits and a loss near 1
# may be off by 25 x 2e-3 at worst.
BF16_FIRST_LOSS_TOL = 5e-2


def emit(rec):
    print(json.dumps(rec), flush=True)


def paged_inputs(lens, H, Hkv, D, bs, dtype, seed):
    """Random q and pools on the card; each row's blocks are distinct
    random ids, table columns past a row's length are block 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(lens)
    need = [-(-n // bs) for n in lens]
    M, N = max(max(need), 1), sum(need) + 1
    q = torch.randn(B, 1, H, D, generator=g, device="cuda").to(dtype)
    kp = torch.randn(N, bs, Hkv, D, generator=g, device="cuda").to(dtype)
    vp = torch.randn(N, bs, Hkv, D, generator=g, device="cuda").to(dtype)
    ids = (torch.randperm(N - 1, generator=g, device="cuda") + 1).tolist()
    tables = torch.zeros(B, M, dtype=torch.int32)
    at = 0
    for b, c in enumerate(need):
        tables[b, :c] = torch.tensor(ids[at:at + c], dtype=torch.int32)
        at += c
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables.cuda(), lens_t


def compare(pd, args, dtype, splits=None):
    """(max abs error, within TOL) of the paged kernel (split as the
    wrapper plans it, or `splits` forced) against its plain version."""
    out = pd.paged_decode_attention(*args, _splits=splits)
    torch.cuda.synchronize()
    ref = pd.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    rtol, atol = TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    bad = diff > atol + rtol * ref.float().abs()
    return float(diff.max()), not bool(bad.any())


def ptxas_kernels(log):
    """{kernel entry: {registers, spill_store_bytes, spill_load_bytes,
    static_smem_bytes}} from nvcc's -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {"spill_store_bytes": 0, "spill_load_bytes": 0,
                         "static_smem_bytes": 0}
        elif name is None:
            continue
        elif "bytes spill stores" in line:
            words = line.replace(",", " ").split()
            out[name]["spill_store_bytes"] = int(
                words[words.index("spill") - 2])
            out[name]["spill_load_bytes"] = int(words[-4])
        elif "Used " in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used ")[1].split()[0])
            smem = [w for w in line.split(",") if "bytes smem" in w]
            if smem:
                out[name]["static_smem_bytes"] = int(smem[0].split()[0])
    return out


# the backward kernels' mask instantiations (csrc/flash_attention_sm90.cu
# MASK_NONE, MASK_KEYS, MASK_FULL): the unmasked one keeps its short name
SM90_MASK_MODES = {0: "", 1: "_keys", 2: "_full"}
SM90_KERNEL_NAMES = {   # mangled name's tail -> short name
    f"{kern}I{dt}Li{d}E{'' if mode is None else f'Li{mode}E'}E":
    f"{short}_{dts}_d{d}{SM90_MASK_MODES.get(mode, '')}"
    for kern, short, modes in (
        ("flash_fwd_sm90_kernel", "fwd", (None,)),
        ("flash_dkv_sm90_kernel", "dkv", tuple(SM90_MASK_MODES)),
        ("flash_dq_sm90_kernel", "dq", tuple(SM90_MASK_MODES)))
    for mode in modes
    for dt, dts in (("13__nv_bfloat16", "bf16"), ("6__half", "fp16"))
    for d in (64, 128)}


PAGED_KERNEL = re.compile(r"paged_decode_kernelI(f|13__nv_bfloat16|6__half)"
                          r"Li(\d+)ELi(\d+)E")
PAGED_DTYPES = {"f": "fp32", "13__nv_bfloat16": "bf16", "6__half": "fp16"}
# the decode forward: float32 on the CUDA cores (query rows in registers),
# bf16 and fp16 on the tensor cores (D tile)
DECODE_KERNEL = re.compile(r"flash_decode_kernelILi(\d+)E")
DECODE_MMA_KERNEL = re.compile(r"flash_decode_mma_kernelI"
                               r"(13__nv_bfloat16|6__half)Li(\d+)E")
# the float32 forward (csrc/flash_fwd_fp32.cu): head-dim tile, mask mode
FP32_KERNEL = re.compile(r"flash_fwd_fp32_kernelILi(\d+)ELi(\d)E")
# the float32 backward (csrc/flash_bwd_fp32.cu): kernel, head-dim tile,
# mask mode
FP32_BWD_KERNEL = re.compile(r"flash_(dkv|dq)_fp32_kernelILi(\d+)ELi(\d)E")


def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    kernels = {name: k for log in logs.values()
               for name, k in ptxas_kernels(log).items()}
    regs = [k["registers"] for k in kernels.values() if "registers" in k]
    spills = sum(k["spill_store_bytes"] for k in kernels.values())
    sm90 = {}
    for name, k in kernels.items():
        for tail, short in SM90_KERNEL_NAMES.items():
            if tail in name:
                sm90[short] = k
    paged, decode, fp32, fp32_bwd = {}, {}, {}, {}
    for name, k in kernels.items():
        m = PAGED_KERNEL.search(name)
        if m:   # dtype, query heads in registers, vectors a lane
            paged[f"{PAGED_DTYPES[m[1]]}_g{m[2]}_vpl{m[3]}"] = k
        m = DECODE_KERNEL.search(name)
        if m:
            decode[f"fp32_rows{m[1]}"] = k
        m = DECODE_MMA_KERNEL.search(name)
        if m:
            decode[f"{PAGED_DTYPES[m[1]]}_mma_d{m[2]}"] = k
        m = FP32_KERNEL.search(name)
        if m:
            fp32[f"fp32_d{m[1]}{SM90_MASK_MODES[int(m[2])]}"] = k
        m = FP32_BWD_KERNEL.search(name)
        if m:
            fp32_bwd[f"{m[1]}_fp32_d{m[2]}{SM90_MASK_MODES[int(m[3])]}"] = k
    # e.g. ptxas's notice that it serialized wgmma for want of registers
    warnings = sorted({line.strip() for log in logs.values()
                       for line in log.splitlines()
                       if "warning" in line.lower()})
    emit({"phase": "build", "seconds": secs, "sources": _build.sources(),
          "compiled": sorted(logs), "kernels_compiled": len(regs),
          "max_registers": max(regs, default=None),
          "spill_store_bytes": spills, "sm90_kernels": sm90,
          "paged_kernels": paged, "decode_kernels": decode,
          "fp32_kernels": fp32, "fp32_bwd_kernels": fp32_bwd,
          "warnings": warnings})
    if logs:
        assert len(sm90) == len(SM90_KERNEL_NAMES), \
            f"ptxas reported {sorted(sm90)} of the sm90 kernels"
    if "flash_decode" in logs:
        assert len(decode) == 8, f"ptxas reported {sorted(decode)}"
    if "flash_fwd_fp32" in logs:
        assert len(fp32) == 6, f"ptxas reported {sorted(fp32)}"
    if "flash_bwd_fp32" in logs:
        assert len(fp32_bwd) == 12, f"ptxas reported {sorted(fp32_bwd)}"
        assert not any(k["spill_store_bytes"] or k["spill_load_bytes"]
                       for k in fp32_bwd.values()), fp32_bwd


def phase_kernels():
    """The paged kernel, split as the wrapper plans it and in its one-pass
    layout (`_splits=1`), against the plain version: the serving shapes
    (ragged rows to 1,056 tokens, 5 partitions), then the split edges."""
    from paddle_tpu_torch.ops import paged_decode as pd
    ragged = [1, 16, 17, 33, 100, 255, 256, 257, 500, 640, 777, 800, 900,
              1000, 1024, 1056]
    # a row inside one partition, an empty row, a last partition of one
    # token, a row over six partitions
    part = pd.PARTITION_TOKENS
    edges = [10, 0, part + 1, 5 * part + 40]
    cases = [  # name, lens, H, Hkv, D, bs, dtype
        ("mha_d128_bf16", ragged, 16, 16, 128, 16, torch.bfloat16),
        ("mha_d128_fp32", ragged, 16, 16, 128, 16, torch.float32),
        ("mha_d128_fp16", ragged, 16, 16, 128, 16, torch.float16),
        ("gqa_h16_hkv4_bf16", [0] + ragged[1:], 16, 4, 128, 16,
         torch.bfloat16),
        ("d64_bf16", ragged, 16, 16, 64, 16, torch.bfloat16),
        ("split_edges_g1_bf16", edges, 16, 16, 128, 16, torch.bfloat16),
        ("split_edges_g2_fp32", edges, 16, 8, 128, 16, torch.float32),
        ("split_edges_g8_fp16", edges, 16, 2, 128, 16, torch.float16),
        ("split_edges_g16_bf16", edges, 16, 1, 128, 16, torch.bfloat16),
        ("split_bs1_g2_fp16", [1, 2 * part + 1, 2 * part + 60], 16, 8, 128,
         1, torch.float16),
        # the GQA groups of Qwen2-1.5B (12 / 2) and Qwen2-7B (28 / 4)
        ("gqa_g6_bf16", ragged, 12, 2, 128, 16, torch.bfloat16),
        ("gqa_g7_bf16", ragged, 28, 4, 128, 16, torch.bfloat16),
        ("split_edges_g6_fp16", edges, 12, 2, 128, 16, torch.float16),
        ("split_edges_g7_fp32", edges, 28, 4, 128, 16, torch.float32),
    ]
    results = []
    for i, (name, lens, H, Hkv, D, bs, dtype) in enumerate(cases):
        args = paged_inputs(lens, H, Hkv, D, bs, dtype, seed=100 + i)
        splits, tokens = pd.split_plan(args[3].shape[1], bs)
        err, ok = compare(pd, args, dtype)
        again = pd.paged_decode_attention(*args)
        first = pd.paged_decode_attention(*args)    # counters back at 0
        err1, ok1 = compare(pd, args, dtype, splits=1)
        torch.cuda.synchronize()
        rtol, atol = TOL[dtype]
        results.append({"case": name, "splits": splits,
                        "split_tokens": tokens, "max_abs_err": err,
                        "one_pass_max_abs_err": err1, "rtol": rtol,
                        "atol": atol,
                        "repeat_equal": bool(torch.equal(again, first)),
                        "ok": ok and ok1 and bool(torch.equal(again, first))})
    emit({"phase": "kernels", "kernel": "paged_decode_attention",
          "partition_tokens": pd.PARTITION_TOKENS, "cases": results})
    failed = [r["case"] for r in results if not r["ok"]]
    assert not failed, f"kernel disagrees with its plain version: {failed}"
    assert sum(r["splits"] > 1 for r in results) >= 6, results


def phase_serve():
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import paged_decode as pd
    from paddle_tpu_torch.serving import LLMEngine
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.from_preset("gpt3-1.3B", hidden_dropout=0.0,
                                attention_dropout=0.0,
                                num_layers=SERVE_LAYERS)
    model = GPTForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0))
    eng = LLMEngine(model, num_blocks=2048, block_size=16, max_running=16,
                    prefill_chunk=512)
    rng = np.random.default_rng(0)
    plens = rng.integers(128, 1025, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in plens]
    eng.generate_batch([prompts[0][:64]], max_new_tokens=2)    # warm-up

    reg = metrics.registry()
    reg.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pd.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, max_new_tokens=32) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pd.paged_decode_attention.launches

    steps = reg.counter("serving_decode_steps_total").value
    step_s = reg.histogram("serving_decode_step_seconds")
    ttft = reg.histogram("serving_ttft_seconds")
    tokens = sum(len(r.generated) for r in reqs)
    reasons = sorted({r.finish_reason for r in reqs})
    leaks = eng.pool.check_leaks()
    emit({"phase": "serve", "model": "gpt3-1.3B", "dtype": "bfloat16",
          "layers": cfg.num_layers, "requests": len(reqs),
          "prompt_tokens": int(plens.sum()), "output_tokens": tokens,
          "wall_s": wall, "output_tokens_per_s": tokens / wall,
          "decode_steps": steps,
          "decode_step_p50_ms": step_s.percentile(50) * 1e3,
          "decode_step_p99_ms": step_s.percentile(99) * 1e3,
          "ttft_p50_s": ttft.percentile(50), "ttft_p99_s": ttft.percentile(99),
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
          "paged_kernel_launches": launches,
          "finish_reasons": reasons, "leaks": leaks})
    assert reasons == ["length"], f"requests finished with {reasons}"
    assert leaks == ([], []), f"pool leaks {leaks}"
    assert launches == steps * cfg.num_layers and steps > 0, \
        f"{launches} paged kernel launches for {steps} decode steps"
    # the last decode step of each request attends prompt + 31 tokens
    last_lens = [int(n) + 31 for n in plens]
    phase_profile(eng, prompts, step_s.percentile(50))
    eng.close()
    del eng, model
    torch.cuda.empty_cache()
    return launches, last_lens, {
        "prompts": [p.tolist() for p in prompts],
        "streams": [list(r.generated) for r in reqs],
        "output_tokens_per_s": tokens / wall,
        "ttft_p50_s": ttft.percentile(50), "ttft_p99_s": ttft.percentile(99),
        "decode_step_p50_ms": step_s.percentile(50) * 1e3}


def phase_profile(eng, prompts, step_p50_s, steps=4, phase="profile"):
    """Where a steady decode step's time goes: the same 16 prompts are
    prefilled again, then `steps` decode steps of 16 rows run under
    torch.profiler (CUPTI kernel records).  The profiler's own host cost
    stretches the wall time, so the busy share is taken against
    `step_p50_s`, the unprofiled decode step p50 of the serve phase; the
    share against the profiled wall is printed beside it.  The requests
    are cancelled after."""
    from torch.profiler import ProfilerActivity, profile
    reqs = [eng.add_request(p, max_new_tokens=40) for p in prompts]
    while any(r.state == "waiting" or r.needs_prefill for r in reqs):
        eng.step()
    assert all(r.state == "running" for r in reqs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    for r in reqs:
        eng.cancel(r)
    assert eng.pool.check_leaks() == ([], [])
    spans, by_name, busy = device_time(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    paged = sum(us for name, us in by_name.items() if "paged_decode" in name)
    busy_ms = busy / steps / 1e3
    emit({"phase": phase, "decode_steps": steps, "rows": len(reqs),
          "device_events": spans,
          "profiled_wall_ms_per_step": wall_us / steps / 1e3,
          "unprofiled_step_p50_ms": step_p50_s * 1e3,
          "device_busy_ms_per_step": busy_ms,
          "device_busy_share": busy_ms / (step_p50_s * 1e3),
          "device_busy_share_of_profiled_wall": busy / wall_us,
          "paged_kernel_ms_per_step": paged / steps / 1e3,
          "top_device_ms_per_step": [[name[:90], us / steps / 1e3]
                                     for name, us in top]})


def device_time(prof):
    """(device events, {kernel name: us}, busy us) of a torch.profiler
    run; busy is the union of the device intervals.  The device spans of
    record_function ranges (user annotations) are not kernels and are
    left out."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation)
    by_name, busy, edge = {}, 0.0, float("-inf")
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        busy += max(0.0, end - max(start, edge))     # union of intervals
        edge = max(edge, end)
    return len(spans), by_name, busy


def phase_e2e():
    from paddle_tpu_torch.serving import LLMEngine
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM

    # full float32 products on the card (the model has no convolution;
    # cuDNN's TF32 default is turned off all the same)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig.from_preset("gpt3-1.3B", num_layers=2,
                                hidden_dropout=0.0, attention_dropout=0.0)
    model = GPTForCausalLM(
        cfg, device="cuda", dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(1))
    eng = LLMEngine(model, num_blocks=256, block_size=16, max_running=4,
                    prefill_chunk=128)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (17, 90, 200, 301)]
    outs = eng.generate_batch(prompts, max_new_tokens=8)
    assert eng.pool.check_leaks() == ([], [])

    cpu = GPTForCausalLM(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    cpu.eval()
    worst = 0.0
    for prompt, gen in zip(prompts, outs):
        ids = torch.tensor([prompt + gen[:-1]])
        with torch.no_grad():
            logits = cpu(ids)[0, len(prompt) - 1:]      # one row per token
        chosen = logits[torch.arange(len(gen)), torch.tensor(gen)]
        gap = float((logits.max(dim=-1).values - chosen).max())
        worst = max(worst, gap)
    emit({"phase": "e2e", "model": "gpt3-1.3B width, 2 layers",
          "dtype": "float32", "requests": len(prompts),
          "tokens_checked": sum(len(g) for g in outs),
          "max_logit_gap": worst, "tol": 1e-4})
    assert worst <= 1e-4, \
        f"an engine token sits {worst} below the CPU maximum logit"


# ---------------------------------------------------------- AOT serving
# serve's engine settings: the inventory is the decode program and the
# prefill buckets 32, 64, 128, 256 and 512 of the default ladder
# serve, serve_aot and serve_router (compared with one another) run 12 of
# GPT-3 1.3B's 24 layers at full width: the depth sets serve_aot's
# compile, the longest job of aot_compile (407.8 s at 24 layers on a slow
# host, PR 17)
SERVE_LAYERS = 12
SERVE_ENGINE = dict(num_blocks=2048, block_size=16, max_running=16,
                    prefill_chunk=512)
# a package holds no weights: each must be under this share of them
AOT_PACKAGE_SHARE = 0.05


def gpt13(dtype=torch.bfloat16, seed=0, **over):
    """GPT-3 1.3B on the card (full width, serve's SERVE_LAYERS unless
    `over` names num_layers), random weights from a seeded generator."""
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM
    over.setdefault("num_layers", SERVE_LAYERS)
    cfg = GPTConfig.from_preset("gpt3-1.3B", hidden_dropout=0.0,
                                attention_dropout=0.0, **over)
    return GPTForCausalLM(
        cfg, device="cuda", dtype=dtype,
        generator=torch.Generator(device="cuda").manual_seed(seed)).eval()


def gpt_margin(model, prompts, streams):
    """The largest (row maximum - chosen token's logit) over the tokens of
    `streams`, from a dense float32 forward of `model` (converted in
    place) on the card, TF32 off."""
    from torch.nn import functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    model.float()
    worst = 0.0
    for p, gen in zip(prompts, streams):
        seq = torch.tensor([list(p) + list(gen)], device="cuda")
        with torch.no_grad():
            h = model.gpt(seq[:, :-1])[:, len(p) - 1:]
            logits = F.linear(h, model.gpt.wte.weight).float()
        worst = max(worst, margin(logits, seq, len(p)))
    return worst


def aot_program_calls(reg):
    """{route: calls} of `serving_program_calls_total` in `reg` (a
    registry or a worker's metrics snapshot)."""
    recs = reg.snapshot() if hasattr(reg, "snapshot") else reg
    return {rec["labels"]["route"]: rec["value"] for rec in recs
            if rec["name"] == "serving_program_calls_total"}


# serve_aot's engine: serve's, with the one-bucket ladder [512] (a chunk
# pads to 512), so that its inventory is 2 programs, not 6: the script
# compiles them beside its other phases and must end within its time
SERVE_AOT_ENGINE = dict(SERVE_ENGINE, buckets=[512])
# serve_aot_e2e's engine: e2e's, with the one-bucket ladder [128]
E2E_AOT_ENGINE = dict(num_blocks=256, block_size=16, max_running=4,
                      prefill_chunk=128, buckets=[128])


# aot_compile's jobs: one process each, all at once
AOT_JOBS = ("serve", "e2e", "ernie_float32", "ernie_bfloat16")


def start_aot_compile():
    """Start every AOTInductor export and compile of the script, right
    after the build: one `chip_smoke.py --aot-export NAME DIR` process a
    job of AOT_JOBS (`aot_export`), all at once, each in a session of its
    own at the lowest CPU priority, with its output in DIR: "serve"
    (serve_aot's inventory, 2 programs), "e2e" (serve_aot_e2e's, 2
    programs) and ERNIE's `save_inference(aot=True)` in float32 and in
    bf16.  A compile is mostly serial host work whatever the depth (a
    2-layer decode program 127-163 s alone, most of it in the C++
    compiler; `tools/torch_aot_compile_probe.py`, NVIDIA H100 80GB HBM3
    at 700 W), so the jobs run beside the phases that load no package
    and `finish_aot_compile` collects them.  Returns {name: [its
    TemporaryDirectory, its process]} and the start time; `stop_aot`
    ends and removes them."""
    import tempfile
    jobs = {}
    try:
        for name in AOT_JOBS:
            tmp = tempfile.TemporaryDirectory(prefix=f"aot_{name}_")
            jobs[name] = [tmp, None]
            with open(os.path.join(tmp.name, "export.out"), "w") as out, \
                    open(os.path.join(tmp.name, "export.err"), "w") as err:
                jobs[name][1] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--aot-export", name, tmp.name], stdout=out,
                    stderr=err, start_new_session=True)
    except BaseException:
        stop_aot(jobs)
        raise
    return jobs, time.perf_counter()


def stop_aot(jobs):
    """Kill every job of `jobs` still running (its whole session) and
    remove every job's directory."""
    import signal
    for tmp, proc in jobs.values():
        if proc is not None and proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        tmp.cleanup()


def finish_aot_compile(started):
    """Wait for the jobs `start_aot_compile` started.  Prints each job's
    seconds, the seconds they ran beside other phases and the seconds
    waited here; returns {name: (its TemporaryDirectory, what it
    printed)}.  A failed job raises with its stderr."""
    jobs, t_start = started
    t0 = time.perf_counter()
    done = {}
    for name, (tmp, proc) in jobs.items():
        rc = proc.wait()
        with open(os.path.join(tmp.name, "export.err")) as f:
            assert rc == 0, \
                f"aot export {name} exited {rc}: {f.read()[-4000:]}"
        with open(os.path.join(tmp.name, "export.out")) as f:
            done[name] = tmp, json.loads(f.read().strip().splitlines()[-1])
    emit({"phase": "aot_compile", "jobs": list(AOT_JOBS),
          "job_wall_s": {n: info["wall_s"] for n, (_, info) in done.items()},
          "beside_phases_s": t0 - t_start,
          "waited_s": time.perf_counter() - t0})
    return done


def aot_export(name, path):
    """`chip_smoke.py --aot-export NAME DIR`: "serve" and "e2e" export
    their model's inventory into DIR (`export_serving_artifacts`: each
    program compiles in a child process of its own), "ernie_float32" and
    "ernie_bfloat16" run `ernie_aot_export`.  It runs, with its compile
    children, at the lowest CPU priority, so that the phases beside it
    keep the host.  Prints {"wall_s": ...}."""
    from paddle_tpu_torch.serving import LLMEngine, export_serving_artifacts
    os.nice(19)
    t0 = time.perf_counter()
    if name.startswith("ernie_"):
        ernie_aot_export(path, name[len("ernie_"):])
    else:
        kw, eng_kw = {
            "serve": ({}, SERVE_AOT_ENGINE),
            "e2e": (dict(dtype=torch.float32, seed=1, num_layers=2),
                    E2E_AOT_ENGINE)}[name]
        eng = LLMEngine(gpt13(**kw), **eng_kw)
        export_serving_artifacts(eng, path)
        assert eng.close() == ([], [])
    print(json.dumps({"wall_s": time.perf_counter() - t0}), flush=True)
    return 0


def phase_serve_aot(serve, aot):
    """serve's model (GPT-3 1.3B, bf16, seed 0), engine settings (with
    the ladder [512], SERVE_AOT_ENGINE) and request mix served from
    AOTInductor packages.  The inventory (`program_keys`: decode and
    prefill 512), compiled by `start_aot_compile` (each program's export
    and compile seconds, and its bytes: each under AOT_PACKAGE_SHARE of
    the weights, since the weights are inputs), is loaded into a fresh
    engine over the same model with strict=True and the mix served:
    tokens/s, decode step p50/p99, TTFT p50/p99, peak memory beside
    serve's; then a profile of 4 AOT decode steps
    (`phase_profile`, device ms by kernel, busy share).  Gates: every
    program loaded, none refused, no call eager or fallen back, paged
    launches = decode steps x 24 (the operator called back from the
    packages), 0 sm80 and 0 plain sdpa, every request "length", no leak,
    each token within MARGIN_TOL of a float32 forward's maximum.  Returns
    the directory (kept for serve_router's AOT worker), the inventory
    size and the launch counts."""
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.serving import LLMEngine, load_serving_artifacts

    tmp, export = aot["serve"]
    path = tmp.name
    with open(os.path.join(path, "serving_manifest.json")) as f:
        manifest = json.load(f)
    model = gpt13()
    layers = model.cfg.num_layers
    wbytes = weight_bytes(model)
    reg = metrics.registry()
    reg.reset()
    programs = {name: {k: e[k] for k in ("bytes", "export_s", "compile_s")}
                | {"weight_share": e["bytes"] / wbytes}
                for name, e in manifest["programs"].items()}

    eng = LLMEngine(model, **SERVE_AOT_ENGINE)
    t0 = time.perf_counter()
    keys = load_serving_artifacts(eng, path, strict=True)
    load_s = time.perf_counter() - t0
    loaded = reg.counter("serving_aot_loaded_total").value
    refused = reg.counter("serving_aot_refused_total").value
    prompts = [np.asarray(p) for p in serve["prompts"]]
    eng.generate_batch([prompts[0][:64]], max_new_tokens=2)    # warm-up
    reg.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, max_new_tokens=32) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = reg.counter("serving_decode_steps_total").value
    step_s = reg.histogram("serving_decode_step_seconds")
    ttft = reg.histogram("serving_ttft_seconds")
    calls = aot_program_calls(reg)
    fallback = reg.counter("serving_aot_fallback_total").value
    tokens = sum(len(r.generated) for r in reqs)
    reasons = sorted({r.finish_reason for r in reqs})
    leaks = eng.pool.check_leaks()
    streams = [list(r.generated) for r in reqs]
    phase_profile(eng, prompts, step_s.percentile(50),
                  phase="serve_aot_profile")
    eng.close()
    del eng
    release()
    worst = gpt_margin(model, prompts, streams)
    fl = flash_part(counts)
    emit({"phase": "serve_aot", "model": "gpt3-1.3B", "dtype": "bfloat16",
          "layers": layers, "engine": SERVE_AOT_ENGINE,
          "inventory": [list(k) for k in keys], "programs": programs,
          "export_process_wall_s": export["wall_s"],
          "load_s": load_s,
          "weight_bytes": wbytes, "loaded": loaded, "refused": refused,
          "requests": len(reqs), "output_tokens": tokens, "wall_s": wall,
          "output_tokens_per_s": tokens / wall, "decode_steps": steps,
          "decode_step_p50_ms": step_s.percentile(50) * 1e3,
          "decode_step_p99_ms": step_s.percentile(99) * 1e3,
          "ttft_p50_s": ttft.percentile(50), "ttft_p99_s": ttft.percentile(99),
          "peak_memory_gib": peak, "program_calls": calls,
          "fallbacks": fallback, "launches": counts,
          "serve_output_tokens_per_s": serve["output_tokens_per_s"],
          "serve_decode_step_p50_ms": serve["decode_step_p50_ms"],
          "serve_ttft_p50_s": serve["ttft_p50_s"],
          "serve_ttft_p99_s": serve["ttft_p99_s"],
          "streams_equal_serve": sum(a == b for a, b in
                                     zip(streams, serve["streams"])),
          "finish_reasons": reasons, "leaks": leaks,
          "max_margin": worst, "margin_tol": MARGIN_TOL})
    assert len(keys) == len(manifest["programs"]) == loaded, (keys, loaded)
    assert refused == 0 and fallback == 0, (refused, fallback)
    assert calls.get("live", 0) == 0 and calls.get("aot", 0) > steps, calls
    assert all(p["weight_share"] < AOT_PACKAGE_SHARE
               for p in programs.values()), programs
    assert reasons == ["length"], f"requests finished with {reasons}"
    assert leaks == ([], []), f"pool leaks {leaks}"
    assert counts["paged_decode"] == steps * layers and steps > 0, \
        f"{counts['paged_decode']} paged launches for {steps} decode steps"
    assert counts["sdpa_plain"] == 0 and fl["fwd"] == fl["fwd_sm90"] + \
        fl["fwd_decode"] + fl["fwd_fp32"], counts
    assert worst <= MARGIN_TOL, f"a served token sits {worst} below the max"
    del model
    release()
    return {"dir": path, "programs": len(keys),
            "paged": counts["paged_decode"], "flash": fl}


def phase_serve_aot_e2e(aot):
    """GPT-3 1.3B's width at 2 layers in float32 (TF32 off), e2e's
    prompts and E2E_AOT_ENGINE (decode and prefill 128): the engine
    serving from the packages `start_aot_compile` compiled on the card,
    loaded strictly, against the same engine served eagerly on the card
    and on the CPU, token for token.  Returns the paged launches."""
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.serving import LLMEngine, load_serving_artifacts
    from paddle_tpu_torch.text import GPTForCausalLM

    tmp, export = aot["e2e"]
    path = tmp.name
    with open(os.path.join(path, "serving_manifest.json")) as f:
        manifest = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = gpt13(torch.float32, seed=1, num_layers=2)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=n).tolist()
               for n in (17, 90, 200, 301)]
    reg = metrics.registry()
    eng = LLMEngine(model, **E2E_AOT_ENGINE)
    live = eng.generate_batch(prompts, max_new_tokens=8)
    assert eng.close() == ([], [])
    eng = LLMEngine(model, **E2E_AOT_ENGINE)
    keys = load_serving_artifacts(eng, path, strict=True)
    reg.reset()
    zero_counts()
    aot_tokens = eng.generate_batch(prompts, max_new_tokens=8)
    counts = read_counts()
    calls = aot_program_calls(reg)
    steps = reg.counter("serving_decode_steps_total").value
    assert eng.close() == ([], [])
    cpu = GPTForCausalLM(model.cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    ceng = LLMEngine(cpu.eval(), **E2E_AOT_ENGINE)
    on_cpu = ceng.generate_batch(prompts, max_new_tokens=8)
    emit({"phase": "serve_aot_e2e", "model": "gpt3-1.3B width, 2 layers",
          "dtype": "float32", "inventory": [list(k) for k in keys],
          "export_process_wall_s": export["wall_s"],
          "compile_s": {k: e["compile_s"]
                        for k, e in manifest["programs"].items()},
          "requests": len(prompts),
          "aot_equal_live": aot_tokens == live,
          "aot_equal_cpu": aot_tokens == on_cpu,
          "program_calls": calls, "paged_launches": counts["paged_decode"],
          "decode_steps": steps})
    assert len(keys) == 2 and calls.get("live", 0) == 0, (keys, calls)
    assert aot_tokens == live == on_cpu, (aot_tokens, live, on_cpu)
    assert counts["paged_decode"] == steps * 2, (counts, steps)
    del model, cpu
    release()
    return counts["paged_decode"]


# ------------------------------------------------------------ serving tier
GPT13_SPEC = dict(preset="gpt3-1.3B",
                  overrides=dict(hidden_dropout=0.0, attention_dropout=0.0,
                                 num_layers=SERVE_LAYERS))


def phase_serve_router(serve, aot=None):
    """serve's traffic (its 16 prompts, 32 greedy tokens each) through a
    Router over two ProcReplica worker processes on the one card, each
    with its own CUDA context, GPT-3 1.3B in bf16 and serve's engine
    settings.  Workers build from the drills' builder
    (`tools/torch_chaos_check.build_engine`): a short warm-up, then their
    counters start from zero.  Prints tokens/s and the router's TTFT
    beside serve's, each worker's decode steps, paged launches, plain
    sdpa calls, peak memory, build and first-step seconds, spawn-to-ready
    seconds, and how many streams equal serve's (not a gate: a decode
    batch of 8 rows rounds in bf16 otherwise than one of 16).  Gates:
    every request finishes "length", no leak, every worker pid dead and
    reaped after close(), the workers' probe logits equal the parent's
    bit for bit, paged launches = decode steps x layers in each worker,
    0 plain sdpa calls.  With `aot` (serve_aot's artifacts), worker r1
    starts with `load_aot=` them and their ladder [512]
    (SERVE_AOT_ENGINE): its ready event must report every
    program loaded, and it must serve through them alone (no eager or
    fallen-back call); its spawn-to-ready, build, AOT load and first-step
    seconds print beside the cold worker r0's.  Returns the workers'
    launch counts and the slower worker's spawn-to-ready seconds."""
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.serving import Router
    from paddle_tpu_torch.serving import worker as sw
    from paddle_tpu_torch.serving.transport import TransportPolicy
    from tools import torch_chaos_check as tcc

    engine = dict(num_blocks=2048, block_size=16, max_running=16,
                  prefill_chunk=512)
    spec = tcc.drill_spec(device="cuda", dtype="bfloat16", engine=engine,
                          seed=0, **GPT13_SPEC)
    if aot is not None:
        aot_spec = dict(spec, load_aot=aot["dir"],
                        engine=dict(spec["engine"], buckets=[512]))
    parent = sw.build_gpt(spec).eval()
    digest = tcc.probe_digest(parent)
    layers = parent.cfg.num_layers
    del parent
    release()

    handles = []
    pol = TransportPolicy(timeout=120.0, retries=0)

    def factory(name, hb_path, respawning=False):
        warm = aot is not None and name == "r1"
        h = sw.ProcReplica(aot_spec if warm else spec, name, hb_path,
                           policy=pol)
        handles.append(h)
        return h

    t0 = time.monotonic()
    router = Router(None, replicas=2, heartbeat_timeout=30.0,
                    spawn_grace_s=600.0, respawn=False,
                    replica_factory=factory)
    spawn_s = time.monotonic() - t0
    try:
        ready, pending = tcc.ready_times(router, 600.0)
        assert not pending, f"workers {pending} not ready"
        ready = {k: v + spawn_s for k, v in ready.items()}
        first = {n: tcc.worker_report(r)
                 for n, r in router.metrics_snapshot().items()}
        aot_loaded = {h.name: h.ready_info.get("aot_loaded")
                      for h in handles}
        reg = metrics.registry()
        reg.reset()
        t0 = time.perf_counter()
        reqs = [router.submit(p, max_new_tokens=32)
                for p in serve["prompts"]]
        deadline = time.monotonic() + 600.0
        while router.has_work:
            assert time.monotonic() < deadline, "router streams stalled"
            router.step()
        wall = time.perf_counter() - t0
        ttft = reg.histogram("router_ttft_seconds")
        snaps = router.metrics_snapshot()
        workers = {n: tcc.worker_report(r) for n, r in snaps.items()}
        calls = {n: aot_program_calls(r) for n, r in snaps.items()}
        leaks = router.close()
    finally:
        for h in handles:
            if h.proc.poll() is None:
                h.abort()
    alive = tcc.live_pids([h.proc.pid for h in handles])
    tokens = sum(len(rr.emitted) for rr in reqs)
    reasons = sorted({rr.finish_reason for rr in reqs})
    same = sum(rr.emitted == s for rr, s in zip(reqs, serve["streams"]))
    per = {n: {"decode_steps": w.get("serving_decode_steps_total", 0),
               "requests": w.get("serving_requests_finished_total", 0),
               "decode_step_p50_ms": (w["serving_decode_step_seconds"]["p50"]
                                      or 0) * 1e3,
               "paged_launches": w["launches"]["paged_decode"],
               "flash": flash_part(w["launches"]),
               "sdpa_plain_calls": w["launches"]["sdpa_plain"],
               "peak_memory_gib": w.get("serving_peak_memory_bytes", 0)
               / 2**30,
               "build_s": w["serving_build_seconds"],
               "first_step_s": w["serving_first_step_seconds"],
               "aot_loaded": aot_loaded.get(n),
               "aot_load_s": w.get("serving_aot_load_seconds"),
               "program_calls": calls.get(n),
               "fallbacks": w.get("serving_aot_fallback_total", 0)}
           for n, w in workers.items()}
    emit({"phase": "serve_router", "model": GPT13_SPEC["preset"],
          "dtype": "bfloat16", "workers": len(handles),
          "requests": len(reqs),
          "output_tokens": tokens, "wall_s": wall,
          "output_tokens_per_s": tokens / wall,
          "ttft_p50_s": ttft.percentile(50), "ttft_p99_s": ttft.percentile(99),
          "serve_output_tokens_per_s": serve["output_tokens_per_s"],
          "serve_ttft_p50_s": serve["ttft_p50_s"],
          "serve_ttft_p99_s": serve["ttft_p99_s"],
          "serve_decode_step_p50_ms": serve["decode_step_p50_ms"],
          "speedup_vs_serve": tokens / wall / serve["output_tokens_per_s"],
          "spawn_to_ready_s": ready, "per_worker": per,
          "streams_equal_serve": same, "finish_reasons": reasons,
          "leaks": leaks, "pids_alive_after_close": alive,
          "probe_digest_equal": {n: w.get("probe_sha256") == digest
                                 for n, w in first.items()}})
    assert reasons == ["length"], f"requests finished with {reasons}"
    assert all(lk == ([], []) for lk in leaks.values()), leaks
    assert not alive, f"worker pids {alive} outlived close()"
    assert all(w.get("probe_sha256") == digest for w in first.values()), \
        f"worker probe logits differ from the parent's {digest}: {first}"
    for n, w in per.items():
        assert w["sdpa_plain_calls"] == 0, (n, w)
        assert w["decode_steps"] > 0 and \
            w["paged_launches"] == w["decode_steps"] * layers, (n, w)
    if aot is not None:
        w = per["r1"]
        assert w["aot_loaded"] == aot["programs"], w
        assert w["program_calls"].get("live", 0) == 0 and \
            w["program_calls"].get("aot", 0) > 0 and not w["fallbacks"], w
    counts = summed_launches(workers.values())
    return {"paged": counts["paged_decode"], "flash": flash_part(counts),
            "spawn_to_ready_s": max(ready.values())}


def summed_launches(reports):
    """The launch counters of `tcc.worker_report`s, summed."""
    from paddle_tpu_torch import ops
    return {k: sum(r["launches"].get(k, 0) for r in reports)
            for k in ops.launch_counts()}


# the router drill's prompts: few enough that the three phases (eight
# worker starts) fit in about two minutes on the card
ROUTER_DRILL_LENS = (96, 24, 200, 48, 150, 64)


def phase_router_drill(spawn_to_ready_s, layers=None):
    """`tools/torch_chaos_check.py --router --proc` at GPT-3 1.3B width in
    float32 on the card: two worker processes, r0 SIGKILLed mid-stream
    three times (evictions / respawns / aborts 3 / 2 / 1, r0 abandoned),
    one `serving.transport_drop` (a counted frame error, a crash
    eviction), one worker wedged by `_wedge` (a hang eviction that needs
    the KILL escalation).  The reference is an uninterrupted run of one
    in-process engine on the card on the same seeded weights (TF32 off):
    every surviving stream byte-identical to it, dedup >= 1, 0
    mismatches, leak-free survivors, no orphan.  The spawn grace is 4x
    serve_router's spawn-to-ready (at least 120 s), the hang timeout 4x
    the slowest first step the workers report (at least 3 s).  Prints
    the smallest top-2 logit margin over the reference streams.  Returns
    the surviving workers' launch counts (a killed worker's die with
    it)."""
    from paddle_tpu_torch.serving import LLMEngine
    from paddle_tpu_torch.serving import worker as sw
    from tools import torch_chaos_check as tcc

    new = 16
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = dict(num_blocks=512, block_size=16, max_running=8,
                  prefill_chunk=128)
    over = dict(GPT13_SPEC["overrides"],
                **({"num_layers": layers} if layers else {}))
    spec = tcc.drill_spec(device="cuda", dtype="float32", engine=engine,
                          seed=0, step_delay_s=0.01,
                          preset=GPT13_SPEC["preset"], overrides=over)
    ref_model = sw.build_gpt(spec).eval()
    digest = tcc.probe_digest(ref_model)
    layers = ref_model.cfg.num_layers
    prompts = tcc.drill_prompts(11, ROUTER_DRILL_LENS,
                                vocab=ref_model.cfg.vocab_size)
    eng = LLMEngine(ref_model, **engine)
    refs = eng.generate_batch(prompts, max_new_tokens=new)
    assert eng.close() == ([], [])
    margin = tcc.min_top2_margin(ref_model, prompts, refs)
    del eng, ref_model
    release()

    res = tcc.run_router_proc(spec, prompts, refs, digest,
                              spawn_grace_s=max(120.0,
                                                4.0 * spawn_to_ready_s))
    workers = {f"{phase}/{n}": w for phase, r in res["phases"].items()
               for n, w in r["survivors"].items()}
    counts = summed_launches(workers.values())
    steps = {k: w.get("serving_decode_steps_total", 0)
             for k, w in workers.items()}
    emit({"phase": "router_drill", "model": GPT13_SPEC["preset"],
          "layers": layers, "dtype": "float32", "requests": len(prompts),
          "prompt_tokens": sum(ROUTER_DRILL_LENS), "new_tokens": new,
          "seconds": res["seconds"], "worker_starts": res["spawns"],
          "spawn_to_ready_s": res["spawn_to_ready_s"],
          "phase_seconds": {k: r["seconds"]
                            for k, r in res["phases"].items()},
          "counts": {k: r["counts"] for k, r in res["phases"].items()},
          "sigkill_exits": {k: r.get("sigkill_exits")
                            for k, r in res["phases"].items()},
          "frame_errors": res["phases"].get("drop", {}).get("frame_errors"),
          "hang_timeout_s": res["phases"].get("wedge", {})
          .get("hang_timeout_s"),
          "hang_silent_for_s": res["phases"].get("wedge", {})
          .get("silent_for_s"),
          "first_step_s": {k: w.get("serving_first_step_seconds")
                           for k, w in workers.items()},
          "survivor_decode_steps": steps,
          "survivor_launches": {k: w["launches"]
                                for k, w in workers.items()},
          "min_top2_margin": margin, "failures": res["failures"]})
    assert not res["failures"], res["failures"]
    for k, w in workers.items():
        assert w["launches"]["sdpa_plain"] == 0, (k, w)
        assert w["launches"]["paged_decode"] == steps[k] * layers, (k, w)
    return {"paged": counts["paged_decode"], "flash": flash_part(counts)}


# cycles the card spins between the L2 flush and the start event (about
# a millisecond): the host issues fn's launches meanwhile, so the events
# time the device's work and not the wrapper's Python and ctypes time
LAUNCH_COVER_CYCLES = 2_000_000


def cuda_ms(fn, flush, iters=50, clean=False, median=False):
    """Mean device time of fn() over `iters` launches, CUDA events around
    each launch; the L2 cache is overwritten before every launch, as a
    decode step finds each layer's K/V cold, and the card is kept busy
    while the host issues the launch (`LAUNCH_COVER_CYCLES`).  The flush
    writes `flush`, which leaves the L2 full of dirty lines that fn's own
    reads then write back; with `clean` it reads `flush` instead, so fn
    finds a cold L2 with nothing to write back.  With `median`, the
    median launch (for a call whose host side can outlast the cover now
    and then, as an autograd backward's)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if clean:
            flush.max()
        else:
            flush.zero_()
        torch.cuda._sleep(LAUNCH_COVER_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)) if median else sum(times) / iters


def phase_timings(launches, lens):
    from paddle_tpu_torch.ops import paged_decode as pd
    H = Hkv = 16
    D, bs, dtype = 128, 16, torch.bfloat16
    q, kp, vp, tables, lens_t = args = paged_inputs(lens, H, Hkv, D, bs,
                                                    dtype, seed=7)
    err, ok = compare(pd, args, dtype)
    assert ok, f"kernel vs plain at the serving shape: max error {err}"
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    # yardstick: torch SDPA over K/V gathered beforehand into contiguous
    # [B, H, Lmax, D] tensors with a boolean length mask (not paged)
    B, L = len(lens), max(lens)
    K = torch.zeros(B, H, L, D, dtype=dtype, device="cuda")
    V = torch.zeros_like(K)
    for b, n in enumerate(lens):
        idx = tables[b, :-(-n // bs)].long()
        K[b, :, :n] = kp[idx].reshape(-1, Hkv, D)[:n].transpose(0, 1)
        V[b, :, :n] = vp[idx].reshape(-1, Hkv, D)[:n].transpose(0, 1)
    mask = (torch.arange(L, device="cuda")[None, :]
            < lens_t[:, None].long())[:, None, None, :]
    qs = q.transpose(1, 2)                                   # [B, H, 1, D]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def paged(splits):
        return lambda: pd.paged_decode_attention(*args, _splits=splits)

    M = tables.shape[1]
    splits, part = pd.split_plan(M, bs)
    # the one-pass layout and the planned split in turns on the same inputs
    turns = [(n, cuda_ms(paged(n), flush))
             for n in (1, splits, splits, 1)]
    one_pass_ms = sum(t for n, t in turns if n == 1) / 2
    kernel_ms = sum(t for n, t in turns if n == splits) / 2
    # the same with a clean cold L2 (a read flush: nothing to write back)
    clean_turns = [(n, cuda_ms(paged(n), flush, clean=True))
                   for n in (1, splits, splits, 1)]
    clean_ms = {n: sum(t for m, t in clean_turns if m == n) / 2
                for n in (1, splits)}
    # other partition sizes: forced split counts, with the plan's tokens
    sweep = [{"splits": pd.split_plan(M, bs, n)[0],
              "split_tokens": pd.split_plan(M, bs, n)[1],
              "clean_l2_ms": cuda_ms(paged(n), flush, iters=25, clean=True)}
             for n in (2, 3, 4, 6, 9)]
    plain_ms = cuda_ms(lambda: pd.paged_decode_attention_plain(*args), flush)
    library_ms = cuda_ms(lambda: sdpa(qs, K, V, attn_mask=mask), flush)
    library_clean_ms = cuda_ms(lambda: sdpa(qs, K, V, attn_mask=mask), flush,
                               clean=True)

    ctx = sum(lens)
    esize = torch.finfo(dtype).bits // 8
    bytes_moved = (2 * ctx * Hkv * D * esize          # K and V rows read
                   + 2 * q.numel() * esize            # q read, out written
                   + tables.numel() * 4 + B * 4)      # tables and lens
    flops = 4 * ctx * H * D                           # q.k and p.v
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    rtol, atol = TOL[dtype]
    emit({"phase": "timings", "kernel": "paged_decode_attention",
          "shape": {"B": B, "H": H, "Hkv": Hkv, "D": D, "bs": bs,
                    "dtype": "bfloat16", "context_tokens": ctx,
                    "table_cols": M},
          "splits": splits, "split_tokens": part,
          "turns_ms": turns, "one_pass_ms": one_pass_ms,
          "split_speedup": one_pass_ms / kernel_ms,
          "clean_l2_turns_ms": clean_turns,
          "clean_l2_ms": clean_ms[splits],
          "clean_l2_one_pass_ms": clean_ms[1],
          "library_clean_l2_ms": library_clean_ms, "split_sweep": sweep,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "library_ms": library_ms, "bytes": bytes_moved, "flops": flops,
          "bound_ms": max(bytes_ms, ops_ms),
          "achieved_bytes_per_s": bytes_moved / (kernel_ms * 1e-3),
          "clean_l2_bytes_per_s": bytes_moved / (clean_ms[splits] * 1e-3)})
    record = kernel_record(
        "paged_decode_attention", "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/ops/pallas/paged_attention.py:41", launches, err, err,
        {"rtol": rtol, "atol": atol, "dtype": "bfloat16"}, kernel_ms,
        plain_ms, bytes_ms, ops_ms, library_ms,
        "torch SDPA on K/V pre-gathered to contiguous [B, H, Lmax, D] with "
        "a boolean length mask")
    record.update(clean_l2_ms=clean_ms[splits],
                  library_clean_l2_ms=library_clean_ms)
    return record


def kernel_record(name, source, replaces, launches, max_abs_err, max_err,
                  tol, kernel_ms, plain_ms, bytes_ms, ops_ms, library_ms,
                  library):
    """One entry of the {"kernels": [...]} line; every entry has these
    keys.  `max_err` is the error in the measure `tol` is stated in, and
    `max_abs_err` the largest absolute difference; `ms` and `kernel_ms`
    are both the kernel's time (the chip check reads `ms`)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_err": max_err, "max_abs_err": max_abs_err, "tol": tol,
            "kernel_ms": kernel_ms, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "library": library}

# ------------------------------------------------------------ flash kernels
FLASH_SHAPE = dict(B=4, L=1024, H=16, D=128)     # GPT-3 1.3B, seq 1024
FLASH_CASES = [
    # name, B, Lq, Lk, H, Hkv, D, causal, window, mask kind, dtype
    ("train_bf16", 4, 1024, 1024, 16, 16, 128, True, 0, None,
     torch.bfloat16),
    ("train_fp16", 4, 1024, 1024, 16, 16, 128, True, 0, None, torch.float16),
    ("train_fp32", 4, 1024, 1024, 16, 16, 128, True, 0, None, torch.float32),
    ("non_causal_bf16", 4, 1024, 1024, 16, 16, 128, False, 0, None,
     torch.bfloat16),
    ("lq512_lk1024_causal_bf16", 2, 512, 1024, 16, 16, 128, True, 0, None,
     torch.bfloat16),
    ("ragged_1000_bf16", 2, 1000, 1000, 16, 16, 128, True, 0, None,
     torch.bfloat16),
    ("ragged_37_bf16", 4, 37, 37, 16, 16, 128, True, 0, None,
     torch.bfloat16),
    ("gqa_h16_hkv4_bf16", 2, 1024, 1024, 16, 4, 128, True, 0, None,
     torch.bfloat16),
    ("bool_full_mask_bf16", 2, 256, 256, 16, 16, 128, False, 0, "bool_full",
     torch.bfloat16),
    ("additive_row_batch1_bf16", 4, 512, 512, 16, 16, 128, True, 0,
     "additive_row1", torch.bfloat16),
    ("window_256_bf16", 2, 1024, 1024, 16, 16, 128, True, 256, None,
     torch.bfloat16),
    ("d64_bf16", 4, 1024, 1024, 16, 16, 64, True, 0, None, torch.bfloat16),
    ("lq1_masked_bf16", 8, 1, 1024, 16, 16, 128, False, 0, "key_padding",
     torch.bfloat16),
    ("fully_masked_row_fp32", 2, 128, 128, 16, 16, 128, False, 0,
     "dead_rows", torch.float32),
    # the rest of the sm90 cases in float16, and those only sm90 adds
    ("non_causal_fp16", 4, 1024, 1024, 16, 16, 128, False, 0, None,
     torch.float16),
    ("lq512_lk1024_causal_fp16", 2, 512, 1024, 16, 16, 128, True, 0, None,
     torch.float16),
    ("ragged_1000_fp16", 2, 1000, 1000, 16, 16, 128, True, 0, None,
     torch.float16),
    ("ragged_37_fp16", 4, 37, 37, 16, 16, 128, True, 0, None,
     torch.float16),
    ("gqa_h16_hkv4_fp16", 2, 1024, 1024, 16, 4, 128, True, 0, None,
     torch.float16),
    ("window_256_fp16", 2, 1024, 1024, 16, 16, 128, True, 256, None,
     torch.float16),
    ("d64_fp16", 4, 1024, 1024, 16, 16, 64, True, 0, None, torch.float16),
    ("lq1_bf16", 8, 1, 1024, 16, 16, 128, False, 0, None, torch.bfloat16),
    ("lq1_fp16", 8, 1, 1024, 16, 16, 128, False, 0, None, torch.float16),
    ("fused_qkv_views_bf16", 4, 1024, 1024, 16, 16, 128, True, 0,
     "fused_qkv", torch.bfloat16),
    ("fused_qkv_views_fp16", 4, 1024, 1024, 16, 16, 128, True, 0,
     "fused_qkv", torch.float16),
    # the generation paths' bool masks (text/decode.py
    # `_update_prealloc_cache`): a prefill into a longer buffer [1, 1, s,
    # L], a per-row decode step [b, 1, 1, L], a speculative verify [b, 1,
    # k + 1, L]; at Mistral's GQA 32 / 8 and Qwen2-7B's 28 / 4, with and
    # without a window band
    ("prefill_buffer_gqa4_bf16", 2, 512, 576, 32, 8, 128, False, 0,
     "prefill_buffer", torch.bfloat16),
    ("prefill_buffer_window64_gqa4_fp32", 2, 128, 160, 32, 8, 128, False,
     0, "prefill_buffer_w64", torch.float32),
    ("decode_rows_gqa4_bf16", 4, 1, 576, 32, 8, 128, False, 0,
     "decode_rows", torch.bfloat16),
    ("decode_rows_window64_gqa4_bf16", 4, 1, 576, 32, 8, 128, False, 0,
     "decode_rows_w64", torch.bfloat16),
    ("verify_rows_gqa4_bf16", 4, 5, 581, 32, 8, 128, False, 0,
     "verify_rows", torch.bfloat16),
    ("verify_rows_window64_gqa4_fp32", 2, 5, 165, 32, 8, 128, False, 0,
     "verify_rows_w64", torch.float32),
    ("prefill_buffer_gqa7_bf16", 2, 512, 544, 28, 4, 128, False, 0,
     "prefill_buffer", torch.bfloat16),
    ("decode_rows_gqa7_fp16", 4, 1, 544, 28, 4, 128, False, 0,
     "decode_rows", torch.float16),
    ("verify_rows_gqa7_bf16", 4, 5, 549, 28, 4, 128, False, 0,
     "verify_rows", torch.bfloat16),
    # BERT-base's fine-tune shape (batch 32, seq 128, 12 heads of 64),
    # non-causal, unmasked and under its additive key-padding mask [32, 1,
    # 1, 128] ((1 - m) * -1e4, rows 64 to 128 long)
    ("bert_bf16", 32, 128, 128, 12, 12, 64, False, 0, None, torch.bfloat16),
    ("bert_fp16", 32, 128, 128, 12, 12, 64, False, 0, None, torch.float16),
    ("bert_fp32", 32, 128, 128, 12, 12, 64, False, 0, None, torch.float32),
    ("bert_padding_bf16", 32, 128, 128, 12, 12, 64, False, 0, "bert_padding",
     torch.bfloat16),
    ("bert_padding_fp16", 32, 128, 128, 12, 12, 64, False, 0, "bert_padding",
     torch.float16),
    ("bert_padding_fp32", 32, 128, 128, 12, 12, 64, False, 0, "bert_padding",
     torch.float32),
    # the masked sm90 backward's other layouts: rows that see nothing in
    # bf16 (a full mask); a key vector under GQA 16/4, causal, a window of
    # 96 and a ragged Lk of 200 in fp16 (rows past a short row's keys see
    # nothing); a full additive mask per head at B 1 and D 128
    ("dead_rows_bf16", 2, 128, 128, 16, 16, 128, False, 0, "dead_rows",
     torch.bfloat16),
    ("key_padding_gqa4_window96_fp16", 2, 200, 200, 16, 4, 64, True, 96,
     "key_padding", torch.float16),
    ("additive_full_b1_d128_bf16", 1, 320, 320, 16, 16, 128, False, 0,
     "additive_full_h", torch.bfloat16),
    # the fp32 forward's other arguments: a D that is neither 64 nor 128
    # with ragged lengths, a window under GQA 16/4, the strided q/k/v views
    # of a fused qkv, a full bool mask per head, a batch-broadcast key
    # vector under causal masking, Lq < Lk
    ("d96_ragged_300_fp32", 2, 300, 300, 8, 8, 96, True, 0, None,
     torch.float32),
    ("window_256_gqa4_fp32", 2, 1024, 1024, 16, 4, 128, True, 256, None,
     torch.float32),
    ("fused_qkv_views_fp32", 2, 512, 512, 16, 16, 64, True, 0, "fused_qkv",
     torch.float32),
    ("bool_full_mask_d64_fp32", 2, 200, 200, 8, 8, 64, False, 0,
     "bool_full", torch.float32),
    ("additive_row_batch1_fp32", 4, 130, 130, 16, 16, 64, True, 0,
     "additive_row1", torch.float32),
    ("lq100_lk333_causal_fp32", 2, 100, 333, 8, 2, 64, True, 0, None,
     torch.float32),
]


def flash_inputs(B, Lq, Lk, H, Hkv, D, kind, dtype, seed):
    """Unit-normal q, k, v, dO on the card and the case's mask; for
    "fused_qkv", q, k and v are the strided views of one (B, L, 3, H, D)
    tensor, as the GPT attention's qkv projection gives them."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q, k, v, do = rnd(B, Lq, H, D), rnd(B, Lk, Hkv, D), rnd(B, Lk, Hkv, D), \
        rnd(B, Lq, H, D)
    mask = None
    if kind == "fused_qkv":
        q, k, v = rnd(B, Lq, 3, H, D).unbind(2)
    if kind == "bool_full":                 # (B, H, Lq, Lk)
        mask = torch.rand(B, H, Lq, Lk, generator=g, device="cuda") < 0.9
    elif kind == "additive_row1":           # (1, 1, 1, Lk): batch broadcast
        mask = torch.randn(1, 1, 1, Lk, generator=g, device="cuda")
    elif kind == "additive_full_h":         # (B, H, Lq, Lk) additive
        mask = torch.randn(B, H, Lq, Lk, generator=g, device="cuda")
    elif kind == "bert_padding":            # (B, 1, 1, Lk) additive, dtype
        mask = bert_padding_mask(B, Lk, dtype, g)
    elif kind == "key_padding":             # (B, 1, 1, Lk)
        lens = torch.randint(1, Lk + 1, (B,), generator=g, device="cuda")
        mask = (torch.arange(Lk, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
    elif kind == "dead_rows":               # (B, Lq, Lk), rows 3, 77 empty
        mask = torch.rand(B, Lq, Lk, generator=g, device="cuda") < 0.7
        mask[:, 3] = False
        mask[1, 77] = False
    elif kind is not None and kind.split("_w")[0] in (
            "prefill_buffer", "decode_rows", "verify_rows"):
        mask = generation_mask(kind, B, Lq, Lk, g)
    return q, k, v, do, mask


def bert_padding_mask(B, L, dtype, g):
    """BERT's additive key-padding mask [B, 1, 1, L] in `dtype`, as
    `text.bert.additive_mask` builds it: 0 for the first 64 to L keys of
    a row, -1e4 (-9984 in bfloat16) for the rest."""
    from paddle_tpu_torch.text.bert import additive_mask
    lens = torch.randint(L // 2, L + 1, (B,), generator=g, device="cuda")
    keep = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    return additive_mask(keep, dtype)


def generation_mask(kind, B, Lq, Lk, g):
    """The bool masks `_update_prealloc_cache` builds: cols <= pos + row
    (and > pos + row - W with a window "_w<W>"); "prefill_buffer" at pos
    0 for every row ([1, 1, Lq, Lk]), "decode_rows" / "verify_rows" at a
    random pos per row in [Lk / 2, Lk - Lq] ([B, 1, Lq, Lk])."""
    name, _, w = kind.partition("_w")
    cols = torch.arange(Lk, device="cuda")
    if name == "prefill_buffer":
        pos = torch.zeros(1, dtype=torch.long, device="cuda")
    else:
        pos = torch.randint(Lk // 2, Lk - Lq + 1, (B,), generator=g,
                            device="cuda")
    rows = (pos[:, None] + torch.arange(Lq, device="cuda"))[:, :, None]
    mask = cols <= rows
    if w:
        mask &= cols > rows - int(w)
    return mask[:, None]


def zero_counts():
    """Every kernel launch counter (and sdpa.plain_calls) to 0."""
    from paddle_tpu_torch import ops
    ops.add_launch_counts({k: -v for k, v in ops.launch_counts().items()})


def read_counts():
    """The launch counters (`ops.launch_counts()`) once the card has
    finished."""
    from paddle_tpu_torch import ops
    torch.cuda.synchronize()
    return ops.launch_counts()


def flash_part(counts):
    """The flash kernels' counters of `counts` (as `ops.launch_counts()`
    names them): {"fwd", "dkv", "dq", "fwd_sm90", "dkv_sm90", "dq_sm90",
    "fwd_decode", "fwd_fp32", "dkv_fp32", "dq_fp32"}."""
    return {k[len("flash_"):]: v for k, v in counts.items()
            if k.startswith("flash_")}


def flash_counts():
    from paddle_tpu_torch import ops
    return flash_part(ops.launch_counts())


def bwd_error(pairs):
    """(max abs, max abs / max |plain|) over (kernel, plain) pairs."""
    abs_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in pairs)
    rel = max(float((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp(min=1e-30))
              for a, b in pairs)
    return abs_err, rel


def flash_bwd64(fa, q, k, v, do, lse, delta, mask, causal, window):
    """flash_bwd_plain's formula (p = exp(s - lse), lse taken as 0 where
    it is not finite; dS = p (dP - delta)) in float64, given the same
    float32 lse and delta -> (dq, dk, dv) in float64: the float32 kernel's
    and the float32 plain version's gradients are each held against it."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = q.double().permute(0, 2, 1, 3).reshape(B, Hkv, g, Lq, D)
    kf, vf = (x.double().permute(0, 2, 1, 3) for x in (k, v))
    dof = do.double().permute(0, 2, 1, 3).reshape(B, Hkv, g, Lq, D)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kf) * D ** -0.5
    keep = fa._keep(Lq, Lk, causal, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    m4 = fa._normalize_mask(mask)
    if m4 is not None:
        s = s + m4.double().expand(B, H, Lq, Lk).reshape(B, Hkv, g, Lq, Lk)
    l5 = lse.double().reshape(B, Hkv, g, Lq, 1)
    p = torch.exp(s - torch.where(torch.isfinite(l5), l5,
                                  torch.zeros_like(l5)))
    del s
    dv = torch.einsum("bkgqc,bkgqd->bkcd", p, dof)
    dp = torch.einsum("bkgqd,bkcd->bkgqc", dof, vf)
    ds = p * (dp - delta.double().reshape(B, Hkv, g, Lq, 1))
    dk = torch.einsum("bkgqc,bkgqd->bkcd", ds, qf) * D ** -0.5
    dq = torch.einsum("bkgqc,bkcd->bkgqd", ds, kf) * D ** -0.5
    return (dq.reshape(B, H, Lq, D).transpose(1, 2), dk.transpose(1, 2),
            dv.transpose(1, 2))


def fwd_family(grew):
    """The forward family that launched, from the counters' growth."""
    assert grew["fwd"] == 1, grew
    assert grew["fwd_sm90"] + grew["fwd_decode"] + grew["fwd_fp32"] <= 1, \
        grew
    return ("sm90" if grew["fwd_sm90"] else
            "decode" if grew["fwd_decode"] else
            "fp32" if grew["fwd_fp32"] else "sm80")


def flash_errors(fa, q, k, v, do, mask, causal, window, fwd_families=(None,),
                 bwd_families=(None,)):
    """Each kernel against its plain version on the same inputs: for each
    forward family (None: the route's; "sm80" / "sm90" / "decode" /
    "fp32" forced) {"fwd": (max abs, max err, ok), "lse_max_abs_err": x,
    "launched": family} under out["fwd"][family], the decode family
    against `flash_decode_plain` (its own plain version, the same splits)
    and `flash_fwd_plain` both, and the fp32 family launched twice on the
    same inputs, whose o and lse must agree bit for bit
    ("repeat_equal"); for each backward family {"dkv": ..., "dq": ...,
    "launched": family} under out["bwd"][family], given the plain
    forward's lse and delta, the fp32 family launched twice, whose dq, dk
    and dv must agree bit for bit ("repeat_equal").  "launched" is the
    family the launch counters saw (one for dK/dV and dQ).  The first
    backward family also reads "control": the same comparison against
    the plain gradients of a dO with one element (of a row that sees
    keys) moved by 1, which must read a nonzero error, so a comparison
    that reads 0 is known to be able to fail; and in float32
    "vs_float64": the kernel's and the plain version's largest error
    against `flash_bwd64` (max |x - ref| / max |ref|), and whether the
    two agree bit for bit."""
    dtype = q.dtype
    kw = dict(is_causal=causal, window=window)
    ref_o, ref_lse = fa.flash_fwd_plain(q, k, v, mask, **kw)
    rtol, atol = FLASH_FWD_TOL[dtype]
    finite = torch.isfinite(ref_lse)

    def fwd_err(o, lse, want_o, want_lse):
        d = (o.float() - want_o.float()).abs()
        ok = bool((d <= atol + rtol * want_o.float().abs()).all())
        fin = torch.isfinite(want_lse)
        ok = ok and bool(torch.equal(fin, torch.isfinite(lse))) and bool(
            ((lse - want_lse).abs()[fin]
             <= 1e-5 + 1e-5 * want_lse.abs()[fin]).all())
        return float(d.max()), float((lse - want_lse).abs()[fin].max()), ok

    out = {"fwd": {}, "bwd": {}}
    for fam in fwd_families:
        before = flash_counts()
        o, lse = fa.flash_fwd_cuda(q, k, v, mask, **kw, _impl=fam)
        torch.cuda.synchronize()
        after = flash_counts()
        launched = fwd_family({n: after[n] - before[n] for n in after})
        err, lse_err, ok = fwd_err(o, lse, ref_o, ref_lse)
        if launched == "decode":     # and against its own plain version
            e2, l2, ok2 = fwd_err(o, lse, *fa.flash_decode_plain(
                q, k, v, mask, **kw))
            err, lse_err, ok = max(err, e2), max(lse_err, l2), ok and ok2
        out["fwd"][fam] = {"fwd": (err, err, ok), "lse_max_abs_err": lse_err,
                           "launched": launched}
        if launched == "fp32":       # no atomics: a second launch, same bits
            o2, lse2 = fa.flash_fwd_cuda(q, k, v, mask, **kw, _impl="fp32")
            same = bool(torch.equal(o, o2)) and bool(torch.equal(lse, lse2))
            out["fwd"][fam].update(repeat_equal=same)
            out["fwd"][fam]["fwd"] = (err, err, ok and same)
    delta = fa._delta(do, ref_o)
    ref_dq, ref_dk, ref_dv = fa.flash_bwd_plain(q, k, v, do, ref_lse, delta,
                                                mask, **kw)
    b0, h0, r0 = (int(x) for x in torch.nonzero(torch.isfinite(ref_lse))[0])
    do_moved = do.clone()
    do_moved[b0, r0, h0, 0] += 1
    moved = fa.flash_bwd_plain(q, k, v, do_moved, ref_lse, delta, mask, **kw)
    del do_moved
    for fam in bwd_families:
        before = flash_counts()
        dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, ref_lse, delta, mask,
                                       **kw, _impl=fam)
        dq = fa.flash_bwd_dq_cuda(q, k, v, do, ref_lse, delta, mask, **kw,
                                  _impl=fam)
        torch.cuda.synchronize()
        after = flash_counts()
        grew = {n: after[n] - before[n] for n in after}
        assert grew["dkv"] == grew["dq"] == 1 and grew["fwd"] == 0, grew
        pairs = {f: (grew[f"dkv_{f}"], grew[f"dq_{f}"])
                 for f in ("sm90", "fp32")}
        assert all(c in ((0, 0), (1, 1)) for c in pairs.values()) and sum(
            c == (1, 1) for c in pairs.values()) <= 1, grew
        launched = next((f for f, c in pairs.items() if c == (1, 1)), "sm80")
        dkv_abs, dkv_rel = bwd_error(((dk, ref_dk), (dv, ref_dv)))
        dq_abs, dq_rel = bwd_error(((dq, ref_dq),))
        out["bwd"][fam] = {
            "dkv": (dkv_abs, dkv_rel, dkv_rel <= FLASH_BWD_TOL[dtype]),
            "dq": (dq_abs, dq_rel, dq_rel <= FLASH_BWD_TOL[dtype]),
            "launched": launched}
        if launched == "fp32":       # no atomics: a second launch, same bits
            dk2, dv2 = fa.flash_bwd_dkv_cuda(q, k, v, do, ref_lse, delta,
                                             mask, **kw, _impl="fp32")
            dq2 = fa.flash_bwd_dq_cuda(q, k, v, do, ref_lse, delta, mask,
                                       **kw, _impl="fp32")
            same = all(bool(torch.equal(a, b)) for a, b in zip(
                (dq, dk, dv), (dq2, dk2, dv2)))
            out["bwd"][fam]["repeat_equal"] = same
            for name in ("dkv", "dq"):
                e = out["bwd"][fam][name]
                out["bwd"][fam][name] = (e[0], e[1], e[2] and same)
            del dk2, dv2, dq2
        if moved is not None:
            control = {"dkv": bwd_error(((dk, moved[1]), (dv, moved[2])))[1],
                       "dq": bwd_error(((dq, moved[0]),))[1],
                       "moved": [b0, r0, h0, 0]}
            assert control["dkv"] > 0 and control["dq"] > 0, control
            out["bwd"][fam]["control"] = control
            moved = None
        if dtype == torch.float32 and "vs_float64" not in out:
            ref64 = flash_bwd64(fa, q, k, v, do, ref_lse, delta, mask,
                                causal, window)
            out["vs_float64"] = {
                "family": fam or "route",
                "kernel": bwd_error(tuple(zip((dq, dk, dv), ref64)))[1],
                "plain": bwd_error(tuple(zip((ref_dq, ref_dk, ref_dv),
                                             ref64)))[1],
                "bit_equal": all(bool(torch.equal(a, b)) for a, b in zip(
                    (dq, dk, dv), (ref_dq, ref_dk, ref_dv)))}
            del ref64
    return out


def phase_flash_kernels():
    """Every case through the routes, asserting which family launched
    (forward: decode for Lq <= 16, sm90 for bf16 / fp16 at D 64 or 128,
    masked or not, fp32 for float32, sm80 for the rest; backward: sm90
    for bf16 / fp16 at D 64 or 128, masked or not, fp32 for float32,
    sm80 for the rest), then through every other family that takes it
    (`_impl`; sm80 beside each fp32 backward), each against its plain
    version; the route's backward beside its negative control, and in
    float32 against float64 (`flash_errors`); the fp32 forward and
    backward each launched twice, equal bits."""
    from paddle_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False    # full float32 plain
    torch.backends.cudnn.allow_tf32 = False
    results = []
    for i, (name, B, Lq, Lk, H, Hkv, D, causal, window, kind,
            dtype) in enumerate(FLASH_CASES):
        q, k, v, do, mask = flash_inputs(B, Lq, Lk, H, Hkv, D, kind, dtype,
                                         seed=200 + i)
        m4 = fa._normalize_mask(mask)
        half = dtype != torch.float32
        want_fwd = ("decode" if Lq <= fa.DECODE_MAX_LQ else
                    "sm90" if half else "fp32")
        want_bwd = "sm90" if half else "fp32"
        fwd_fams = fa._families(q, k, v, m4, dtype, True)
        bwd_fams = fa._families(q, k, v, m4, dtype, False)
        assert (fwd_fams[0], bwd_fams[0]) == (want_fwd, want_bwd), \
            f"{name}: routed to {fwd_fams[0]} / {bwd_fams[0]}"
        err = flash_errors(fa, q, k, v, do, mask, causal, window,
                           (None,) + fwd_fams[1:], (None,) + bwd_fams[1:])
        rec = {"case": name, "dtype": str(dtype).split(".")[1],
               "shape": [B, Lq, Lk, H, Hkv, D], "causal": causal,
               "window": window, "mask": kind, "route": want_fwd,
               "bwd_route": want_bwd, "fwd_families": list(fwd_fams),
               "bwd_families": list(bwd_fams), "ok": True}
        for fam, e in err["fwd"].items():
            assert e["launched"] == (fam or want_fwd), (name, fam, e)
            tag = fam or want_fwd
            rec.update({f"{tag}_fwd_max_abs_err": e["fwd"][0],
                        f"{tag}_lse_max_abs_err": e["lse_max_abs_err"]})
            if "repeat_equal" in e:
                rec[f"{tag}_repeat_equal"] = e["repeat_equal"]
            rec["ok"] = rec["ok"] and e["fwd"][2]
        for fam, e in err["bwd"].items():
            assert e["launched"] == (fam or want_bwd), (name, fam, e)
            tag = fam or want_bwd
            rec.update({f"{tag}_dkv_max_abs_err": e["dkv"][0],
                        f"{tag}_dkv_max_err": e["dkv"][1],
                        f"{tag}_dq_max_abs_err": e["dq"][0],
                        f"{tag}_dq_max_err": e["dq"][1]})
            rec["ok"] = rec["ok"] and e["dkv"][2] and e["dq"][2]
            if "repeat_equal" in e:
                rec[f"{tag}_bwd_repeat_equal"] = e["repeat_equal"]
            if "control" in e:
                rec["control_dkv_max_err"] = e["control"]["dkv"]
                rec["control_dq_max_err"] = e["control"]["dq"]
        if "vs_float64" in err:
            rec["vs_float64"] = err["vs_float64"]
        results.append(rec)
        del q, k, v, do, mask
    emit({"phase": "flash_kernels",
          "kernels": ["flash_fwd", "flash_dkv", "flash_dq",
                      "flash_fwd_sm90", "flash_dkv_sm90", "flash_dq_sm90",
                      "flash_fwd_decode", "flash_fwd_fp32",
                      "flash_dkv_fp32", "flash_dq_fp32"],
          "fwd_tol": {str(d).split(".")[1]: t
                      for d, t in FLASH_FWD_TOL.items()},
          "bwd_tol": {str(d).split(".")[1]: t
                      for d, t in FLASH_BWD_TOL.items()},
          "masked_sm90_bwd_cases": [
              r["case"] for r in results
              if r["mask"] not in (None, "fused_qkv")
              and r["bwd_route"] == "sm90"],
          "cases": results})
    failed = [r["case"] for r in results if not r["ok"]]
    assert not failed, f"flash kernels disagree with plain: {failed}"
    runs = {f for r in results for f in r["fwd_families"]}
    assert runs == {"decode", "sm90", "fp32", "sm80"}, runs
    # every float32 case ran the fp32 forward (its route above 16 rows,
    # forced below) and the fp32 backward (its route), each twice with
    # equal bits, and the sm80 backward forced beside it
    fp32 = [r for r in results if r["dtype"] == "float32"]
    assert fp32 and all(r["fp32_repeat_equal"] for r in fp32), fp32
    assert all(r["bwd_route"] == "fp32" and r["fp32_bwd_repeat_equal"]
               and "sm80_dkv_max_err" in r for r in fp32), fp32
    torch.cuda.empty_cache()


# ---------------------------------------------------------- tensor_api
TENSOR_API_BUDGET_S = 15.0


def _on_card(out):
    """Every tensor of a result on the card (None when it holds none)."""
    if isinstance(out, (list, tuple)):
        flags = [f for f in (_on_card(o) for o in out) if f is not None]
        return all(flags) if flags else None
    if isinstance(out, torch.Tensor):
        return out.device.type == "cuda"
    return None


def phase_tensor_api():
    """Every public function of the port's `tensor_api`, `linalg`, `fft`
    and `signal` on the card, from the case table the CPU tests read
    (`tests/torch_tensor_api_cases.py`): each case runs on the CPU and
    on the card over the same seeded float32 inputs, TF32 off; every
    tensor result lies on the card and agrees with the CPU's within the
    case's card tolerance (invariants for the decompositions); a random
    function holds its shapes, dtypes and ranges on the card and gives
    the same draws after the same seed; the functions run are every
    public name.  Printed, with no gate: the functions that synchronised
    with the host (`torch.cuda.set_sync_debug_mode("warn")`)."""
    import warnings
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_tensor_api_cases as TC
    import paddle_tpu_torch as P
    from paddle_tpu_torch import device as tdevice
    modules = {m: getattr(P, m) for m in ("tensor_api", "linalg", "fft",
                                          "signal")}
    public = {(m, n) for m, mod in modules.items() for n in mod.__all__}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    place = tdevice._current_place[0]
    ran, synced, failures, case_s = set(), [], [], {}
    t_phase = time.perf_counter()

    def inputs(args, kw, device):
        conv = (lambda a: torch.from_numpy(np.array(a)).to(device))
        return TC.build(args, conv), TC.build(kw, conv)

    def call(case, built, device):
        P.set_device("cpu" if device == "cpu" else "gpu:0")
        return getattr(modules[case.module], case.name)(*built[0],
                                                        **built[1])

    try:
        for case in TC.CASES:
            t_case = time.perf_counter()
            args, kw = case.inputs()
            ran.add((case.module, case.name))
            on_card = inputs(args, kw, "cuda")
            if case.random:
                P.seed(7)
            torch.cuda.synchronize()
            # only the call is watched: the inputs' copies to the card
            # are made before it
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    card = call(case, on_card, "cuda")
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            if case.random:
                P.seed(7)
                again = call(case, inputs(args, kw, "cuda"), "cuda")
            if any("synchroniz" in str(w.message) for w in caught):
                synced.append(case.id)
            if _on_card(card) is False:
                failures.append(f"{case.id}: a result off the card")
            got = TC.to_numpy(card)
            if case.random:
                problems = case.check(got)
                same = TC.mismatch(TC.to_numpy(again), got, 0.0)
                failures += [f"{case.id}: {p}" for p in problems]
                if same is not None:
                    failures.append(f"{case.id}: another draw after the "
                                    f"same seed ({same})")
                continue
            want = TC.to_numpy(call(case, inputs(args, kw, "cpu"), "cpu"))
            if case.post is not None:
                got, want = case.post(got), case.post(want)
            err = TC.mismatch(got, want, case.card_tol)
            if err is not None:
                failures.append(f"{case.id}: {err}")
            case_s[case.id] = time.perf_counter() - t_case
    finally:
        tdevice._current_place[0] = place
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    seconds = time.perf_counter() - t_phase
    emit({"phase": "tensor_api", "cases": len(TC.CASES),
          "functions_run": len(ran), "public_names": len(public),
          "by_module": {m: len(mod.__all__) for m, mod in modules.items()},
          "host_syncs": synced, "functions_that_synced": len(synced),
          "slowest_cases_s": sorted(case_s.items(), key=lambda kv: -kv[1])[:8],
          "failures": failures, "phase_seconds": seconds})
    assert not failures, failures
    assert ran == public, sorted(public ^ ran)
    if seconds > TENSOR_API_BUDGET_S:
        print(f"tensor_api: {seconds:.1f} s, past its {TENSOR_API_BUDGET_S}"
              f" s budget", file=sys.stderr)


# -------------------------------------------------------------- training
def train_flops(n_params, cfg, batch, seq):
    """Model flops of one training step: 6 * N * tokens for the weights
    plus causal attention, 6 * layers * seq * hidden * tokens (the
    non-causal 12 * layers * seq * hidden per token, halved)."""
    tokens = batch * seq
    return (6 * n_params * tokens
            + 6 * cfg.num_layers * seq * cfg.hidden_size * tokens)


def phase_train(steps=10, warmup=3, batch=4, seq=1024):
    from paddle_tpu_torch import amp, ops
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import Adafactor
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM, gpt_loss_fn

    cfg = GPTConfig.from_preset("gpt3-1.3B", vocab_size=50304,
                                max_position_embeddings=seq,
                                hidden_dropout=0.0, attention_dropout=0.0)
    model = GPTForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    opt = Adafactor(learning_rate=1e-4, parameters=model.parameters())
    model, opt = amp.decorate(models=model, optimizers=opt,
                              dtype="bfloat16", master_weight=False)
    step = train_step(model, gpt_loss_fn, opt)
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                           device="cuda")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, times = [], []
    for _ in range(warmup + steps):
        t0 = time.perf_counter()
        losses.append(step(ids, labels).item())     # waits for the card
        times.append(time.perf_counter() - t0)
    counts = flash_counts()
    launches = (counts["fwd"], counts["dkv"], counts["dq"])
    plain_calls = ops.sdpa.plain_calls

    timed = np.array(times[warmup:])
    n_params = sum(p.numel() for p in model.parameters())
    flops = train_flops(n_params, cfg, batch, seq)
    p50 = float(np.percentile(timed, 50))
    emit({"phase": "train", "model": "gpt3-1.3B", "layers": cfg.num_layers,
          "seq": seq, "batch": batch, "dtype": "bfloat16",
          "amp": "O2, master_weight=False", "optimizer": "Adafactor(1e-4)",
          "n_params": n_params, "warmup_steps": warmup, "timed_steps": steps,
          "tokens_per_s": steps * batch * seq / float(timed.sum()),
          "step_p50_ms": p50 * 1e3,
          "step_p99_ms": float(np.percentile(timed, 99)) * 1e3,
          "step_ms": [t * 1e3 for t in times],
          "flops_per_step": flops,
          "mfu": flops / float(timed.mean()) / BF16_FLOPS,
          "mfu_peak_flops": BF16_FLOPS,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
          "losses": losses,
          "flash_launches": counts, "sdpa_plain_calls": plain_calls})
    assert all(np.isfinite(losses)), f"nonfinite loss in {losses}"
    assert abs(losses[0] - np.log(cfg.vocab_size)) < 1.0, \
        f"first loss {losses[0]} is not near ln(V) = {np.log(cfg.vocab_size)}"
    want = cfg.num_layers * (warmup + steps)
    assert launches == (want,) * 3, \
        f"flash launches {launches}, want {want} each"
    assert counts["fwd_sm90"] == counts["dkv_sm90"] == counts["dq_sm90"] \
        == want, f"sm90 launches {counts}, want {want} of each kernel"
    assert plain_calls == 0, f"sdpa took its plain path {plain_calls} times"
    train_check_numerics(model, opt, ids, labels, p50)
    phase_train_profile(step, ids, labels, p50, cfg, batch, seq)
    del step, opt, model
    torch.cuda.empty_cache()
    return counts, losses


def train_check_numerics(model, opt, ids, labels, p50_s, steps=3):
    """C10 on GPT-3 1.3B: TrainSteps with `check_numerics` off and on
    (one bool vector of the loss and every gradient read on the host a
    step) in turns of `steps` steps (off, on, on, off), each step ended
    by `.item()`, the flagged p50 beside the unflagged one and the
    train phase's p50; the check alone on this model's gradients
    (`finite_flags` between CUDA events, and the host's wall to its
    read; 5 calls); then one step
    whose loss is multiplied by NaN must raise FloatingPointError
    naming `loss`, with every parameter bit-equal to its value before
    the step and the gradients dropped."""
    from paddle_tpu_torch.framework import debugging, flags
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.text import gpt_loss_fn

    def poisoned(m, *batch):
        return gpt_loss_fn(m, *batch) * float("nan")

    def turn(step):
        out = []
        for _ in range(steps):
            t0 = time.perf_counter()
            step(ids, labels).item()
            out.append(time.perf_counter() - t0)
        return out

    times = {False: [], True: []}
    try:
        # each step reads the flag on its first call: plain's off,
        # checked's on
        plain = train_step(model, gpt_loss_fn, opt)
        checked = train_step(model, gpt_loss_fn, opt)
        for on in (False, True, True, False):
            flags.set_flags({"check_numerics": on})
            times[on] += turn(checked if on else plain)
        assert (plain._check_numerics, checked._check_numerics) == \
            (False, True)
        # the check's time alone on this model's gradients: CUDA events
        # around finite_flags (the card idle before), and the host's
        # wall to its read
        loss = gpt_loss_fn(model, ids, labels)
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        check_ms, read_ms = [], []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.record()
            flags_vec = debugging.finite_flags(loss, grads)
            b.record()
            flags_vec.tolist()
            read_ms.append((time.perf_counter() - t0) * 1e3)
            b.synchronize()
            check_ms.append(a.elapsed_time(b))
        del grads, loss, flags_vec
        for p in model.parameters():
            p.grad = None
        before = [p.detach().clone() for p in model.parameters()]
        flags.set_flags({"check_numerics": True})
        bad = train_step(model, poisoned, opt)
        message = None
        try:
            bad(ids, labels)
        except FloatingPointError as e:
            message = str(e)
        torch.cuda.synchronize()
        unchanged = all(torch.equal(a, p.detach())
                        for a, p in zip(before, model.parameters()))
        no_grads = all(p.grad is None for p in model.parameters())
        del before
    finally:
        flags.set_flags({"check_numerics": False})
    on_p50 = float(np.percentile(times[True], 50))
    off_p50 = float(np.percentile(times[False], 50))
    emit({"phase": "train_check_numerics", "steps_a_turn": steps,
          "turns": "off, on, on, off",
          "checked_step_p50_ms": on_p50 * 1e3,
          "unchecked_step_p50_ms": off_p50 * 1e3,
          "check_cost_ms_per_step": (on_p50 - off_p50) * 1e3,
          "train_phase_step_p50_ms": p50_s * 1e3,
          "checked_step_ms": [t * 1e3 for t in times[True]],
          "unchecked_step_ms": [t * 1e3 for t in times[False]],
          "finite_flags_event_ms": check_ms,
          "finite_flags_to_host_read_ms": read_ms,
          "poisoned_step_error": message[:160] if message else None,
          "parameters_bit_equal": unchanged, "grads_dropped": no_grads})
    assert message is not None, "the poisoned step did not raise"
    assert message.startswith("check_numerics: non-finite values at step ") \
        and " in: loss, " in message, message
    assert unchanged, "a parameter moved in the poisoned step"
    assert no_grads, "the poisoned step left gradients"


GEMM_TAGS = ("nvjet", "gemm", "cutlass", "xmma")   # cuBLAS kernel names


def phase_train_profile(step, ids, labels, step_p50_s, cfg, batch, seq,
                        steps=2):
    """Where a training step's time goes: `steps` steps under the port's
    `profiler.Profiler` (a torch.profiler window over CPU and CUDA
    activity, its Chrome trace written into a temporary directory), each
    step inside a `RecordEvent`; the busy share is taken against the
    unprofiled step p50 (the profiler's own host cost stretches the wall
    time).  Device time is also split by class: cuBLAS GEMMs, the flash
    kernels, and everything else (optimizer, LayerNorm, GELU, loss,
    casts, copies).  Gates: one RecordEvent a step (the Profiler's table
    and the torch trace's annotations); the busy ms a step within 10 % of
    the same steps under a bare torch.profiler.profile; and
    `program_stats` of one forward and backward of the GPT loss within
    0.85-1.15 of `train_flops`, and the flash operators' own flops (their
    registered formulas, counted on one layer's attention at the training
    shape, forward and backward) equal to 12 * batch * hidden * seq
    (seq + 1) / 2, the causal pairs counted here in closed form (a
    layer's share of `train_flops`'s attention term, which takes seq^2 /
    2 pairs)."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode
    from paddle_tpu_torch import profiler as pprof
    from paddle_tpu_torch.ops.flash_attention import flash_fwd_op
    from paddle_tpu_torch.text import gpt_loss_fn
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="train_profile_") as log_dir:
        p = pprof.Profiler(log_dir=log_dir)
        p.start()
        t0 = time.perf_counter()
        for _ in range(steps):
            with pprof.RecordEvent("train_step"):
                step(ids, labels)
            p.step(num_samples=batch * seq)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        p.stop()
        trace_bytes = sum(os.path.getsize(f) for f in p.trace_files)
    prof = p.torch_profile
    summary_line = p.summary().splitlines()[0]
    recorded = pprof._event_stats["train_step"][0]
    annotated = sum(1 for e in prof.events() if e.name == "train_step"
                    and e.device_type == torch.autograd.DeviceType.CPU)
    events, by_name, busy = device_time(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    flash = {k: sum(us for name, us in by_name.items()
                    if f"flash_{k}_kernel" in name) / steps / 1e3
             for k in ("fwd", "fwd_sm90", "dkv", "dkv_sm90", "dq",
                       "dq_sm90")}
    busy_ms = busy / steps / 1e3
    gemm = sum(us for name, us in by_name.items()
               if any(tag in name.lower() for tag in GEMM_TAGS))
    classes = {"gemm": gemm / steps / 1e3, "flash": sum(flash.values()),
               "other": (sum(by_name.values()) - gemm) / steps / 1e3
               - sum(flash.values())}
    # the same steps under a bare torch.profiler window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as bare:
        for _ in range(steps):
            step(ids, labels)
        torch.cuda.synchronize()
    bare_busy_ms = device_time(bare)[2] / steps / 1e3
    # FLOPs of one forward and backward against the model count, and the
    # flash operators' registered formulas on one layer's attention
    model = step.model
    n_params = sum(q.numel() for q in model.parameters())
    want = train_flops(n_params, cfg, batch, seq)
    stats = pprof.program_stats(
        lambda: gpt_loss_fn(model, ids, labels).backward())
    for q in model.parameters():
        q.grad = None
    heads, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    q = torch.randn(batch, seq, heads, hd, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        flash_fwd_op(q, q, q, None, True, hd ** -0.5, 0)[0].sum().backward()
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"]
             .items()}
    flash_flops = sum(v for k, v in by_op.items() if "flash_" in k)
    # forward 4 * B * hidden * pairs a layer, backward twice that; row r
    # of a causal square attends to r + 1 keys
    attention = 12 * batch * cfg.hidden_size * (seq * (seq + 1) // 2)
    emit({"phase": "train_profile", "steps": steps, "device_events": events,
          "profiler_summary": summary_line,
          "record_events": recorded, "annotations_in_trace": annotated,
          "chrome_trace_bytes": trace_bytes,
          "profiled_wall_ms_per_step": wall_us / steps / 1e3,
          "unprofiled_step_p50_ms": step_p50_s * 1e3,
          "device_busy_ms_per_step": busy_ms,
          "bare_profiler_busy_ms_per_step": bare_busy_ms,
          "busy_vs_bare": busy_ms / bare_busy_ms,
          "device_busy_share": busy_ms / (step_p50_s * 1e3),
          "device_busy_share_of_profiled_wall": busy / wall_us,
          "flash_kernel_ms_per_step": flash,
          "flash_share_of_busy": sum(flash.values()) / busy_ms,
          "kernel_class_ms_per_step": classes,
          "program_stats_flops": stats["flops"], "train_flops": want,
          "program_stats_over_train_flops": stats["flops"] / want,
          "flash_operator_flops_a_layer": flash_flops,
          "attention_flops_a_layer_expected": attention,
          "top_device_ms_per_step": [[name[:90], us / steps / 1e3]
                                     for name, us in top]})
    assert recorded == steps and annotated == steps, (recorded, annotated)
    assert abs(busy_ms / bare_busy_ms - 1) <= 0.10, (busy_ms, bare_busy_ms)
    assert 0.85 <= stats["flops"] / want <= 1.15, (stats, want)
    assert flash_flops == attention, (flash_flops, attention)


FLEET_STEPS = 10


def phase_fleet(train_losses, steps=FLEET_STEPS, batch=4, seq=1024):
    """The distributed slice at world size 1 over NCCL.  (a)
    `init_parallel_env()`, `fleet.init` (dp 1, mp 1, sharding_stage 2)
    and `fleet.build_train_step` train `train`'s GPT-3 1.3B (pure bf16,
    Adafactor) from the same weights and batch: the loss series equals
    TrainStep's bit for bit (with one rank the fleet step issues no
    collective and runs TrainStep's ops in TrainStep's order), and each
    step launches the sm90 forward, dK/dV and dQ 24 times, as train's
    steps do; step p50 and busy share.  (b) `ring_attention` at the
    training shape (B 4, L 1024, H 16, D 128, causal, bf16) through
    `flash_block_fwd` / `flash_block_bwd`: output and dq, dk, dv equal
    `flash_attention`'s bit for bit, with one sm90 forward, dK/dV and
    dQ a call.  Returns the two runs' launch counts."""
    import torch.distributed as tdist

    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet, ring_attention
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import Adafactor
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM, gpt_loss_fn

    t_phase = time.perf_counter()
    dist.init_parallel_env()
    assert tdist.get_backend() == "nccl" and dist.get_world_size() == 1
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(dp_degree=1, mp_degree=1,
                                   sharding_stage=2)
    fleet.init(is_collective=True, strategy=strategy)
    cfg = GPTConfig.from_preset("gpt3-1.3B", vocab_size=50304,
                                max_position_embeddings=seq,
                                hidden_dropout=0.0, attention_dropout=0.0)
    model = GPTForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    opt = Adafactor(learning_rate=1e-4, parameters=model.parameters())
    model, opt = amp.decorate(models=model, optimizers=opt,
                              dtype="bfloat16", master_weight=False)
    step = fleet.build_train_step(model, gpt_loss_fn, opt)
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                           device="cuda")
    torch.cuda.synchronize()
    zero_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step(ids, labels).item())
        times.append(time.perf_counter() - t0)
    counts = flash_counts()
    p50_ms = float(np.percentile(times[3:], 50)) * 1e3
    prof = busy(lambda: step(ids, labels), 2, p50_ms)
    loss_gap = max(abs(a - b) for a, b in zip(losses, train_losses))
    del step, opt, model
    release()

    B, L, H, D = (FLASH_SHAPE[k] for k in ("B", "L", "H", "D"))
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn(B, L, H, D, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    runs = []
    for fn in (lambda a, b, c: fa.flash_attention(a, b, c, is_causal=True),
               lambda a, b, c: ring_attention(a, b, c, causal=True)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        zero_counts()
        o = fn(*leaves)
        o.backward(do)
        runs.append(([o.detach()] + [t.grad for t in leaves],
                     flash_counts()))
    (ref, _), (got, ring_counts) = runs
    ring_err = {n: float((a.float() - b.float()).abs().max())
                for n, a, b in zip(("o", "dq", "dk", "dv"), got, ref)}
    ring_equal = all(torch.equal(a, b) for a, b in zip(got, ref))
    dist.destroy_process_group()
    # the mesh over the destroyed group goes with it: a later compile
    # would key its graphs to a topology that no longer exists
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    mesh_mod.clear_mesh()
    emit({"phase": "fleet", "model": "gpt3-1.3B", "layers": cfg.num_layers,
          "seq": seq, "batch": batch, "dtype": "bfloat16",
          "optimizer": "Adafactor(1e-4)", "world_size": 1,
          "backend": "nccl", "strategy": {"dp": 1, "mp": 1,
                                          "sharding_stage": 2},
          "steps": steps, "losses": losses,
          "train_losses": train_losses[:steps],
          "loss_max_abs_gap_to_train": loss_gap,
          "step_ms": [t * 1e3 for t in times],
          "step_p50_ms_after_3": p50_ms,
          "device_busy_share": prof["device_busy_share"],
          "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
          "flash_launches": counts,
          "ring_shape": {"B": B, "L": L, "H": H, "D": D, "causal": True},
          "ring_launches": ring_counts, "ring_max_abs_err": ring_err,
          "ring_equals_flash_attention": ring_equal,
          "phase_seconds": time.perf_counter() - t_phase})
    assert losses == train_losses[:steps], \
        f"fleet losses {losses} differ from TrainStep's {train_losses}"
    want = cfg.num_layers * steps
    assert counts["fwd_sm90"] == counts["dkv_sm90"] == \
        counts["dq_sm90"] == want, f"sm90 launches {counts}, want {want}"
    assert counts["fwd"] == counts["dkv"] == counts["dq"] == want, counts
    assert (ring_counts["fwd_sm90"], ring_counts["dkv_sm90"],
            ring_counts["dq_sm90"]) == (1, 1, 1), ring_counts
    assert ring_equal, f"ring attention differs from flash: {ring_err}"
    return {"fleet": counts, "fleet/ring": ring_counts}


def phase_train_e2e(steps=3, batch=2, seq=128):
    """The port's training step on the card against the same on the CPU:
    2 layers at full width in float32, AdamW, the same weights and batch.
    The card runs the flash kernels, the CPU the plain versions."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM, gpt_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig.from_preset("gpt3-1.3B", num_layers=2,
                                max_position_embeddings=seq,
                                hidden_dropout=0.0, attention_dropout=0.0)
    card = GPTForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(2))
    cpu = GPTForCausalLM(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    init = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))

    def train(model, dev):
        step = train_step(model, gpt_loss_fn,
                          AdamW(learning_rate=1e-4, weight_decay=0.01,
                                parameters=model.parameters()))
        return [step(ids.to(dev), labels.to(dev)).item()
                for _ in range(steps)]

    zero_counts()
    card_losses = train(card, "cuda")
    counts = flash_counts()
    # float32: the fp32 forward, dK/dV and dQ, 2 layers a step
    assert counts == {"fwd": steps * 2, "dkv": steps * 2, "dq": steps * 2,
                      "fwd_sm90": 0, "dkv_sm90": 0, "dq_sm90": 0,
                      "fwd_decode": 0, "fwd_fp32": steps * 2,
                      "dkv_fp32": steps * 2, "dq_fp32": steps * 2}, counts
    assert ops.sdpa.plain_calls == 0
    t0 = time.perf_counter()
    cpu_losses = train(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                       cpu_losses))
    # the parameters' distance, relative to how far the updates moved them
    num = den = 0.0
    card_params = dict(card.named_parameters())
    for n, p in cpu.named_parameters():
        num += float((card_params[n].detach().cpu() - p.detach())
                     .double().square().sum())
        den += float((p.detach() - init[n]).double().square().sum())
    param_err = (num / den) ** 0.5
    emit({"phase": "train_e2e", "model": "gpt3-1.3B width, 2 layers",
          "dtype": "float32", "optimizer": "AdamW(1e-4, wd 0.01)",
          "batch": batch, "seq": seq, "steps": steps,
          "card_losses": card_losses, "cpu_losses": cpu_losses,
          "loss_max_rel_err": loss_err, "loss_tol": 1e-5,
          "param_rel_err": param_err, "param_tol": 1e-3,
          "cpu_seconds": cpu_s, "flash_launches": counts})
    assert loss_err <= 1e-5, f"card and CPU losses differ by {loss_err}"
    assert param_err <= 1e-3, f"card and CPU parameters differ: {param_err}"
    del card, cpu
    torch.cuda.empty_cache()
    return counts


def phase_flash_timings(paths):
    """Each flash kernel at the training shape (bf16, causal): its time
    with the L2 flushed, its plain version's, PyTorch's fused attention as
    the yardstick, and the least time the card could take.  The sm80 and
    sm90 forward, dK/dV and dQ are timed on the same inputs in turns:
    sm80, sm90, sm90, sm80.  The decode forward is timed at the Mistral-7B
    decode shape, the launch every generated token pays a layer, and the
    sm90 forward at generation's masked prefill, each beside the sm80
    forward.  `paths` maps each main path's run to its launch counts (as
    `flash_part` names them); each kernel's `launches` is their sum.  The
    fp32 forward's record is timed at ERNIE's shape, the main path that
    runs it; the fp32 dK/dV and dQ records at bert_fp32_train's shape
    (ERNIE's, masked); the sm80 forward, dK/dV and dQ run on no main path
    any more (asserted), and their records keep their times."""
    from paddle_tpu_torch.ops import flash_attention as fa
    B, L, H, D = (FLASH_SHAPE[k] for k in ("B", "L", "H", "D"))
    dtype = torch.bfloat16
    q, k, v, do, _ = flash_inputs(B, L, L, H, H, D, None, dtype, seed=9)
    err = flash_errors(fa, q, k, v, do, None, True, 0, ("sm80", "sm90"),
                       ("sm80", "sm90"))
    assert all(err["fwd"][f]["fwd"][2] and err["bwd"][f][n][2]
               for f in ("sm80", "sm90") for n in ("dkv", "dq")), err
    o, lse = fa.flash_fwd_cuda(q, k, v, is_causal=True)
    delta = fa._delta(do, o)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    kw = dict(is_causal=True)

    def fwd(impl):
        return lambda: fa.flash_fwd_cuda(q, k, v, **kw, _impl=impl)

    def dkv(impl):
        return lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw,
                                             _impl=impl)

    def dq(impl):
        return lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw,
                                            _impl=impl)

    turns = {}
    for name, fn in (("fwd", fwd), ("dkv", dkv), ("dq", dq)):
        turns[name] = [(impl, cuda_ms(fn(impl), flush, iters=25))
                       for impl in ("sm80", "sm90", "sm90", "sm80")]
    ms = {f"{name}{'' if impl == 'sm80' else '_sm90'}":
          sum(t for i, t in turns[name] if i == impl) / 2
          for name in ("fwd", "dkv", "dq") for impl in ("sm80", "sm90")}
    plain_fwd_ms = cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, **kw), flush,
                           iters=10)
    plain_bwd_ms = cuda_ms(lambda: fa.flash_bwd_plain(q, k, v, do, lse,
                                                      delta, **kw), flush,
                           iters=10)
    # yardstick: torch's fused attention on [B, H, L, D], forward alone
    # and its backward (dq, dk, dv together) through autograd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        lib_fwd_ms = cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=True), flush)
    out = sdpa(qh, kh, vh, is_causal=True)
    lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qh, kh, vh), doh, retain_graph=True), flush)
    # after the training shape's yardsticks: run before them, its masked
    # SDPA calls left SDPA's causal backward at the training shape 2.7x
    # slower on an H100
    bert = bert_shape_timing(fa, flush)
    fp32_fwd = fp32_fwd_timing(fa, flush)
    fp32_bwd = fp32_bwd_timing(fa, flush)

    esize = 2
    tensor = B * L * H * D * esize                   # one bf16 operand
    rows = B * H * L * 4                             # one float32 lse row
    visible = B * H * L * (L + 1) // 2               # causal (q, k) pairs
    product = 2 * visible * D                        # one product's flops
    costs = {  # kernel: (bytes read once + written once, flops)
        "fwd": (3 * tensor + tensor + rows, 2 * product),
        "dkv": (4 * tensor + 2 * rows + 2 * tensor, 4 * product),
        "dq": (4 * tensor + 2 * rows + tensor, 3 * product),
    }
    rec = {"phase": "flash_timings", "shape": dict(FLASH_SHAPE, dtype="bf16",
                                                   causal=True),
           "turns_ms": turns,
           "sm90_speedup": {n: ms[n] / ms[f"{n}_sm90"]
                            for n in ("fwd", "dkv", "dq")},
           "dkv_plus_dq_ms": ms["dkv_sm90"] + ms["dq_sm90"],
           "library_bwd_ms": lib_bwd_ms}
    lib_bwd = "torch SDPA backward (dq, dk and dv together), is_causal"
    entries = []
    for kname, base, source, line, lib in (
            ("fwd", "fwd", "flash_attention.cu", 84,
             "torch SDPA forward, is_causal, on [B, H, L, D]"),
            ("dkv", "dkv", "flash_attention.cu", 262, lib_bwd),
            ("dq", "dq", "flash_attention.cu", 312, lib_bwd),
            ("fwd_sm90", "fwd", "flash_attention_sm90.cu", 84,
             "torch SDPA forward, is_causal, on [B, H, L, D]"),
            ("dkv_sm90", "dkv", "flash_attention_sm90.cu", 262, lib_bwd),
            ("dq_sm90", "dq", "flash_attention_sm90.cu", 312, lib_bwd)):
        nbytes, flops = costs[base]
        kernel_ms = ms[kname]
        plain_ms = plain_fwd_ms if base == "fwd" else plain_bwd_ms
        library_ms = lib_fwd_ms if base == "fwd" else lib_bwd_ms
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS * 1e3
        rec[kname] = {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bytes": nbytes,
                      "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                      "achieved_tflops": flops / (kernel_ms * 1e-3) / 1e12}
        fam = "sm90" if kname.endswith("_sm90") else "sm80"
        e = (err["fwd"][fam] if base == "fwd" else err["bwd"][fam])[base]
        tol = ({"rtol": FLASH_FWD_TOL[dtype][0],
                "atol": FLASH_FWD_TOL[dtype][1], "dtype": "bfloat16"}
               if base == "fwd" else
               {"max_err_over_max_abs": FLASH_BWD_TOL[dtype],
                "dtype": "bfloat16"})
        if kname.endswith("_sm90"):
            by_path = {p: c[kname] for p, c in paths.items()}
        else:   # sm80 launches: all launches less the others' ones
            by_path = {p: c[base] - c[f"{base}_sm90"]
                       - c.get(f"{base}_decode", 0) - c.get(f"{base}_fp32", 0)
                       for p, c in paths.items()}
        n = sum(by_path.values())
        record = kernel_record(
            f"flash_attention_{kname}", f"paddle_tpu_torch/csrc/{source}",
            f"paddle_tpu/ops/pallas/flash_attention.py:{line}", n, e[0],
            e[1], tol, kernel_ms, plain_ms, bytes_ms, ops_ms, library_ms,
            lib)
        record["launches_by_path"] = by_path
        record["bert_shape"] = {
            "unmasked_ms": bert["unmasked"]["ms"][base][fam],
            "masked_ms": bert["masked"]["ms"][base].get(fam),
            "bound_ms": {k: bert[k]["bounds"][base]["bound_ms"]
                         for k in ("unmasked", "masked")},
            "library_ms": {k: bert[k]["ms"]["fwd" if base == "fwd" else
                                            "dkv"]["sdpa" if base == "fwd"
                                                   else "sdpa_bwd"]
                           for k in ("unmasked", "masked")}}
        if kname == "fwd_sm90":
            record["masked_prefill"] = rec["masked_prefill"] = \
                masked_prefill_timing(fa, flush)
        if kname in ("fwd", "dkv", "dq"):
            # every forward and backward of the main paths takes another
            # family now (the float32 backward the fp32 kernels)
            record["on_main_paths"] = False
            assert n == 0, f"the sm80 {kname} launched {by_path}"
        else:
            assert n > 0, f"{kname} launched no time on the main paths"
        if kname == "fwd":
            record["fp32_shapes"] = {
                shape: {mk: {k: r[k] for k in ("sm80_ms", "ms", "library_ms",
                                               "bound_ms",
                                               "sm80_max_abs_err")}
                        for mk, r in fp32_fwd[shape].items()
                        if mk in ("unmasked", "masked")}
                for shape in ("ernie", "train_fp32")}
        if kname in ("dkv", "dq"):
            record["fp32_shapes"] = {
                shape: {mk: {"ms": r["sm80_ms"][kname],
                             "bound_ms": r["bounds"][kname]["bound_ms"],
                             "library_ms": r["library_ms"],
                             "library_bound_ms":
                             r["bounds"]["sdpa_bwd"]["bound_ms"],
                             "max_err": r[f"sm80_{kname}_max_err"]}
                        for mk, r in fp32_bwd[shape].items()
                        if mk in ("unmasked", "masked")}
                for shape in ("bert_e2e", "ernie", "train_fp32")}
        entries.append(record)
    decode = decode_shape_timing(fa, flush)
    rec["mistral_decode"] = decode
    by_path = {p: c["fwd_decode"] for p, c in paths.items()}
    record = kernel_record(
        "flash_fwd_decode", "paddle_tpu_torch/csrc/flash_decode.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:84",
        sum(by_path.values()), decode["max_abs_err"], decode["max_abs_err"],
        {"rtol": FLASH_FWD_TOL[dtype][0], "atol": FLASH_FWD_TOL[dtype][1],
         "dtype": "bfloat16"}, decode["ms"], decode["plain_ms"],
        decode["bytes_ms"], decode["ops_ms"], decode["library_ms"],
        decode["library"])
    record.update(launches_by_path=by_path, decode_shape=decode)
    entries.append(record)
    assert record["launches"] > 0, "the decode forward launched no time"
    # the fp32 forward: at ERNIE's shape, as ernie_infer runs it (no mask)
    e32 = fp32_fwd["ernie"]["unmasked"]
    by_path = {p: c["fwd_fp32"] for p, c in paths.items()}
    record = kernel_record(
        "flash_attention_fwd_fp32", "paddle_tpu_torch/csrc/flash_fwd_fp32.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:84",
        sum(by_path.values()), e32["max_abs_err"], e32["max_abs_err"],
        {"rtol": FLASH_FWD_TOL[torch.float32][0],
         "atol": FLASH_FWD_TOL[torch.float32][1], "dtype": "float32"},
        e32["ms"], e32["plain_ms"], e32["bytes_ms"], e32["ops_ms"],
        e32["library_ms"], fp32_fwd["library"])
    record.update(launches_by_path=by_path, shape="ernie", fp32_shapes={
        shape: {mk: {k: r[k] for k in ("ms", "sm80_ms", "library_ms",
                                       "plain_ms", "bound_ms",
                                       "share_of_bound", "max_abs_err")}
                for mk, r in fp32_fwd[shape].items()
                if mk in ("unmasked", "masked")}
        for shape in ("ernie", "train_fp32")})
    entries.append(record)
    assert record["launches"] > 0, "the fp32 forward launched no time"
    for shape in ("ernie", "train_fp32"):
        for mk in ("unmasked", "masked"):
            r = fp32_fwd[shape].get(mk)
            assert r is None or r["ms"] < r["sm80_ms"], (shape, mk, r)
    # the fp32 dK/dV and dQ: at bert_fp32_train's shape and mask (ERNIE's
    # shape, B 32, L 128, H 12, D 64, the key-padding mask)
    for kname, line in (("dkv", 262), ("dq", 312)):
        r = fp32_bwd["ernie"]["masked"]
        b = r["bounds"][kname]
        by_path = {p: c[f"{kname}_fp32"] for p, c in paths.items()}
        record = kernel_record(
            f"flash_attention_{kname}_fp32",
            "paddle_tpu_torch/csrc/flash_bwd_fp32.cu",
            f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            sum(by_path.values()), r[f"{kname}_max_abs_err"],
            r[f"{kname}_max_err"],
            {"max_err_over_max_abs": FLASH_BWD_TOL[torch.float32],
             "dtype": "float32"},
            r["ms"][kname], r["plain_ms"], b["bytes_ms"], b["ops_ms"],
            r["library_ms"], fp32_bwd["library"])
        record.update(
            launches_by_path=by_path, shape="ernie, masked",
            plain_note="the plain backward computes dq, dk and dv together",
            fp32_shapes={
                shape: {mk: {"ms": x["ms"][kname],
                             "sm80_ms": x["sm80_ms"][kname],
                             "dkv_plus_dq_ms": x["dkv_plus_dq_ms"],
                             "sm80_dkv_plus_dq_ms": x["sm80_dkv_plus_dq_ms"],
                             "library_ms": x["library_ms"],
                             "plain_ms": x["plain_ms"],
                             "bound_ms": x["bounds"][kname]["bound_ms"],
                             "share_of_bound":
                             x["bounds"][kname]["bound_ms"]
                             / x["ms"][kname],
                             "max_err": x[f"{kname}_max_err"]}
                        for mk, x in fp32_bwd[shape].items()
                        if mk in ("unmasked", "masked")}
                for shape in ("bert_e2e", "ernie", "train_fp32")})
        entries.append(record)
        assert record["launches"] > 0, f"the fp32 {kname} launched no time"
    for shape in ("bert_e2e", "ernie"):
        for mk in ("unmasked", "masked"):
            r = fp32_bwd[shape][mk]
            assert r["dkv_plus_dq_ms"] < r["sm80_dkv_plus_dq_ms"], \
                (shape, mk, r["dkv_plus_dq_ms"], r["sm80_dkv_plus_dq_ms"])
    rec["bert_shape"] = bert
    rec["fp32_fwd"] = fp32_fwd
    rec["fp32_bwd"] = fp32_bwd
    rec["plain_note"] = ("dkv and dq share one plain backward (dq, dk and "
                         "dv together)")
    emit(rec)
    return entries


# ------------------------------------------------------------- generation
# A token a bfloat16 path emits must lie within MARGIN_TOL of its row's
# largest logit under a dense teacher-forced float32 forward of the same
# weights (beam search: of the row's beam-th largest logit, since a
# surviving beam's token ranks within the top `beam` of its row).  These
# random-weight models' logits have a std of about 1.3 (0.02 x
# sqrt(hidden) after the final RMSNorm): a wrong mask or kernel puts a
# token about 2 std below the maximum; bfloat16 rounding moves a logit by
# hundredths (the record prints the dense bf16-vs-float32 error beside).
MARGIN_TOL = 0.5


def sync_time(fn):
    """(fn(), wall seconds), the card idle before and finished after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def step_ms(step, n):
    """Wall ms of each of n calls of step(), each ended by a synchronize:
    the latency a streamed token waits."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def release():
    """Collect reference cycles first (a model can sit in one until the
    collector runs), then hand the cached blocks back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def pct(xs):
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))}


def busy(step, n, p50_ms):
    """torch.profiler over n calls of step(): device busy ms a step (the
    union of kernel spans) and its share of the unprofiled step p50."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events, by_name, busy_us = device_time(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    busy_ms = busy_us / n / 1e3
    return {"steps": n, "device_events": events,
            "device_busy_ms_per_step": busy_ms,
            "unprofiled_step_p50_ms": p50_ms,
            "device_busy_share": busy_ms / p50_ms,
            "profiled_wall_ms_per_step": wall_us / n / 1e3,
            "device_busy_share_of_profiled_wall": busy_us / wall_us,
            "flash_ms_per_step": sum(us for name, us in by_name.items()
                                     if "flash_" in name) / n / 1e3,
            "flash_bwd_ms_per_step": sum(
                us for name, us in by_name.items()
                if "flash_dkv" in name or "flash_dq" in name) / n / 1e3,
            "top_device_ms_per_step": [[name[:80], us / n / 1e3]
                                       for name, us in top],
            "top_host_self_ms_per_step": [[e.key[:60],
                                           e.self_cpu_time_total / n / 1e3,
                                           e.count // n] for e in host[:8]]}


def lm_logits(model, seqs, start):
    """Teacher-forced logits [b, n - start, V] (float32) of the tokens of
    seqs [b, n] from column `start` on, through the dense forward."""
    with torch.no_grad():
        h = model.llama(seqs[:, :-1])[:, start - 1:]
        return model.lm_head(h).float()


def margin(logits, seqs, start, beam=1):
    """The largest (row's beam-th largest logit - chosen token's logit)
    over the tokens of seqs from column `start` on."""
    chosen = logits.gather(-1, seqs[:, start:, None])[..., 0]
    ref = logits.topk(beam, dim=-1).values[..., -1]
    return float((ref - chosen).max())


def phase_generate(batch=4, prompt=512, new=64, beams=4, beam_new=16,
                   k=4, profile_steps=8, layers=None):
    """Mistral-7B (full width and depth, bf16, random weights from seed
    0): `generate(use_jit=True)` (the captured decode step) against the
    eager loop (concat caches) and the uncaptured static step, beam search
    at batch 1, speculative decoding with a 2-layer draft; then every
    path's tokens against a dense float32 forward of the same weights."""
    from paddle_tpu_torch.text import LlamaConfig, LlamaForCausalLM, generate
    from paddle_tpu_torch.text import decode

    cfg = LlamaConfig.from_preset(
        "mistral-7b", **({"num_layers": layers} if layers else {}))
    model = LlamaForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0))
    # the draft: the target's embedding, first 2 layers, final norm and
    # head (a layer-skip draft of the same width)
    dcfg = LlamaConfig.from_preset("mistral-7b", num_layers=2)
    draft = LlamaForCausalLM(
        dcfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(1))
    own = draft.state_dict()
    draft.load_state_dict({n: t for n, t in model.state_dict().items()
                           if n in own})
    g = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                        device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the captured loop: the first call builds the program and captures
    # the step, the second replays it
    first, build_s = sync_time(lambda: model.generate(ids,
                                                      max_new_tokens=new))
    zero_counts()
    captured, cap_s = sync_time(lambda: model.generate(ids,
                                                       max_new_tokens=new))
    paths = {"captured": read_counts()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    key = (prompt, new, False, 1.0, None, None, None, batch)
    prog = model._jit_decode_cache[key]
    assert prog.graph is not None, "the decode step was not captured"
    mallocs = torch.cuda.memory_stats()["num_device_alloc"]
    _, prefill_s = sync_time(lambda: prog.prefill(ids))
    mallocs = torch.cuda.memory_stats()["num_device_alloc"] - mallocs
    prefill_prof = busy(lambda: prog.prefill(ids), 1, prefill_s * 1e3)
    cap_steps = step_ms(prog.step, new - 1)
    prog.prefill(ids)
    cap_prof = busy(prog.step, profile_steps, pct(cap_steps)["p50"])

    # the eager loop over concat caches
    zero_counts()
    eager, eager_s = sync_time(lambda: model.generate(ids, max_new_tokens=new,
                                                      use_jit=False))
    paths["eager"] = read_counts()
    with torch.no_grad():
        caches = model.new_caches(batch)
        tok = [model(ids, caches=caches)[:, -1:].argmax(-1)]

        def eager_step():
            tok[0] = model(tok[0], caches=caches)[:, -1:].argmax(-1)

        eager_steps = step_ms(eager_step, new - 1 - profile_steps)
        eager_prof = busy(eager_step, profile_steps,
                          pct(eager_steps)["p50"])
    del caches

    # the same static step, uncaptured (launched op by op)
    static, static_s = sync_time(lambda: decode.jit_generate(
        model, ids, max_new_tokens=new, _capture=False))
    prog = model._jit_decode_cache[key]
    prog.prefill(ids)
    static_steps = step_ms(prog.step, new - 1 - profile_steps)
    static_prof = busy(prog.step, profile_steps, pct(static_steps)["p50"])

    zero_counts()
    beam, beam_s = sync_time(lambda: generate(
        model, ids[:1], max_new_tokens=beam_new, num_beams=beams))
    paths["beam"] = read_counts()
    zero_counts()
    spec, spec_s = sync_time(lambda: generate(
        model, ids, max_new_tokens=new, draft_model=draft,
        num_speculative_tokens=k))
    paths["speculative"] = read_counts()
    # each round launches the flash forward once a layer in k + 1 draft
    # steps and in one verify; the prefills once a layer of each model
    per_round = (k + 1) * dcfg.num_layers + cfg.num_layers
    rounds = (paths["speculative"]["flash_fwd"]
              - cfg.num_layers - dcfg.num_layers) / per_round
    # greedy acceptance of a proposal is the draft's argmax agreeing with
    # the target's token on the target's own prefix: teacher-forced over
    # the emitted tokens it is the per-token acceptance probability
    with torch.no_grad():
        dl = lm_logits(draft, captured, prompt)
        agree = float((dl.argmax(-1) == captured[:, prompt:]).float().mean())
        bf16_logits = lm_logits(model, captured, prompt)
    model._jit_decode_cache.clear()
    del draft, prog, dl

    # the margin check in float32 (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.float()
    outs = {"captured": captured, "eager": eager, "static": static,
            "speculative": spec}
    margins, dense_err = {}, None
    for name, seqs in outs.items():
        logits = lm_logits(model, seqs, prompt)
        margins[name] = margin(logits, seqs, prompt)
        if name == "captured":
            dense_err = float((bf16_logits.float() - logits).abs().max())
            top1 = float((logits.argmax(-1) == seqs[:, prompt:]).float()
                         .mean())
        del logits
    margins["beam"] = margin(lm_logits(model, beam, prompt), beam, prompt,
                             beam=beams)
    del bf16_logits
    families = {name: {"flash_fwd_sm80": c["flash_fwd"] - c["flash_fwd_sm90"]
                       - c["flash_fwd_decode"] - c["flash_fwd_fp32"],
                       "flash_fwd_sm90": c["flash_fwd_sm90"],
                       "flash_fwd_decode": c["flash_fwd_decode"],
                       "sdpa_plain_calls": c["sdpa_plain"]}
                for name, c in paths.items()}
    tok = batch * new
    emit({"phase": "generate", "model": "mistral-7b", "dtype": "bfloat16",
          "layers": cfg.num_layers, "n_params": n_params, "batch": batch,
          "prompt_tokens": prompt, "new_tokens": new,
          "captured": {"tokens_per_s": tok / cap_s, "wall_s": cap_s,
                       "first_call_s": build_s,
                       "decode_tokens_per_s": batch * 1e3
                       / pct(cap_steps)["p50"],
                       "step_ms": pct(cap_steps), "profile": cap_prof},
          "eager": {"tokens_per_s": tok / eager_s, "wall_s": eager_s,
                    "step_ms": pct(eager_steps), "profile": eager_prof},
          "static_uncaptured": {"tokens_per_s": tok / static_s,
                                "wall_s": static_s,
                                "step_ms": pct(static_steps),
                                "profile": static_prof},
          "prefill_ms": prefill_s * 1e3, "prefill_cuda_mallocs": mallocs,
          "prefill_profile": prefill_prof,
          "peak_memory_gib": peak,
          "beam": {"num_beams": beams, "batch": 1, "new_tokens": beam_new,
                   "wall_s": beam_s},
          "speculative": {"k": k, "draft_layers": dcfg.num_layers,
                          "wall_s": spec_s, "tokens_per_s": tok / spec_s,
                          "rounds": rounds,
                          "tokens_per_round_slowest_row": (new - 1) / rounds,
                          "draft_agreement": agree},
          "tokens_equal": {"captured_vs_first_call":
                           bool(torch.equal(first, captured)),
                           "captured_vs_static": bool(torch.equal(captured,
                                                                  static)),
                           "captured_vs_eager_share": float(
                               (captured == eager).float().mean()),
                           "captured_vs_speculative_share": float(
                               (captured == spec).float().mean())},
          "launches": paths, "flash_families": families,
          "margins": margins, "margin_tol": MARGIN_TOL,
          "dense_bf16_vs_fp32_max_abs": dense_err,
          "captured_top1_under_fp32": top1})
    for name, c in paths.items():
        assert c["sdpa_plain"] == 0, f"{name}: sdpa took its plain path"
        assert c["flash_fwd"] > 0, f"{name}: no flash launch"
        # bf16: every decode / verify attention on the decode kernel, every
        # masked prefill on the sm90 forward, none on sm80
        fam = families[name]
        assert fam["flash_fwd_sm80"] == 0, (name, fam)
        assert fam["flash_fwd_decode"] > 0 and fam["flash_fwd_sm90"] > 0, \
            (name, fam)
    # prefill and each of the new - 1 steps: once a layer
    assert paths["captured"]["flash_fwd"] == new * cfg.num_layers, paths
    assert paths["eager"]["flash_fwd"] == new * cfg.num_layers, paths
    assert torch.equal(first, captured)
    bad = {n: m for n, m in margins.items() if m > MARGIN_TOL}
    assert not bad, f"tokens below the float32 maximum: {bad}"
    del model, first, captured, eager, static, spec, beam
    torch.cuda.empty_cache()
    return {n: flash_part(c) for n, c in paths.items()}


def phase_serve_llama():
    """Qwen2-7B (full width and depth, bf16, random weights from seed 0)
    served by LLMEngine with the serve phase's request mix and settings;
    the served tokens then against a dense float32 forward."""
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.serving import LLMEngine
    from paddle_tpu_torch.text import Qwen2Config, Qwen2ForCausalLM

    cfg = Qwen2Config.from_preset("qwen2-7b")
    model = Qwen2ForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0))
    eng = LLMEngine(model, num_blocks=2048, block_size=16, max_running=16,
                    prefill_chunk=512)
    rng = np.random.default_rng(0)
    plens = rng.integers(128, 1025, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in plens]
    eng.generate_batch([prompts[0][:64]], max_new_tokens=2)    # warm-up

    reg = metrics.registry()
    reg.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, max_new_tokens=32) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    steps = reg.counter("serving_decode_steps_total").value
    step_s = reg.histogram("serving_decode_step_seconds")
    ttft = reg.histogram("serving_ttft_seconds")
    tokens = sum(len(r.generated) for r in reqs)
    reasons = sorted({r.finish_reason for r in reqs})
    peak = torch.cuda.max_memory_allocated() / 2**30
    leaks = eng.close()
    del eng
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.float()
    worst = 0.0
    for p, r in zip(prompts, reqs):
        seq = torch.tensor([list(p) + r.generated], device="cuda")
        worst = max(worst, margin(lm_logits(model, seq, len(p)), seq,
                                  len(p)))
    emit({"phase": "serve_llama", "model": "qwen2-7b", "dtype": "bfloat16",
          "layers": cfg.num_layers, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "requests": len(reqs),
          "prompt_tokens": int(plens.sum()), "output_tokens": tokens,
          "wall_s": wall, "output_tokens_per_s": tokens / wall,
          "decode_steps": steps,
          "decode_step_p50_ms": step_s.percentile(50) * 1e3,
          "decode_step_p99_ms": step_s.percentile(99) * 1e3,
          "ttft_p50_s": ttft.percentile(50), "ttft_p99_s": ttft.percentile(99),
          "peak_memory_gib": peak, "launches": counts,
          "paged_kernel_launches": counts["paged_decode"],
          "finish_reasons": reasons, "leaks": leaks,
          "max_margin": worst, "margin_tol": MARGIN_TOL})
    assert reasons == ["length"], f"requests finished with {reasons}"
    assert leaks == ([], []), f"pool leaks {leaks}"
    assert counts["paged_decode"] == steps * cfg.num_layers and steps > 0, \
        f"{counts['paged_decode']} paged launches for {steps} decode steps"
    assert counts["sdpa_plain"] == 0, counts
    assert worst <= MARGIN_TOL, f"a served token sits {worst} below the max"
    del model
    torch.cuda.empty_cache()
    return counts


def phase_generate_e2e(batch=2, prompt=128, new=16):
    """Mistral width at 2 layers in float32 with a window of 64 (so that
    the band bites): each decode path on the card against the same on the
    CPU, token for token, and the captured step against the eager loop
    and the uncaptured step on the card."""
    from paddle_tpu_torch.text import LlamaConfig, LlamaForCausalLM, generate
    from paddle_tpu_torch.text import decode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.from_preset("mistral-7b", num_layers=2,
                                  sliding_window=64)
    dcfg = LlamaConfig.from_preset("mistral-7b", num_layers=1,
                                   sliding_window=64)
    card = LlamaForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(3))
    dcard = LlamaForCausalLM(
        dcfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(4))
    cpu = LlamaForCausalLM(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    dcpu = LlamaForCausalLM(dcfg, device="cpu")
    dcpu.load_state_dict(dcard.state_dict())
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (batch, prompt)))
    paths = {
        "jit_generate": lambda m, d, x: decode.jit_generate(
            m, x, max_new_tokens=new),
        "eager": lambda m, d, x: generate(m, x, max_new_tokens=new),
        "bucketed": lambda m, d, x: generate(m, x, max_new_tokens=new,
                                             shape_buckets="on"),
        "speculative": lambda m, d, x: generate(
            m, x, max_new_tokens=new, draft_model=d,
            num_speculative_tokens=4),
        "jit_beam_search": lambda m, d, x: decode.jit_beam_search(
            m, x, beam_size=3, max_new_tokens=16),
    }
    zero_counts()
    on_card = {n: fn(card, dcard, ids.cuda()).cpu() for n, fn in paths.items()}
    counts = read_counts()
    key = (prompt, new, False, 1.0, None, None, None, batch)
    captured = card._jit_decode_cache[key].graph is not None
    static = decode.jit_generate(card, ids.cuda(), max_new_tokens=new,
                                 _capture=False).cpu()
    t0 = time.perf_counter()
    on_cpu = {n: fn(cpu, dcpu, ids) for n, fn in paths.items()}
    cpu_s = time.perf_counter() - t0
    equal = {n: bool(torch.equal(on_card[n], on_cpu[n])) for n in paths}
    emit({"phase": "generate_e2e", "model": "mistral-7b width, 2 layers",
          "dtype": "float32", "sliding_window": 64, "batch": batch,
          "prompt_tokens": prompt, "new_tokens": new,
          "card_equals_cpu": equal, "step_captured": captured,
          "captured_equals_uncaptured": bool(torch.equal(
              on_card["jit_generate"], static)),
          "captured_equals_eager": bool(torch.equal(
              on_card["jit_generate"], on_card["eager"])),
          "cpu_seconds": cpu_s, "launches": counts})
    assert captured, "the decode step was not captured"
    assert all(equal.values()), f"card and CPU tokens differ: {equal}"
    assert torch.equal(on_card["jit_generate"], static)
    assert torch.equal(on_card["jit_generate"], on_card["eager"])
    assert counts["sdpa_plain"] == 0 and counts["flash_fwd"] > 0, counts
    # float32: the decode steps on the decode kernel, the prefills on the
    # fp32 forward, none on sm80
    assert counts["flash_fwd_decode"] > 0, counts
    assert counts["flash_fwd_fp32"] > 0, counts
    assert counts["flash_fwd"] == counts["flash_fwd_decode"] + \
        counts["flash_fwd_fp32"], counts
    del card, dcard, cpu, dcpu
    torch.cuda.empty_cache()
    return flash_part(counts)


# --------------------------------------------------- training families
def ce_loss(model, x, labels):
    """bench.py's loss for run_llama and run_resnet: cross entropy of the
    model's logits, mean."""
    from paddle_tpu_torch.nn import functional as PF
    return PF.cross_entropy(model(x), labels)


def phase_train_llama(steps=10, warmup=3, batch=4, seq=1024):
    """LLaMA trained as bench.py::run_llama trains it on one card (every
    fleet degree 1, so the harness is TrainStep): hidden 2048, 16 layers,
    16 heads, intermediate 5504, vocab 32000, seq 1024, batch 4,
    recompute, AMP O2 bf16 without master weights, Adafactor(1e-4).
    Recompute runs each block's forward twice a step (once in the
    forward, once again in the backward), so the flash forward launches
    2 x layers times a step and dK/dV and dQ once a layer."""
    from paddle_tpu_torch import amp, ops
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import Adafactor
    from paddle_tpu_torch.text import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=16,
                      num_heads=16, intermediate_size=5504,
                      max_position_embeddings=seq, use_recompute=True)
    model = LlamaForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    opt = Adafactor(learning_rate=1e-4, parameters=model.parameters())
    model, opt = amp.decorate(models=model, optimizers=opt,
                              dtype="bfloat16", master_weight=False)
    step = train_step(model, ce_loss, opt)
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                           device="cuda")
    release()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, times = [], []
    for _ in range(warmup + steps):
        t0 = time.perf_counter()
        losses.append(step(ids, labels).item())     # waits for the card
        times.append(time.perf_counter() - t0)
    counts = flash_counts()
    plain_calls = ops.sdpa.plain_calls
    timed = np.array(times[warmup:])
    n_params = sum(p.numel() for p in model.parameters())
    flops = train_flops(n_params, cfg, batch, seq)
    total = warmup + steps
    want = {"fwd": 2 * cfg.num_layers * total,
            "dkv": cfg.num_layers * total, "dq": cfg.num_layers * total}
    emit({"phase": "train_llama", "model": "llama (bench.py::run_llama)",
          "hidden": cfg.hidden_size, "layers": cfg.num_layers,
          "heads": cfg.num_heads, "intermediate": cfg.intermediate_size,
          "vocab": cfg.vocab_size, "seq": seq, "batch": batch,
          "recompute": True, "dtype": "bfloat16",
          "amp": "O2, master_weight=False", "optimizer": "Adafactor(1e-4)",
          "n_params": n_params, "warmup_steps": warmup, "timed_steps": steps,
          "tokens_per_s": steps * batch * seq / float(timed.sum()),
          "step_p50_ms": float(np.percentile(timed, 50)) * 1e3,
          "step_p99_ms": float(np.percentile(timed, 99)) * 1e3,
          "step_ms": [t * 1e3 for t in times],
          "flops_per_step": flops,
          "mfu": flops / float(timed.mean()) / BF16_FLOPS,
          "mfu_formula": "train_flops (6 N tokens + 6 layers seq hidden "
                         "tokens; recompute not counted) / mean step / "
                         "989e12",
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
          "losses": losses, "flash_launches": counts,
          "flash_launches_expected": want, "sdpa_plain_calls": plain_calls})
    assert all(np.isfinite(losses)), f"nonfinite loss in {losses}"
    assert abs(losses[0] - np.log(cfg.vocab_size)) < 1.0, losses[0]
    for k, n in want.items():
        assert counts[k] == counts[f"{k}_sm90"] == n, \
            f"flash {k}: {counts}, want {n} each on sm90"
    assert counts["fwd_decode"] == 0, counts
    assert plain_calls == 0, f"sdpa took its plain path {plain_calls} times"
    del step, opt, model
    release()
    return counts


def param_error(card, cpu, init, skip=None, only=None):
    """The card's parameters' distance from the CPU's, relative to how far
    the updates moved the CPU's from `init`; without the names ending in
    `skip`, or over those ending in `only` alone."""
    num = den = 0.0
    card_params = dict(card.named_parameters())
    for n, p in cpu.named_parameters():
        if (skip and n.endswith(skip)) or (only and not n.endswith(only)):
            continue
        num += float((card_params[n].detach().cpu() - p.detach())
                     .double().square().sum())
        den += float((p.detach() - init[n]).double().square().sum())
    return (num / den) ** 0.5


def phase_train_llama_e2e(steps=3, batch=2, seq=128):
    """The LLaMA training step on the card against the same on the CPU: 2
    layers, hidden 512, GQA 4 / 2, recompute, float32, AdamW, the same
    weights and batch.  The card runs the flash kernels (float32: fp32),
    the CPU the plain versions."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text import LlamaConfig, LlamaForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=32000, hidden_size=512, num_layers=2,
                      num_heads=4, num_kv_heads=2, intermediate_size=1376,
                      max_position_embeddings=seq, use_recompute=True)
    card = LlamaForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(2))
    cpu = LlamaForCausalLM(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    init = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))

    def train(model, dev):
        step = train_step(model, ce_loss,
                          AdamW(learning_rate=1e-4, weight_decay=0.01,
                                parameters=model.parameters()))
        return [step(ids.to(dev), labels.to(dev)).item()
                for _ in range(steps)]

    zero_counts()
    card_losses = train(card, "cuda")
    counts = flash_counts()
    L = cfg.num_layers
    assert counts == {"fwd": 2 * L * steps, "dkv": L * steps,
                      "dq": L * steps, "fwd_sm90": 0, "dkv_sm90": 0,
                      "dq_sm90": 0, "fwd_decode": 0,
                      "fwd_fp32": 2 * L * steps, "dkv_fp32": L * steps,
                      "dq_fp32": L * steps}, counts
    assert ops.sdpa.plain_calls == 0
    t0 = time.perf_counter()
    cpu_losses = train(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                       cpu_losses))
    perr = param_error(card, cpu, init)
    emit({"phase": "train_llama_e2e",
          "model": "llama, hidden 512, 2 layers, GQA 4/2, recompute",
          "dtype": "float32", "optimizer": "AdamW(1e-4, wd 0.01)",
          "batch": batch, "seq": seq, "steps": steps,
          "card_losses": card_losses, "cpu_losses": cpu_losses,
          "loss_max_rel_err": loss_err, "loss_tol": 1e-5,
          "param_rel_err": perr, "param_tol": 1e-3,
          "cpu_seconds": cpu_s, "flash_launches": counts})
    assert loss_err <= 1e-5, f"card and CPU losses differ by {loss_err}"
    assert perr <= 1e-3, f"card and CPU parameters differ: {perr}"
    del card, cpu
    release()
    return counts


LLAMA_LORA_TARGETS = [".*q_proj", ".*k_proj", ".*v_proj", ".*o_proj"]


def lora_merge_check(lora, ids, new):
    """Greedy jit_generate (captured) -> merge() -> jit_generate again, and
    the same step uncaptured after the merge; unmerges at the end.
    Returns (before, after, uncaptured after, graphs captured)."""
    from paddle_tpu_torch.text import decode
    lora.__dict__.pop("_jit_decode_cache", None)
    before = decode.jit_generate(lora, ids, max_new_tokens=new)
    built = next(iter(lora._jit_decode_cache.values()))
    lora.merge()
    after = decode.jit_generate(lora, ids, max_new_tokens=new)
    rebuilt = next(iter(lora._jit_decode_cache.values()))
    plain = decode.jit_generate(lora, ids, max_new_tokens=new,
                                _capture=False)
    lora.unmerge()
    lora.__dict__.pop("_jit_decode_cache")
    return (before, after, plain,
            built.graph is not None and rebuilt.graph is not None
            and rebuilt is not built)


def phase_lora(warmup=2, steps=5, batch=4, seq=1024, prompt=128, new=32,
               layers=None):
    """LoRA fine-tuning of LLaMA-7B (full width and depth, bf16, random
    base weights from seed 0): r 16, alpha 32 on q/k/v/o, AdamW(1e-4) on
    the adapters (AMP O2, float32 master copies of the adapters only),
    seq 1024, batch 4, recompute.  The base must stay bit-identical and
    the adapters must move.  Then eval: captured jit_generate, merge(),
    captured jit_generate again.  In bfloat16 a merged weight is rounded
    once where the unmerged layer adds the adapter's product, which flips
    near-tied greedy tokens of random weights (as the generate phase's
    captured-vs-eager share shows), so bf16 reports the share of equal
    tokens and holds the captured program after the merge to the
    uncaptured step; the model is then cast to float32 (TF32 off) and
    the tokens before and after the merge must be identical."""
    from paddle_tpu_torch import amp, ops
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.text.peft import LoRAConfig, get_peft_model

    cfg = LlamaConfig.from_preset("llama-7b", max_position_embeddings=seq,
                                  use_recompute=True,
                                  **({"num_layers": layers} if layers
                                     else {}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             generator=gen)
    lora = get_peft_model(model, LoRAConfig(
        r=16, lora_alpha=32, target_modules=LLAMA_LORA_TARGETS),
        generator=gen)
    opt = AdamW(learning_rate=1e-4, parameters=lora.trainable_parameters())
    lora, opt = amp.decorate(models=lora, optimizers=opt, dtype="bfloat16")
    step = train_step(lora, ce_loss, opt)
    base = {n: p.detach().cpu() for n, p in lora.named_parameters()
            if not p.requires_grad}       # on the host: peak memory is ours
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                           device="cuda")
    release()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, times = [], []
    for _ in range(warmup + steps):
        t0 = time.perf_counter()
        losses.append(step(ids, labels).item())
        times.append(time.perf_counter() - t0)
    train_counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    timed = np.array(times[warmup:])
    adapters = lora.adapter_state_dict()
    names = {id(p): n for n, p in lora.model.named_parameters()}
    slotted = {names[id(p)]: slots for p, slots in
               zip(opt._parameters, opt._state) if slots}
    state_bytes = sum(t.numel() * t.element_size()
                      for slots in opt._state for t in slots.values())
    n_adapter = sum(p.numel() for p in adapters.values())
    frozen_equal = all(torch.equal(p.cpu(), base[n])
                       for n, p in lora.named_parameters()
                       if not p.requires_grad)
    moved = sum(bool(torch.count_nonzero(p)) for n, p in adapters.items()
                if "lora_B" in n)
    del step, opt, base
    release()

    lora.eval()
    gids = ids[:, :prompt]
    zero_counts()
    before, after, plain, captured = lora_merge_check(lora, gids, new)
    gen_counts = read_counts()
    bf16 = {"captured_rebuilt_after_merge": captured,
            "after_equals_uncaptured": bool(torch.equal(after, plain)),
            "before_vs_after_share": float((before == after).float().mean())}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lora.float()
    before, after, plain, captured = lora_merge_check(lora, gids, new)
    f32 = {"captured_rebuilt_after_merge": captured,
           "after_equals_uncaptured": bool(torch.equal(after, plain)),
           "before_equals_after": bool(torch.equal(before, after))}
    tokens = batch * seq
    emit({"phase": "lora", "model": "llama-7b", "dtype": "bfloat16",
          "layers": cfg.num_layers, "r": 16, "alpha": 32,
          "targets": LLAMA_LORA_TARGETS, "seq": seq, "batch": batch,
          "recompute": True, "optimizer": "AdamW(1e-4), master copies of "
          "the adapters", "warmup_steps": warmup, "timed_steps": steps,
          "tokens_per_s": steps * tokens / float(timed.sum()),
          "step_p50_ms": float(np.percentile(timed, 50)) * 1e3,
          "step_ms": [t * 1e3 for t in times],
          "peak_memory_gib": peak, "losses": losses,
          "adapter_params": n_adapter,
          "optimizer_state_bytes": state_bytes,
          "optimizer_state_bytes_per_adapter_param": state_bytes / n_adapter,
          "slotted_params": len(slotted), "adapter_tensors": len(adapters),
          "base_bit_identical": frozen_equal, "lora_B_moved": moved,
          "train_launches": train_counts, "generate_launches": gen_counts,
          "generate": {"prompt_tokens": prompt, "new_tokens": new,
                       "batch": batch, "bfloat16": bf16, "float32": f32}})
    assert all(np.isfinite(losses)), losses
    assert set(slotted) == set(adapters), "slots beyond the adapters"
    assert state_bytes == 3 * 4 * n_adapter, state_bytes   # m1, m2, master
    assert frozen_equal, "a frozen base weight changed"
    assert moved == len(lora.replaced), f"{moved} lora_B tensors moved"
    assert train_counts["sdpa_plain"] == 0, train_counts
    assert train_counts["flash_fwd_sm90"] == 2 * cfg.num_layers * (
        warmup + steps), train_counts
    assert bf16["captured_rebuilt_after_merge"] and \
        bf16["after_equals_uncaptured"], bf16
    assert all(f32.values()), f32
    del lora, model
    release()
    return {"lora_train": flash_part(train_counts),
            "lora_generate": flash_part(gen_counts)}


def weight_bytes(model):
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def captured_decode(model, ids, new):
    """Captured greedy jit_generate twice (the first call builds and
    captures), then the step alone, then a profile of 8 steps: (tokens,
    record, launches of the second call).  The peak memory is read after
    the two calls, as the generate phase reads it."""
    first, build_s = sync_time(lambda: model.generate(ids,
                                                      max_new_tokens=new))
    zero_counts()
    out, wall_s = sync_time(lambda: model.generate(ids, max_new_tokens=new))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30   # as `generate` reads
    prog = next(iter(model._jit_decode_cache.values()))
    assert prog.graph is not None, "the decode step was not captured"
    assert torch.equal(first, out)
    _, prefill_s = sync_time(lambda: prog.prefill(ids))
    steps = step_ms(prog.step, new - 1)
    prog.prefill(ids)
    prof = busy(prog.step, min(8, new - 1), pct(steps)["p50"])
    b = ids.shape[0]
    return out, {"tokens_per_s": b * new / wall_s, "wall_s": wall_s,
                 "first_call_s": build_s, "prefill_ms": prefill_s * 1e3,
                 "decode_tokens_per_s": b * 1e3 / pct(steps)["p50"],
                 "step_ms": pct(steps), "profile": prof,
                 "peak_memory_gib": peak,
                 "weight_bytes": weight_bytes(model)}, counts


def phase_weight_only(batch=4, prompt=512, new=64, layers=None):
    """Mistral-7B (full width and depth, random weights from seed 0, the
    generate phase's shape) in bf16, then built again from the same seed
    and converted to weight-only int8, then int4 (lm_head kept bf16):
    captured generate of each, with tokens/s, step p50/p99, a profile,
    weight bytes and peak memory (one model alive at a time); each
    quantized model's tokens against a float32 forward over its own
    dequantized weights (`weight_only_linear` in float32, TF32 off)."""
    from paddle_tpu_torch.nn.quant import convert_to_weight_only
    from paddle_tpu_torch.text import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.from_preset(
        "mistral-7b", **({"num_layers": layers} if layers else {}))
    g = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                        device="cuda")
    rec = {"phase": "weight_only", "model": "mistral-7b",
           "layers": cfg.num_layers, "batch": batch,
           "prompt_tokens": prompt, "new_tokens": new,
           "skip": "lm_head", "margin_tol": MARGIN_TOL}
    paths = {}
    for algo in (None, "weight_only_int8", "weight_only_int4"):
        name = algo[len("weight_only_"):] if algo else "bfloat16"
        model = LlamaForCausalLM(
            cfg, device="cuda", dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(0))
        if algo:
            convert_to_weight_only(model, algo=algo,
                                   skip=lambda n, layer: n == "lm_head")
        release()
        torch.cuda.reset_peak_memory_stats()
        seqs, r, counts = captured_decode(model, ids, new)
        r["launches"] = counts
        paths[f"weight_only/{name}"] = flash_part(counts)
        model._jit_decode_cache.clear()
        if algo:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            model.float()
            r["margin"] = margin(lm_logits(model, seqs, prompt), seqs,
                                 prompt)
            r["step_p50_vs_bf16"] = (r["step_ms"]["p50"]
                                     / rec["bfloat16"]["step_ms"]["p50"])
            r["weight_bytes_vs_bf16"] = (r["weight_bytes"]
                                         / rec["bfloat16"]["weight_bytes"])
        rec[name] = r
        del model, seqs
        release()
    emit(rec)
    for name in ("bfloat16", "int8", "int4"):
        c = rec[name]["launches"]
        assert c["sdpa_plain"] == 0, (name, c)
        assert c["flash_fwd"] == new * cfg.num_layers, (name, c)
        assert c["flash_fwd"] == c["flash_fwd_decode"] + \
            c["flash_fwd_sm90"], (name, c)
        if name != "bfloat16":
            assert rec[name]["margin"] <= MARGIN_TOL, \
                f"{name}: a token sits {rec[name]['margin']} below the max"
    return paths


# the depth lora, weight_only and generate run at in the whole script:
# 4 of the 7B presets' 32 layers (8 until the compile_cache phase came),
# and router_drill 6 of GPT-3 1.3B's 24, each at full width (the time
# they give back pays for the MT and compile_cache phases and keeps the
# script inside its limit on a slow host; `tools/torch_mt_probe.py
# --cuts` times each at two depths)
LORA_LAYERS = 4
WEIGHT_ONLY_LAYERS = 4
GENERATE_LAYERS = 4
ROUTER_DRILL_LAYERS = 4


# ResNet-50 model flops a training image: 4.09 GFLOP a forward at 224 x
# 224 (multiply-adds counted as 2), the backward twice that
RESNET50_FWD_FLOPS = 4.09e9


def phase_resnet(batch=256, steps=10, warmup=3):
    """ResNet-50 trained as bench.py::run_resnet trains it: batch 256 at
    224 x 224, s2d_stem, AMP O2 bf16 without master weights,
    Momentum(0.1, 0.9), cross entropy, TrainStep; NCHW, then NHWC
    (channels-last).  cuDNN's autotuner is on (the warm-up steps pay for
    it), as XLA autotunes its convolutions."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    rec = {"phase": "resnet", "model": "resnet50", "batch": batch,
           "image": 224, "s2d_stem": True, "dtype": "bfloat16",
           "amp": "O2, master_weight=False",
           "optimizer": "Momentum(0.1, 0.9)", "warmup_steps": warmup,
           "timed_steps": steps,
           "mfu_formula": "3 x 4.09e9 flop an image x images/s / 989e12"}
    for fmt in ("NCHW", "NHWC"):
        model = resnet50(num_classes=1000, s2d_stem=True, data_format=fmt,
                         device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=model.parameters())
        model, opt = amp.decorate(models=model, optimizers=opt,
                                  dtype="bfloat16", master_weight=False)
        step = train_step(model, ce_loss, opt)
        g = torch.Generator(device="cuda").manual_seed(1)
        shape = (batch, 3, 224, 224) if fmt == "NCHW" else (batch, 224, 224,
                                                            3)
        x = torch.randn(shape, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        y = torch.randint(0, 1000, (batch,), generator=g, device="cuda")
        release()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(warmup + steps):
            t0 = time.perf_counter()
            losses.append(step(x, y).item())
            times.append(time.perf_counter() - t0)
        timed = np.array(times[warmup:])
        ips = steps * batch / float(timed.sum())
        rec[fmt] = {"images_per_s": ips,
                    "step_p50_ms": float(np.percentile(timed, 50)) * 1e3,
                    "step_p99_ms": float(np.percentile(timed, 99)) * 1e3,
                    "step_ms": [t * 1e3 for t in times],
                    "mfu": 3 * RESNET50_FWD_FLOPS * ips / BF16_FLOPS,
                    "peak_memory_gib":
                        torch.cuda.max_memory_allocated() / 2**30,
                    "losses": losses,
                    "running_mean_dtype": str(model.bn1._mean.dtype)}
        assert all(np.isfinite(losses)), (fmt, losses)
        assert abs(losses[0] - np.log(1000)) < 2.0, (fmt, losses[0])
        assert model.bn1._mean.dtype == torch.float32
        del step, opt, model, x
        release()
    torch.backends.cudnn.benchmark = bench
    rec["nhwc_speedup"] = (rec["NHWC"]["images_per_s"]
                           / rec["NCHW"]["images_per_s"])
    PHASE_NOTES["resnet_nhwc_images_per_s"] = rec["NHWC"]["images_per_s"]
    emit(rec)


def phase_resnet_e2e(steps=3, batch=8, image=64):
    """resnet18 (10 classes, s2d_stem) in float32, NCHW and NHWC, on the
    card (cuDNN, TF32 off) and on the CPU, both held to a float64 run of
    the same weights and batch on the CPU: an eval forward (logits), then
    3 steps with batch norm in train mode and Momentum(0.01, 0.9) (the
    losses, the parameters' distance relative to how far the steps moved
    them, every running statistic).  A float32 gradient of this network
    is ill-conditioned where a ReLU or max-pool input sits within
    rounding of its kink: the CPU's own float32 run strays from float64
    by up to several percent in some tensors at some seeds.  So the
    card's error must be within 4x the CPU's float32 error, or under the
    stated floor."""
    import copy

    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(5)
    x = rng.standard_normal((batch, 3, image, image)).astype(np.float32)
    y = torch.from_numpy(rng.integers(0, 10, batch))
    floors = {"logits": 1e-4, "losses": 1e-4, "params": 1e-3,
              "running_stats": 1e-3}
    rec = {"phase": "resnet_e2e", "model": "resnet18, 10 classes",
           "dtype": "float32", "reference": "CPU float64",
           "optimizer": "Momentum(0.01, 0.9)", "batch": batch,
           "image": image, "steps": steps, "floors": floors,
           "rule": "card error <= max(floor, 4 x CPU float32 error)"}
    for fmt in ("NCHW", "NHWC"):
        xf = torch.from_numpy(x if fmt == "NCHW"
                              else x.transpose(0, 2, 3, 1).copy())
        card = resnet18(num_classes=10, s2d_stem=True, data_format=fmt,
                        device="cuda",
                        generator=torch.Generator("cuda").manual_seed(6))
        cpu = resnet18(num_classes=10, s2d_stem=True, data_format=fmt,
                       device="cpu")
        cpu.load_state_dict(card.state_dict())
        ref = copy.deepcopy(cpu).double()
        init = {n: p.detach().double().clone()
                for n, p in ref.named_parameters()}
        runs = {"card": (card, "cuda", torch.float32),
                "cpu": (cpu, "cpu", torch.float32),
                "ref": (ref, "cpu", torch.float64)}
        out = {}
        for name, (model, dev, dt) in runs.items():
            with torch.no_grad():
                logits = model.eval()(xf.to(dev, dt)).double().cpu()
            model.train()
            step = train_step(model, ce_loss,
                              Momentum(learning_rate=0.01, momentum=0.9,
                                       parameters=model.parameters()))
            losses = [step(xf.to(dev, dt), y.to(dev)).item()
                      for _ in range(steps)]
            out[name] = (logits, losses,
                         {n: p.detach().double().cpu()
                          for n, p in model.named_parameters()},
                         {n: b.double().cpu()
                          for n, b in model.named_buffers()})
        rl, rloss, rp, rb = out["ref"]
        moved = sum(float((rp[n] - init[n]).square().sum()) for n in rp)
        errs = {}
        for name in ("card", "cpu"):
            lg, ls, ps, bs = out[name]
            errs[name] = {
                "logits": float((lg - rl).abs().max() / rl.abs().max()),
                "losses": max(abs(a - b) / abs(b) for a, b in zip(ls,
                                                                  rloss)),
                "params": (sum(float((ps[n] - rp[n]).square().sum())
                               for n in rp) / moved) ** 0.5,
                "running_stats": max(float((bs[n] - b).abs().max()
                                           / b.abs().max().clamp(min=1e-6))
                                     for n, b in rb.items())}
        rec[fmt] = {"card_losses": out["card"][1],
                    "cpu_losses": out["cpu"][1], "ref_losses": rloss,
                    "card_vs_float64": errs["card"],
                    "cpu_float32_vs_float64": errs["cpu"]}
        del card, cpu, ref, runs, out
    emit(rec)
    release()
    for fmt in ("NCHW", "NHWC"):
        card, cpu = (rec[fmt]["card_vs_float64"],
                     rec[fmt]["cpu_float32_vs_float64"])
        for k, floor in floors.items():
            assert card[k] <= max(floor, 4 * cpu[k]), (fmt, k, card, cpu)


# ------------------------------------------------------- BERT and ERNIE
# ERNIE's exported program against the eager model on the same card: the
# same operators in the same order on the same inputs (float32 and
# bfloat16 logits are compared in float32)
ERNIE_EAGER_TOL = 1e-5
# bf16 logits against float32 logits of the same random weights: logits
# have a magnitude of about 1 (tanh-pooled, Xavier classifier), and 6
# layers of bf16 rounding (2**-8 relative each) move them by hundredths
ERNIE_BF16_TOL = 0.1


def linear_params(model):
    """Parameters of the model's Linear layers (the matrix products a
    token pays for; BERT's embeddings are looked up, not multiplied)."""
    return sum(m.weight.numel() + m.bias.numel() for m in model.modules()
               if isinstance(m, torch.nn.Linear))


def encoder_train_flops(model, cfg, batch, seq):
    """Model flops of one encoder training step: 6 * (Linear parameters)
    * tokens, plus non-causal attention, 12 * layers * seq * hidden per
    token (QK^T and PV, 2 flops a product, forward and twice backward)."""
    tokens = batch * seq
    return (6 * linear_params(model) * tokens
            + 12 * cfg.num_hidden_layers * seq * cfg.hidden_size * tokens)


def bert_batch(cfg, batch, seq, seed):
    """ids, segment ids (zeros, as run_bert's), labels and a padding mask
    of rows 64 to 128 tokens long, on the card from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                        device="cuda")
    seg = torch.zeros_like(ids)
    labels = torch.randint(0, 2, (batch,), generator=g, device="cuda")
    lens = torch.randint(seq // 2, seq + 1, (batch,), generator=g,
                         device="cuda")
    mask = (torch.arange(seq, device="cuda")[None, :]
            < lens[:, None]).long()
    return ids, seg, labels, mask


def masked_loss(model, ids, seg, mask, labels):
    """run_bert's loss on padded rows."""
    from paddle_tpu_torch.nn import functional as PF
    return PF.cross_entropy(model(ids, seg, attention_mask=mask), labels,
                            reduction="mean")


def plain_first_loss(loss_fn, model, *batch):
    """loss_fn(model, *batch) with no gradient, attention on sdpa's plain
    path, and the dropout masks the next step will draw (the CUDA
    generator's state is put back): the reference a training phase holds
    its first step's loss against.  A BERT classifier's loss at Xavier
    initialisation sits well off ln 2 (0.9 to 1.2 on the card) and moves
    with the dropout masks, so a fixed band around chance cannot hold."""
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = torch.cuda.get_rng_state()
    supports = fa.supports
    fa.supports = lambda *a, **k: False
    try:
        with torch.no_grad():
            return loss_fn(model, *batch).float().item()
    finally:
        fa.supports = supports
        torch.cuda.set_rng_state(rng)


def phase_bert(steps=20, warmup=3, batch=32, seq=128, padded_steps=8,
               fp16_iters=40):
    """BERT-base fine-tuned as bench.py::run_bert runs it: BertConfig()
    (hidden 768, 12 layers, 12 heads, intermediate 3072, vocab 30522,
    dropout 0.1), BertForSequenceClassification(num_classes=2),
    AdamW(2e-5), AMP O2 bf16 without master weights, TrainStep, cross
    entropy, batch 32, seq 128: 3 warm-up and 20 timed steps, each flash
    kernel 12 times a step on sm90, no plain sdpa, the first loss within
    BF16_FIRST_LOSS_TOL of `plain_first_loss` on the float32 weights; then
    a profile.  Then
    the same model on padded rows (64 to 128 tokens) under
    LinearWarmup(PolynomialDecay) and two parameter groups (biases and
    norms without decay): the sm90 forward, dK/dV and dQ take the mask,
    none runs on sm80.  Then a fresh model decorated to float16 (float32
    masters) with a GradScaler whose first scale overflows: the first
    steps are skipped without moving a parameter, the scale halves each
    time, until steps go through.  Returns {path: flash launch counts}."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as lr_sched
    from paddle_tpu_torch.text import (BertConfig,
                                       BertForSequenceClassification,
                                       bert_loss_fn)

    cfg = BertConfig(hidden_dropout_prob=0.1)
    model = BertForSequenceClassification(
        cfg, num_classes=2, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    ids, seg, labels, mask = bert_batch(cfg, batch, seq, 1)
    ref_loss = plain_first_loss(bert_loss_fn, model, ids, seg, labels)
    opt = AdamW(learning_rate=2e-5, parameters=model.parameters())
    model, opt = amp.decorate(models=model, optimizers=opt,
                              dtype="bfloat16", master_weight=False)
    step = train_step(model, bert_loss_fn, opt)
    L = cfg.num_hidden_layers

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, times = [], []
    for _ in range(warmup + steps):
        t0 = time.perf_counter()
        losses.append(step(ids, seg, labels).item())   # waits for the card
        times.append(time.perf_counter() - t0)
    counts = read_counts()
    timed = np.array(times[warmup:])
    p50 = float(np.percentile(timed, 50))
    flops = encoder_train_flops(model, cfg, batch, seq)
    rec = {"phase": "bert", "model": "bert-base (BertConfig())",
           "layers": L, "batch": batch, "seq": seq, "dtype": "bfloat16",
           "amp": "O2, master_weight=False", "optimizer": "AdamW(2e-5)",
           "n_params": sum(p.numel() for p in model.parameters()),
           "linear_params": linear_params(model),
           "warmup_steps": warmup, "timed_steps": steps,
           "sequences_per_s": steps * batch / float(timed.sum()),
           "tokens_per_s": steps * batch * seq / float(timed.sum()),
           "step_p50_ms": p50 * 1e3,
           "step_p99_ms": float(np.percentile(timed, 99)) * 1e3,
           "step_ms": [t * 1e3 for t in times], "flops_per_step": flops,
           "mfu": flops / float(timed.mean()) / BF16_FLOPS,
           "mfu_peak_flops": BF16_FLOPS,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "losses": losses, "launches": counts,
           "first_loss_float32_plain": ref_loss,
           "first_loss_err": abs(losses[0] - ref_loss),
           "first_loss_tol": BF16_FIRST_LOSS_TOL}
    PHASE_NOTES["bert_step_p50_ms"] = p50 * 1e3
    n = L * (warmup + steps)
    fl = flash_part(counts)
    assert all(np.isfinite(losses)), losses
    assert rec["first_loss_err"] <= BF16_FIRST_LOSS_TOL, rec
    assert (fl["fwd"], fl["dkv"], fl["dq"]) == (n, n, n), fl
    assert (fl["fwd_sm90"], fl["dkv_sm90"], fl["dq_sm90"]) == (n, n, n), fl
    assert counts["sdpa_plain"] == 0, counts
    rec["profile"] = busy(lambda: step(ids, seg, labels), 3, p50 * 1e3)
    paths = {"bert": fl}

    # padded rows, a schedule the caller steps, two parameter groups
    named = list(model.named_parameters())
    decayed = [p for name, p in named
               if name.endswith("weight") and "norm" not in name]
    rest = [p for name, p in named
            if not (name.endswith("weight") and "norm" not in name)]
    sched = lr_sched.LinearWarmup(
        lr_sched.PolynomialDecay(2e-5, decay_steps=padded_steps,
                                 end_lr=2e-6),
        warmup_steps=2, start_lr=0.0, end_lr=2e-5)
    opt2 = AdamW(learning_rate=sched, weight_decay=0.01,
                 parameters=[{"params": decayed},
                             {"params": rest, "weight_decay": 0.0}])
    model, opt2 = amp.decorate(models=model, optimizers=opt2,
                               dtype="bfloat16", master_weight=False)
    step2 = train_step(model, masked_loss, opt2)
    zero_counts()
    rates, losses2, times2 = [], [], []
    for _ in range(2 + padded_steps):
        rates.append(opt2.get_lr())
        t0 = time.perf_counter()
        losses2.append(step2(ids, seg, mask, labels).item())
        times2.append(time.perf_counter() - t0)
        sched.step()
    counts2 = read_counts()
    fl2 = flash_part(counts2)
    n2 = L * (2 + padded_steps)
    rec["padded"] = {
        "rows": mask.sum(1).tolist(),
        "schedule": "LinearWarmup(PolynomialDecay(2e-5, 8, 2e-6), 2, 0, "
                    "2e-5)",
        "groups": {"decayed": len(decayed),
                   "biases_and_norms_no_decay": len(rest)},
        "rates": rates, "losses": losses2,
        "step_ms": [t * 1e3 for t in times2],
        "step_p50_ms": float(np.percentile(times2[2:], 50)) * 1e3,
        "unmasked_step_p50_ms": p50 * 1e3, "launches": counts2}
    assert all(np.isfinite(losses2)), losses2
    assert rates[0] == 0.0 and rates[2] == 2e-5, rates
    assert (fl2["fwd"], fl2["fwd_sm90"], fl2["dkv"], fl2["dq"]) == \
        (n2, n2, n2, n2), fl2
    assert (fl2["dkv_sm90"], fl2["dq_sm90"]) == (n2, n2), fl2
    assert counts2["sdpa_plain"] == 0, counts2
    # the masked step's device time and its flash share, beside the
    # unmasked step's profile above
    rec["padded"]["profile"] = busy(lambda: step2(ids, seg, mask, labels), 3,
                                    rec["padded"]["step_p50_ms"])
    paths["bert_padded"] = fl2
    del step, step2, opt, opt2, model
    release()

    # float16 under a loss scale that overflows at first
    model16 = BertForSequenceClassification(
        cfg, num_classes=2, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    opt16 = AdamW(learning_rate=2e-5, parameters=model16.parameters())
    model16, opt16 = amp.decorate(models=model16, optimizers=opt16,
                                  dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 32)
    watch = [model16.classifier.weight,
             model16.bert.encoder.layers[0].self_attn.q_proj.weight]
    zero_counts()
    series, taken = [], 0
    for _ in range(fp16_iters):
        before = [w.detach().clone() for w in watch]
        scale = scaler.get_loss_scaling()
        loss = bert_loss_fn(model16, ids, seg, labels)
        scaler.scale(loss).backward()
        count = opt16._step_count
        scaler.step(opt16)
        scaler.update()
        opt16.clear_grad()
        stepped = opt16._step_count == count + 1
        moved = any(not torch.equal(w, b) for w, b in zip(watch, before))
        series.append({"scale": scale, "loss": loss.item(),
                       "stepped": stepped, "moved": moved})
        assert moved == stepped, series
        taken += stepped
        if taken == 3:
            break
    counts16 = read_counts()
    skipped = [r for r in series if not r["stepped"]]
    rec["fp16_grad_scaler"] = {
        "init_loss_scaling": 2.0 ** 32, "iterations": len(series),
        "skipped": len(skipped),
        "first_step_scale": next((r["scale"] for r in series
                                  if r["stepped"]), None),
        "series": series, "optimizer_steps": opt16._step_count,
        "launches": counts16}
    emit(rec)
    assert skipped and not series[0]["stepped"], series
    assert all(b["scale"] == a["scale"] / 2
               for a, b in zip(skipped, skipped[1:])), series
    assert taken == 3 and opt16._step_count == 3, series
    assert all(np.isfinite(r["loss"]) for r in series), series
    assert counts16["sdpa_plain"] == 0, counts16
    paths["bert_fp16"] = flash_part(counts16)
    del model16, opt16
    release()
    return paths


def phase_bert_fp32_train(steps=10, warmup=3, batch=32, seq=128,
                          turn_steps=5):
    """BERT-base fine-tuned in float32, as examples/finetune_bert_cls.py
    runs it at full size: BertConfig() (hidden 768, 12 layers, 12 heads,
    dropout 0.1), 2 classes, AdamW(2e-5), no AMP, TF32 off, TrainStep,
    batch 32, seq 128 on padded rows (64 to 128 tokens under the
    key-padding mask).  3 warm-up and 10 timed steps: sequences/s, step
    p50/p99, MFU against the float32 peak, peak memory, losses, a profile
    (busy share, flash device time a step); each flash kernel 12 times a
    step, all on the fp32 family, none on sm80 or sm90, no plain sdpa; the
    first loss within 1e-5 of `plain_first_loss`.
    Then the same step from the same parameters, optimizer state
    (`set_state_dict`) and dropout seed, with the backward on fp32 and on
    sm80 in turns (fp32, sm80, sm80, fp32; sm80 through a route without
    "fp32" for the backward, swapped in here and restored in a
    `finally`): step p50 and the flash backward's device time a step on
    each, and the losses of the two families within 1e-5.  Returns the
    timed run's flash launch counts, its step p50 (ms) and busy share."""
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text import (BertConfig,
                                       BertForSequenceClassification)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = BertConfig()
    model = BertForSequenceClassification(
        cfg, num_classes=2, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    opt = AdamW(learning_rate=2e-5, parameters=model.parameters())
    ids, seg, labels, mask = bert_batch(cfg, batch, seq, 2)
    ref_loss = plain_first_loss(masked_loss, model, ids, seg, mask, labels)
    step = train_step(model, masked_loss, opt)
    L = cfg.num_hidden_layers

    def run(n):
        losses, times = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            losses.append(step(ids, seg, mask, labels).item())
            times.append(time.perf_counter() - t0)
        return losses, times

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, times = run(warmup + steps)
    counts = read_counts()
    fl = flash_part(counts)
    timed = np.array(times[warmup:])
    p50 = float(np.percentile(timed, 50))
    flops = encoder_train_flops(model, cfg, batch, seq)
    n = L * (warmup + steps)
    rec = {"phase": "bert_fp32_train", "model": "bert-base (BertConfig())",
           "layers": L, "batch": batch, "seq": seq, "dtype": "float32",
           "amp": None, "tf32": False, "optimizer": "AdamW(2e-5)",
           "rows": mask.sum(1).tolist(),
           "n_params": sum(p.numel() for p in model.parameters()),
           "warmup_steps": warmup, "timed_steps": steps,
           "sequences_per_s": steps * batch / float(timed.sum()),
           "step_p50_ms": p50 * 1e3,
           "step_p99_ms": float(np.percentile(timed, 99)) * 1e3,
           "step_ms": [t * 1e3 for t in times], "flops_per_step": flops,
           "mfu": flops / float(timed.mean()) / FP32_FLOPS,
           "mfu_peak_flops": FP32_FLOPS,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "losses": losses, "launches": counts,
           "first_loss_plain": ref_loss,
           "first_loss_err": abs(losses[0] - ref_loss),
           "first_loss_tol": 1e-5}
    assert all(np.isfinite(losses)), losses
    assert rec["first_loss_err"] <= 1e-5, rec
    assert (fl["fwd"], fl["dkv"], fl["dq"]) == (n, n, n), fl
    assert (fl["fwd_fp32"], fl["dkv_fp32"], fl["dq_fp32"]) == (n, n, n), fl
    assert (fl["fwd_sm90"], fl["dkv_sm90"], fl["dq_sm90"]) == (0, 0, 0), fl
    assert counts["sdpa_plain"] == 0, counts
    rec["profile"] = busy(lambda: step(ids, seg, mask, labels), 3, p50 * 1e3)

    # the backward on fp32 and on sm80 in turns, from one starting point
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in opt.state_dict().items()}
    families = fa._families

    def without_fp32_bwd(q, k, v, m4, dtype, fwd):
        fams = families(q, k, v, m4, dtype, fwd)
        return fams if fwd else tuple(f for f in fams if f != "fp32")

    turns = []
    try:
        for fam in ("fp32", "sm80", "sm80", "fp32"):
            fa._families = families if fam == "fp32" else without_fp32_bwd
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(params[k])
            opt.set_state_dict(state)
            torch.cuda.manual_seed(1234)
            zero_counts()
            ls, ts = run(turn_steps)
            c = flash_part(read_counts())
            m = L * turn_steps
            assert (c["dkv"], c["dq"], c["fwd_fp32"]) == (m, m, m), c
            assert (c["dkv_fp32"], c["dq_fp32"]) == (
                (m, m) if fam == "fp32" else (0, 0)), (fam, c)
            t_p50 = float(np.percentile(ts[1:], 50)) * 1e3
            prof = busy(lambda: step(ids, seg, mask, labels), 2, t_p50)
            turns.append({"family": fam, "losses": ls,
                          "step_ms": [t * 1e3 for t in ts],
                          "step_p50_ms": t_p50,
                          "device_busy_ms": prof["device_busy_ms_per_step"],
                          "flash_bwd_device_ms": prof["flash_bwd_ms_per_step"],
                          "flash_device_ms": prof["flash_ms_per_step"],
                          "launches": c})
    finally:
        fa._families = families
    mean = {f: {k: float(np.mean([t[k] for t in turns if t["family"] == f]))
                for k in ("step_p50_ms", "device_busy_ms",
                          "flash_bwd_device_ms")}
            for f in ("fp32", "sm80")}
    ref = turns[0]["losses"]
    loss_err = max(abs(a - b) / abs(b) for t in turns[1:]
                   for a, b in zip(t["losses"], ref))
    rec["bwd_turns"] = {
        "turns": turns, "mean": mean, "steps_a_turn": turn_steps,
        "step_p50_gain_ms": mean["sm80"]["step_p50_ms"]
        - mean["fp32"]["step_p50_ms"],
        "busy_gain_ms": mean["sm80"]["device_busy_ms"]
        - mean["fp32"]["device_busy_ms"],
        "flash_bwd_gain_ms": mean["sm80"]["flash_bwd_device_ms"]
        - mean["fp32"]["flash_bwd_device_ms"],
        "loss_max_rel_err": loss_err, "loss_tol": 1e-5}
    emit(rec)
    assert loss_err <= 1e-5, f"fp32 and sm80 turns' losses differ by " \
        f"{loss_err}"
    del step, opt, model, params, state
    release()
    return fl, rec["step_p50_ms"], rec["profile"]["device_busy_share"]


def state_equal(a, b):
    """Names of the tensors of dict `a` that are not bit-equal to `b`'s."""
    return [k for k in a if not torch.equal(a[k], b[k])]


def opt_slots(opt):
    """{key: clone} of an optimizer's slot tensors and its step."""
    return {k: v.detach().clone() for k, v in opt.state_dict().items()
            if isinstance(v, torch.Tensor)}


def rng_equal(a, b):
    return torch.equal(a["cpu"], b["cpu"]) and len(a["cuda"]) == len(
        b["cuda"]) and all(torch.equal(x, y)
                           for x, y in zip(a["cuda"], b["cuda"]))


def optimizer_card_vs_cpu(steps=3):
    """The eleven optimizers the port added beside Adam / AdamW /
    Momentum / Adafactor: each takes `steps` steps on the card and on the
    CPU from the same float32 weights and gradients (numpy, seeded); the
    parameters must agree within 1e-6 of the largest.  LBFGS runs its
    strong-Wolfe line search on a least-squares closure (A [256, 64]); its
    iterates follow the rounding of every sum (the line search and the
    curvature pairs amplify it), so it is held to twice the CPU's own
    spread: the CPU against itself with the rows of A and y permuted
    (the same sums in another order; the largest of 4 permutations), or
    1e-6 when that is larger.
    Returns ({optimizer: error}, the LBFGS losses and that spread)."""
    from paddle_tpu_torch import optimizer as O

    rng = np.random.default_rng(11)
    shapes = [(768, 768), (768,), (3072, 768)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    kinds = {
        "SGD": lambda ps: O.SGD(learning_rate=0.1, parameters=ps),
        "Adagrad": lambda ps: O.Adagrad(learning_rate=0.1, parameters=ps),
        "RMSProp": lambda ps: O.RMSProp(learning_rate=0.01, momentum=0.9,
                                        parameters=ps),
        "RMSProp(centered)": lambda ps: O.RMSProp(
            learning_rate=0.01, centered=True, parameters=ps),
        "Adadelta": lambda ps: O.Adadelta(learning_rate=1.0, parameters=ps),
        "Lamb": lambda ps: O.Lamb(learning_rate=0.01, parameters=ps),
        "Adamax": lambda ps: O.Adamax(learning_rate=0.01, parameters=ps),
        "NAdam": lambda ps: O.NAdam(learning_rate=0.01, parameters=ps),
        "RAdam": lambda ps: O.RAdam(learning_rate=0.01, parameters=ps),
        "ASGD": lambda ps: O.ASGD(learning_rate=0.1, batch_num=2,
                                  parameters=ps),
        "Rprop": lambda ps: O.Rprop(learning_rate=0.01, parameters=ps)}

    def run(make, dev):
        ps = [torch.nn.Parameter(torch.from_numpy(p.copy()).to(dev))
              for p in p0]
        opt = make(ps)
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = torch.from_numpy(g.copy()).to(dev)
            opt.step()
            opt.clear_grad()
        return [p.detach().cpu() for p in ps]

    out = {}
    for name, make in kinds.items():
        card, cpu = run(make, "cuda"), run(make, "cpu")
        out[name] = max(float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(card, cpu))
    # LBFGS on min ||A w - y||^2 / n, A [256, 64]
    A = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    w0 = rng.standard_normal(64).astype(np.float32)

    def lbfgs(dev, rows=None):
        w = torch.nn.Parameter(torch.from_numpy(w0.copy()).to(dev))
        Ad, yd = ((A, y) if rows is None else (A[rows], y[rows]))
        Ad, yd = Ad.to(dev), yd.to(dev)
        opt = O.LBFGS(learning_rate=1.0, max_iter=5,
                      line_search_fn="strong_wolfe", parameters=[w])

        def closure():
            opt.clear_grad()
            loss = ((Ad @ w - yd) ** 2).mean()
            loss.backward()
            return loss

        losses = [opt.step(closure) for _ in range(steps)]
        return w.detach().cpu(), losses

    (wc, lc), (wp, lp) = lbfgs("cuda"), lbfgs("cpu")
    out["LBFGS(strong_wolfe)"] = float((wc - wp).abs().max()
                                       / wp.abs().max())
    spread = max(float((lbfgs("cpu", torch.from_numpy(
        rng.permutation(256)))[0] - wp).abs().max() / wp.abs().max())
        for _ in range(4))
    return out, {"lbfgs_card_losses": lc, "lbfgs_cpu_losses": lp,
                 "lbfgs_cpu_reordered_spread": spread,
                 "lbfgs_tol": max(1e-6, 2 * spread)}


def phase_bert_resume(fp32_p50_ms, fp32_busy, steps=8, batch=32, seq=128,
                      guard_steps=6):
    """The training state on BERT-base at full size
    (`BertConfig()`, 109.5M parameters, dropout 0.1, 2 classes, batch 32,
    seq 128, `bert_batch`'s padded rows with a float mask) in float32
    parameters under AMP O1 (`amp.auto_cast`; no `decorate`), TF32 off,
    AdamW(2e-5) under LinearWarmup(PolynomialDecay) with
    ClipGradByGlobalNorm(1.0), as Paddle users fine-tune.  Checkpoints go
    to a temporary directory removed at the end.  Four legs:

    1. resume, O1 float16 with a GradScaler(2**15), an eager loop
       (scale(loss).backward, scaler.step, update, sched.step): from one
       starting state 8 steps unbroken, twice; then 4 steps,
       CheckpointManager.save, a fresh model / optimizer / scaler /
       scheduler from other seeds and another random state, restore, 4
       more.  Gates: the restored parameters, slots, scaler, rate, step
       and random state bit-equal to the saved ones; the resumed losses
       and final parameters bit-equal to the unbroken run's (the two
       unbroken runs are compared first);
    2. guard, O1 bfloat16 through TrainStep(guard=NonfiniteGuard(
       max_consecutive=2, manager, fold_rng=False)) over 6 batches: a
       clean run; `step.nonfinite@1` after it (loss nonfinite, parameters
       bit-equal); a second run that checkpoints at step 2 and meets
       `step.nonfinite@1*2` (two skips, one rollback), whose replayed
       losses and final parameters equal the clean run's bit for bit;
    3. torn checkpoints: `ckpt.crash_after_meta_stage`,
       `ckpt.crash_after_arrays`, then `corrupt_checkpoint(
       truncate_arrays)`: each time `restore` falls back to the good one;
    4. the eleven new optimizers, card against CPU (within 1e-6 of the
       largest parameter; LBFGS within twice the CPU's own spread under
       reordered sums, `optimizer_card_vs_cpu`).

    `torch.use_deterministic_algorithms` is on for the phase: without it
    the token-type embedding's backward makes two runs differ (see
    tools/torch_determinism_probe.py).  Every BERT step launches the sm90
    forward, dK/dV and dQ 12 times, and no sm80, fp32 or plain sdpa
    (asserted per leg); the first O1 loss is
    within 2e-2 of the float32 loss of the same weights, batch and
    dropout draw.  Printed beside the gates: O1 step p50 / p99 and busy
    share (with bert_fp32_train's), save and load seconds and bytes, and
    the guard's cost a step at check_every 1 and 8.  Returns leg 1's
    first unbroken run's flash launch counts."""
    import os
    import shutil
    import tempfile
    import warnings

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as lr_sched
    from paddle_tpu_torch.resilience import (CheckpointManager,
                                             NonfiniteGuard, chaos)
    from paddle_tpu_torch.text import (BertConfig,
                                       BertForSequenceClassification)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = BertConfig()
    L = cfg.num_hidden_layers
    ids, seg, labels, mask = bert_batch(cfg, batch, seq, 3)
    fmask = mask.float()
    root = tempfile.mkdtemp(prefix="bert_resume_")

    def build(seed):
        model = BertForSequenceClassification(
            cfg, num_classes=2, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(seed))
        sched = lr_sched.LinearWarmup(
            lr_sched.PolynomialDecay(2e-5, decay_steps=16, end_lr=2e-6),
            warmup_steps=2, start_lr=0.0, end_lr=2e-5)
        opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        return model, opt, sched

    def o1_loss(model, ids_, seg_, mask_, labels_, dtype="float16"):
        with amp.auto_cast(dtype=dtype):
            return PF.cross_entropy(model(ids_, seg_, attention_mask=mask_),
                                    labels_)

    def eager(model, opt, sched, scaler, n, times=None):
        losses = []
        for _ in range(n):
            t0 = time.perf_counter()
            loss = o1_loss(model, ids, seg, fmask, labels)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            sched.step()
            losses.append(loss.item())
            if times is not None:
                times.append(time.perf_counter() - t0)
        return losses

    def check_counts(counts, n_steps, leg):
        fl = flash_part(counts)
        n = L * n_steps
        want = {"fwd": n, "dkv": n, "dq": n, "fwd_sm90": n, "dkv_sm90": n,
                "dq_sm90": n, "fwd_decode": 0, "fwd_fp32": 0,
                "dkv_fp32": 0, "dq_fp32": 0}
        assert fl == want and counts["sdpa_plain"] == 0, (leg, counts)
        return fl

    rec = {"phase": "bert_resume", "model": "bert-base (BertConfig())",
           "layers": L, "batch": batch, "seq": seq, "rows":
           mask.sum(1).tolist(), "params": "float32", "tf32": False,
           "deterministic_algorithms": "on (warn_only)",
           "optimizer": "AdamW(2e-5), LinearWarmup(PolynomialDecay(2e-5, "
                        "16, 2e-6), 2, 0, 2e-5), ClipGradByGlobalNorm(1.0)"}
    filters = warnings.filters[:]
    # the token-type embedding's backward (every token on one row) sums
    # with atomics, the one op whose gradient differs from run to run on
    # the card (tools/torch_determinism_probe.py); PyTorch's deterministic
    # version of it makes two runs equal bit for bit.  warn_only: cuBLAS,
    # already started by earlier phases, was bit-stable without it
    torch.use_deterministic_algorithms(True, warn_only=True)
    # ... without filling each torch.empty first, which the steps' times
    # would pay for and no result reads
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        # skips, rollbacks and fall-backs warn by design; so does
        # warn_only for cuBLAS
        warnings.simplefilter("ignore", RuntimeWarning)
        warnings.simplefilter("ignore", UserWarning)
        # ---- leg 1: resume, O1 float16 + GradScaler, eager loop
        def unbroken():
            model, opt, sched = build(0)
            scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
            ptt.seed(1234)
            return model, opt, sched, scaler

        model, opt, sched, scaler = unbroken()
        st = ptt.get_rng_state()
        with torch.no_grad():
            f32_loss = PF.cross_entropy(
                model(ids, seg, attention_mask=fmask), labels).item()
        ptt.set_rng_state(st)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        times_a = []
        run_a = eager(model, opt, sched, scaler, steps, times_a)
        main_counts = read_counts()
        fl_main = check_counts(main_counts, steps, "leg 1, run A")
        final_a = {k: p.detach().clone()
                   for k, p in model.named_parameters()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        del model, opt, sched, scaler

        model, opt, sched, scaler = unbroken()
        zero_counts()
        times_b = []
        run_b = eager(model, opt, sched, scaler, steps, times_b)
        check_counts(read_counts(), steps, "leg 1, run B")
        final_b = {k: p.detach().clone()
                   for k, p in model.named_parameters()}
        unbroken_equal = run_a == run_b and not state_equal(final_a, final_b)
        unbroken_diff = {
            "loss": max(abs(a - b) for a, b in zip(run_a, run_b)),
            "param": max(float((final_a[k] - final_b[k]).abs().max())
                         for k in final_a)}
        del model, opt, sched, scaler, final_b

        mgr = CheckpointManager(os.path.join(root, "resume"), max_to_keep=2)
        model, opt, sched, scaler = unbroken()
        zero_counts()
        run_c = eager(model, opt, sched, scaler, steps // 2)
        half = steps // 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(half, model=model, optimizer=opt, scaler=scaler)
        save_s = time.perf_counter() - t0
        ck = mgr.path_for(half)
        ck_bytes = sum(os.path.getsize(os.path.join(ck, f))
                       for f in os.listdir(ck))
        saved = {"params": {k: p.detach().clone()
                            for k, p in model.named_parameters()},
                 "slots": opt_slots(opt), "scaler": scaler.state_dict(),
                 "lr": opt.get_lr(), "step": opt._step_count,
                 "sched": sched.state_dict(), "rng": ptt.get_rng_state()}
        del model, opt, sched, scaler
        release()
        model, opt, sched = build(7)
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 4)
        ptt.seed(99)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = mgr.restore(model=model, optimizer=opt, scaler=scaler)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        restored = {
            "params": not state_equal(saved["params"], dict(
                model.named_parameters())),
            "slots": not state_equal(saved["slots"], opt_slots(opt)),
            "scaler": scaler.state_dict() == saved["scaler"],
            "lr": opt.get_lr() == saved["lr"],
            "step": opt._step_count == saved["step"],
            "scheduler": sched.state_dict() == saved["sched"],
            "rng": rng_equal(ptt.get_rng_state(), saved["rng"])}
        del saved
        run_c += eager(model, opt, sched, scaler, steps - half)
        check_counts(read_counts(), steps, "leg 1, resumed run")
        resumed_params_equal = not state_equal(
            final_a, dict(model.named_parameters()))
        o1_p50 = float(np.percentile(times_b[1:], 50)) * 1e3
        prof = busy(lambda: eager(model, opt, sched, scaler, 1), 3, o1_p50)
        rec["resume"] = {
            "amp": "O1 float16, GradScaler(2**15)",
            "first_step_o1_loss": run_a[0], "float32_loss": f32_loss,
            "first_step_err": abs(run_a[0] - f32_loss), "tol": 2e-2,
            "unbroken_a": run_a, "unbroken_b": run_b,
            "unbroken_runs_bit_equal": unbroken_equal,
            "unbroken_diff": unbroken_diff, "resumed": run_c,
            "resumed_losses_bit_equal": run_c == run_a,
            "resumed_params_bit_equal": resumed_params_equal,
            "restored_bit_equal": restored,
            "save_s": save_s, "load_s": load_s, "checkpoint_bytes": ck_bytes,
            "step_ms_a": [t * 1e3 for t in times_a],
            "step_ms_b": [t * 1e3 for t in times_b],
            "o1_step_p50_ms": o1_p50,
            "o1_step_p99_ms": float(np.percentile(times_b[1:], 99)) * 1e3,
            "o1_busy_share": prof["device_busy_share"], "profile": prof,
            "bert_fp32_train_step_p50_ms": fp32_p50_ms,
            "bert_fp32_train_busy_share": fp32_busy,
            "peak_memory_gib": peak, "launches": main_counts}
        del model, opt, sched, scaler, final_a
        release()

        # ---- leg 2: the guard, O1 bfloat16 through TrainStep
        batches = []
        for i in range(guard_steps):
            b_ids, b_seg, b_lab, b_mask = bert_batch(cfg, batch, seq, 20 + i)
            batches.append((b_ids, b_seg, b_mask.float(), b_lab))

        def bf16_loss(model_, ids_, seg_, mask_, labels_):
            return o1_loss(model_, ids_, seg_, mask_, labels_, "bfloat16")

        def guarded(guard):
            model_, opt_, _ = build(0)
            ptt.seed(4321)
            return model_, TrainStep(model_, bf16_loss, opt_, guard=guard)

        def drive(ts, upto, losses):
            while ts.step_count < upto:
                i = ts.step_count
                val = ts(*batches[i]).item()
                if np.isfinite(val):
                    losses[i] = val

        gmgr = CheckpointManager(os.path.join(root, "guard"), max_to_keep=2)
        g0 = NonfiniteGuard(max_consecutive=2, manager=gmgr, fold_rng=False)
        model, ts = guarded(g0)
        zero_counts()
        ref = {}
        drive(ts, guard_steps, ref)
        ref_params = {k: p.detach().clone()
                      for k, p in model.named_parameters()}
        with chaos.scoped("step.nonfinite@1"):
            bad = ts(*batches[0]).item()
        skip_ok = (not np.isfinite(bad) and g0.total_skipped == 1
                   and not state_equal(ref_params,
                                       dict(model.named_parameters())))
        check_counts(read_counts(), guard_steps + 1, "leg 2, clean run")
        del model, ts

        g2 = NonfiniteGuard(max_consecutive=2, manager=gmgr, fold_rng=False)
        model, ts = guarded(g2)
        zero_counts()
        got = {}
        drive(ts, 2, got)
        gmgr.save(2, train_step=ts)
        with chaos.scoped("step.nonfinite@1*2"):
            drive(ts, guard_steps, got)
        calls = 2 + 2 + (guard_steps - 2)
        check_counts(read_counts(), calls, "leg 2, rollback run")
        replay_equal = all(got[i] == ref[i] for i in range(guard_steps))
        replay_params = not state_equal(ref_params,
                                        dict(model.named_parameters()))
        rec["guard"] = {
            "amp": "O1 bfloat16", "mode": "fused", "max_consecutive": 2,
            "clean_losses": [ref[i] for i in range(guard_steps)],
            "poisoned_loss": bad, "skip_params_bit_equal": skip_ok,
            "rollback_losses": [got[i] for i in range(guard_steps)],
            "rollbacks": g2.rollbacks, "skipped": g2.total_skipped,
            "replayed_losses_bit_equal": replay_equal,
            "replayed_params_bit_equal": replay_params}

        # the guard's cost a step: steps without a guard and with one at
        # check_every 1 and 8, in turns (one step each, 8 rounds), so that
        # the host's drift falls on all three alike
        steps_ = {name: TrainStep(model, bf16_loss, ts.optimizer,
                                  guard=guard)
                  for name, guard in (
                      ("none", None), ("check_every_1", NonfiniteGuard()),
                      ("check_every_8", NonfiniteGuard(check_every=8)))}
        times = {name: [] for name in steps_}
        for r in range(9):
            for name, ts_ in steps_.items():
                t = step_ms(lambda: ts_(*batches[0]), 1)[0]
                if r:                    # round 0 warms each up
                    times[name].append(t)
        costs = {name: float(np.median(t)) for name, t in times.items()}
        rec["guard"]["step_p50_ms"] = costs
        rec["guard"]["step_ms"] = times
        rec["guard"]["cost_ms_check_every_1"] = \
            costs["check_every_1"] - costs["none"]
        rec["guard"]["cost_ms_check_every_8"] = \
            costs["check_every_8"] - costs["none"]

        # ---- leg 3: torn checkpoints on the card
        tmgr = CheckpointManager(os.path.join(root, "torn"), max_to_keep=10)
        tmgr.save(1, train_step=ts)
        good = {k: p.detach().clone() for k, p in model.named_parameters()}
        torn = {}
        for i, site in enumerate(("ckpt.crash_after_meta_stage",
                                  "ckpt.crash_after_arrays"), start=2):
            with chaos.scoped(f"{site}@1"):
                try:
                    tmgr.save(i, train_step=ts)
                    torn[site] = "no crash"
                except chaos.ChaosInterrupt:
                    pass
            ts(*batches[0])          # move the model off the good state
            meta = tmgr.restore(train_step=ts)
            torn.setdefault(site, meta["step"] == 1 and not state_equal(
                good, dict(model.named_parameters())))
        tmgr.save(4, train_step=ts)
        chaos.corrupt_checkpoint(tmgr.path_for(4), "truncate_arrays")
        ts(*batches[0])
        meta = tmgr.restore(train_step=ts)
        torn["truncate_arrays"] = meta["step"] == 1 and not state_equal(
            good, dict(model.named_parameters()))
        rec["torn"] = torn
        del model, ts, good, ref_params
        release()

        # ---- leg 4: the eleven optimizers, card against CPU
        opt_err, lbfgs = optimizer_card_vs_cpu()
        rec["optimizers"] = {"max_rel_err": opt_err, "tol": 1e-6, **lbfgs}
        emit(rec)
    finally:
        chaos.uninstall()
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        warnings.filters[:] = filters
        shutil.rmtree(root, ignore_errors=True)
        release()

    res = rec["resume"]
    assert res["first_step_err"] <= 2e-2, res["first_step_err"]
    assert all(res["restored_bit_equal"].values()), res["restored_bit_equal"]
    assert res["unbroken_runs_bit_equal"], res["unbroken_diff"]
    assert res["resumed_losses_bit_equal"], (run_a, run_c)
    assert res["resumed_params_bit_equal"]
    g = rec["guard"]
    assert g["skip_params_bit_equal"], g
    assert (g["rollbacks"], g["skipped"]) == (1, 2), g
    assert g["replayed_losses_bit_equal"] and \
        g["replayed_params_bit_equal"], g
    assert all(v is True for v in rec["torn"].values()), rec["torn"]
    lb = rec["optimizers"]
    assert all(e <= 1e-6 for k, e in opt_err.items()
               if k != "LBFGS(strong_wolfe)"), opt_err
    assert opt_err["LBFGS(strong_wolfe)"] <= lb["lbfgs_tol"], lb
    return fl_main


def phase_bert_e2e(steps=3, batch=8, seq=128, layers=2):
    """BERT at full width and 2 layers, float32, AdamW, padded rows: the
    training step on the card (flash kernels; float32 takes fp32) against
    the same on the CPU (plain versions), same weights and batch: losses
    within 1e-5, parameters within 1e-3 of how far they moved.  The key
    projection's bias is reported apart and left out of that distance:
    its gradient is zero in exact arithmetic (it shifts every score of a
    row alike), so each side moves it by its own rounding noise."""
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text import (BertConfig,
                                       BertForSequenceClassification)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = BertConfig(num_hidden_layers=layers, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    card = BertForSequenceClassification(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(3))
    cpu = BertForSequenceClassification(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    init = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
    seg = torch.from_numpy(rng.integers(0, 2, (batch, seq)))
    lens = rng.integers(seq // 2, seq + 1, batch)
    mask = torch.from_numpy((np.arange(seq)[None, :]
                             < lens[:, None]).astype(np.int64))
    labels = torch.from_numpy(rng.integers(0, 2, batch))

    def train(model, dev):
        step = train_step(model, masked_loss,
                          AdamW(learning_rate=1e-4, weight_decay=0.01,
                                parameters=model.parameters()))
        batch_ = [t.to(dev) for t in (ids, seg, mask, labels)]
        return [step(*batch_).item() for _ in range(steps)]

    zero_counts()
    card_losses = train(card, "cuda")
    counts = read_counts()
    n = layers * steps
    assert flash_part(counts) == {"fwd": n, "dkv": n, "dq": n,
                                  "fwd_sm90": 0, "dkv_sm90": 0,
                                  "dq_sm90": 0, "fwd_decode": 0,
                                  "fwd_fp32": n, "dkv_fp32": n,
                                  "dq_fp32": n}, counts
    assert counts["sdpa_plain"] == 0, counts
    t0 = time.perf_counter()
    cpu_losses = train(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                       cpu_losses))
    perr = param_error(card, cpu, init, skip="k_proj.bias")
    emit({"phase": "bert_e2e", "model": f"bert-base width, {layers} layers",
          "dtype": "float32", "optimizer": "AdamW(1e-4, wd 0.01)",
          "batch": batch, "seq": seq, "steps": steps,
          "rows": lens.tolist(), "card_losses": card_losses,
          "cpu_losses": cpu_losses, "loss_max_rel_err": loss_err,
          "loss_tol": 1e-5, "param_rel_err": perr, "param_tol": 1e-3,
          "k_proj_bias_rel_err": param_error(card, cpu, init,
                                             only="k_proj.bias"),
          "cpu_seconds": cpu_s, "launches": counts})
    assert loss_err <= 1e-5, f"card and CPU losses differ by {loss_err}"
    assert perr <= 1e-3, f"card and CPU parameters differ: {perr}"
    del card, cpu
    release()
    return flash_part(counts)


def flash_nodes(program):
    """The flash operator's nodes in an exported program's graph."""
    return [nd for nd in program.graph.nodes if nd.op == "call_function"
            and "paddle_tpu_torch.flash_fwd" in str(nd.target)]


def export_predictor(model, spec):
    """save_inference into a temporary directory -> create_predictor;
    (predictor, export seconds)."""
    import tempfile
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.jit import save_inference
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_inference(model, tmp, spec)
        secs = time.perf_counter() - t0
        return inference.create_predictor(inference.Config(tmp)), secs


def ernie_medium():
    """ERNIE-3.0-medium as run_ernie_infer builds it, on the card, weights
    from generator seed 0, in eval mode."""
    from paddle_tpu_torch.text import (ErnieForSequenceClassification,
                                       ernie_config_from_preset)
    cfg = ernie_config_from_preset("ernie-3.0-medium-zh",
                                   hidden_dropout_prob=0.0)
    model = ErnieForSequenceClassification(
        cfg, num_classes=2, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    return model.eval()


def ernie_aot_export(path, dtype, batch=32, seq=128):
    """`chip_smoke.py --aot-export ernie_DTYPE DIR` (`aot_export`):
    ERNIE-3.0-medium (`ernie_medium`) saved with `save_inference(aot=
    True)` at [batch, seq] into DIR, in float32 or under AMP O2 bf16, as
    ernie_infer exports it."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import InputSpec, save_inference
    model = ernie_medium()
    if dtype == "bfloat16":
        amp.decorate(models=model, dtype="bfloat16")
    save_inference(model, path,
                   [InputSpec([batch, seq], "int64", "input_ids")],
                   aot=True)


def phase_ernie_infer(aot, steps=30, warmup=5, batch=32, seq=128):
    """ERNIE-3.0-medium inference as bench.py::run_ernie_infer runs it:
    ernie_config_from_preset("ernie-3.0-medium-zh", hidden_dropout_prob=
    0.0), ErnieForSequenceClassification, eval, save_inference over
    InputSpec([32, 128], "int64", "input_ids"), create_predictor,
    copy_from_cpu, 5 warm-up and 30 timed run()s, copy_to_cpu; float32
    (run_ernie_infer never decorates), so the forward takes the fp32
    kernel.  Asserts: the exported graph holds the flash operator once a
    layer, each run launches the fp32 forward 6 times and sm80 none, and
    the logits equal the eager model's on the card (ERNIE_EAGER_TOL); the
    flash forward's device time a run comes from the profile.  Then the same in
    bf16 (AMP O2 before the export): sm90 launches, logits within
    ERNIE_BF16_TOL of the float32 run's.  Returns {path: flash launch
    counts}.  Each dtype's AOT package (`ernie_aot_export`, compiled by
    `start_aot_compile`) is loaded and held against the exported program
    (`ernie_aot`)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import InputSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    model = ernie_medium()
    cfg = model.ernie.cfg
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq)).astype("int64")
    L = cfg.num_hidden_layers
    rec = {"phase": "ernie_infer", "model": "ernie-3.0-medium-zh",
           "layers": L, "batch": batch, "seq": seq,
           "n_params": sum(p.numel() for p in model.parameters()),
           "eager_tol": ERNIE_EAGER_TOL, "bf16_tol": ERNIE_BF16_TOL}
    paths, logits = {}, {}
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            amp.decorate(models=model, dtype="bfloat16")
        predictor, export_s = export_predictor(
            model, [InputSpec([batch, seq], "int64", "input_ids")])
        nodes = len(flash_nodes(predictor._layer.program))
        h = predictor.get_input_handle(predictor.get_input_names()[0])
        h.copy_from_cpu(ids)
        out = predictor.get_output_handle(predictor.get_output_names()[0])
        for _ in range(warmup):
            predictor.run()
        out.copy_to_cpu()                              # waits for the card
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            predictor.run()
        got = out.copy_to_cpu()
        wall = time.perf_counter() - t0
        counts = read_counts()
        run_ms = step_ms(predictor.run, steps)
        with torch.no_grad():
            eager = model(torch.from_numpy(ids).cuda()).float().cpu().numpy()
        diff = float(np.abs(got - eager).max())
        fl = flash_part(counts)
        rec[dtype] = {
            "export_s": export_s, "graph_flash_ops": nodes,
            "sequences_per_s": batch * steps / wall,
            "run_p50_ms": pct(run_ms)["p50"], "run_p99_ms": pct(run_ms)["p99"],
            "run_ms": run_ms, "logits_equal_eager": bool(np.array_equal(
                got, eager)), "eager_max_abs_diff": diff,
            "logit0": float(got.reshape(-1)[0]), "launches": counts,
            "profile": busy(predictor.run, 3, pct(run_ms)["p50"])}
        sm90 = L * steps if dtype == "bfloat16" else 0
        fp32 = L * steps - sm90
        if fp32:    # the flash forward's device time a run, from the
            # profile, beside the 0.591 ms a run of the sm80 forward that
            # this path ran before the fp32 kernel (PERF.md section 5)
            rec[dtype]["flash_fwd_device_ms_per_run"] = \
                rec[dtype]["profile"]["flash_ms_per_step"]
            rec[dtype]["sm80_flash_fwd_device_ms_per_run_before"] = 0.591
        assert nodes == L, (dtype, nodes)
        assert (fl["fwd"], fl["fwd_sm90"], fl["fwd_fp32"], fl["dkv"],
                fl["dq"]) == (L * steps, sm90, fp32, 0, 0), (dtype, fl)
        assert counts["sdpa_plain"] == 0, counts
        assert diff <= ERNIE_EAGER_TOL, (dtype, diff)
        logits[dtype] = got
        name = f"ernie_infer_{'bf16' if sm90 else 'fp32'}"
        paths[name] = fl
        tmp, export = aot[f"ernie_{dtype}"]
        rec[dtype]["aot"], paths[f"{name}_aot"] = ernie_aot(
            tmp.name, predictor, ids, dtype, fl, steps)
        rec[dtype]["aot"]["export_process_wall_s"] = export["wall_s"]
        del predictor
    gap = float(np.abs(logits["bfloat16"] - logits["float32"]).max())
    rec.update(bf16_vs_fp32_max_abs=gap,
               fp32_logit_max_abs=float(np.abs(logits["float32"]).max()))
    emit(rec)
    assert gap <= ERNIE_BF16_TOL, gap
    del model
    release()
    return paths


# an AOT package against the exported program it was compiled beside:
# the compiler fuses each LayerNorm's reductions and the residual adds
# into one kernel and sums them in another order (float32: a few units
# in the last place a layer, 6 layers, logits near 1); in bf16 it also
# keeps fused intermediates in float32 where the program rounds each
# op's output to bf16, so the bf16-vs-float32 gap bounds it
ERNIE_AOT_TOL = {"float32": 1e-4, "bfloat16": ERNIE_BF16_TOL}


def ernie_aot(path, predictor, ids, dtype, fl, steps, rounds=4, turn=5):
    """The `save_inference(aot=True)` export of the same model at the same
    shape in `path`, `load_inference(strict_aot=True)`: `is_aot`, the
    package's bytes, run p50/p99 in turns with the exported program's
    (`rounds` turns of `turn` runs: exported, AOT), flash launches of
    `steps` AOT runs equal to the exported program's (`fl`), and the
    logits against the exported program's (ERNIE_AOT_TOL).  Returns (the
    record, the AOT runs' flash launches)."""
    from paddle_tpu_torch.jit import load_inference
    from paddle_tpu_torch.jit import save_load
    x = torch.from_numpy(ids).cuda()
    pkg = os.path.getsize(os.path.join(path, save_load._AOT))
    t0 = time.perf_counter()
    layer = load_inference(path, strict_aot=True)
    load_s = time.perf_counter() - t0
    assert layer.is_aot
    for _ in range(3):
        layer(x)
    zero_counts()
    for _ in range(steps):
        out = layer(x)
    counts = read_counts()
    aot_fl = flash_part(counts)
    ms = {"exported": [], "aot": []}
    for _ in range(rounds):
        ms["exported"] += step_ms(predictor.run, turn)
        ms["aot"] += step_ms(lambda: layer(x), turn)
    h = predictor.get_output_handle(predictor.get_output_names()[0])
    predictor.run()
    want = h.copy_to_cpu()
    err = float(np.abs(out.float().cpu().numpy() - want).max())
    rec = {"is_aot": layer.is_aot, "package_bytes": pkg, "load_s": load_s,
           "run_ms": {k: pct(v) for k, v in ms.items()},
           "launches": counts, "max_abs_err_vs_exported": err,
           "tol": ERNIE_AOT_TOL[dtype]}
    assert aot_fl == fl and counts["sdpa_plain"] == 0, (aot_fl, fl)
    assert err <= ERNIE_AOT_TOL[dtype], (dtype, err)
    return rec, aot_fl


def phase_ernie_e2e(batch=8, seq=128, layers=2):
    """ERNIE-3.0-medium width at 2 layers, float32: the predictor of the
    program exported on the card (the fp32 forward) against the eager
    model on the CPU (the plain version), same weights, padded rows fed
    as ids only (the deployment input): logits within 1e-4."""
    from paddle_tpu_torch.jit import InputSpec
    from paddle_tpu_torch.text import (ErnieForSequenceClassification,
                                       ernie_config_from_preset)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ernie_config_from_preset("ernie-3.0-medium-zh",
                                   num_hidden_layers=layers,
                                   hidden_dropout_prob=0.0)
    card = ErnieForSequenceClassification(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(4))
    cpu = ErnieForSequenceClassification(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    card.eval()
    cpu.eval()
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                            (batch, seq)).astype(np.int64)
    predictor, _ = export_predictor(
        card, [InputSpec([None, seq], "int64", "input_ids")])
    h = predictor.get_input_handle("input_ids")
    zero_counts()
    h.copy_from_cpu(ids)
    predictor.run()
    got = predictor.get_output_handle("output_0").copy_to_cpu()
    h.copy_from_cpu(ids[:3])                      # the dynamic batch dim
    predictor.run()
    got3 = predictor.get_output_handle("output_0").copy_to_cpu()
    counts = read_counts()
    with torch.no_grad():
        want = cpu(torch.from_numpy(ids)).numpy()
    err = float(np.abs(got - want).max())
    err3 = float(np.abs(got3 - want[:3]).max())
    emit({"phase": "ernie_e2e", "model": f"ernie-3.0-medium width, "
          f"{layers} layers", "dtype": "float32", "batch": batch,
          "seq": seq, "max_abs_err": err, "batch3_max_abs_err": err3,
          "tol": 1e-4, "launches": counts})
    assert flash_part(counts) == {"fwd": 2 * layers, "dkv": 0, "dq": 0,
                                  "fwd_sm90": 0, "dkv_sm90": 0,
                                  "dq_sm90": 0, "fwd_decode": 0,
                                  "fwd_fp32": 2 * layers, "dkv_fp32": 0,
                                  "dq_fp32": 0}, counts
    assert counts["sdpa_plain"] == 0, counts
    assert max(err, err3) <= 1e-4, (err, err3)
    del card, cpu, predictor
    release()
    return flash_part(counts)


def bert_shape_timing(fa, flush):
    """The flash kernels at BERT's shape (B 32, L 128, H 12, D 64, bf16,
    non-causal), unmasked and under the additive padding mask [32, 1, 1,
    128] of rows 64 to 128 keys: the forward, dK/dV and dQ on sm80 and
    sm90, in turns with SDPA (forward; and its backward through autograd,
    dq, dk and dv in one call) under the same mask (sm80, sm90, SDPA,
    SDPA, sm90, sm80), and each one's bound, counting the visible keys
    this mask leaves.  The port's kernels take the mask as the path hands
    it to them (float32, `_normalize_mask`: the training path converts it
    once, in the forward), so no conversion launch is timed with them;
    SDPA takes it in bf16."""
    B, L, H, D = 32, 128, 12, 64
    dtype = torch.bfloat16
    q, k, v, do, _ = flash_inputs(B, L, L, H, H, D, None, dtype, seed=13)
    g = torch.Generator(device="cuda").manual_seed(14)
    mask = bert_padding_mask(B, L, dtype, g)
    visible_keys = int((mask[:, 0, 0] == 0).sum())       # over the batch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    out = {}
    for masked in (False, True):
        m = fa._normalize_mask(mask) if masked else None
        lm = mask if masked else None                  # SDPA's, in bf16
        err = flash_errors(fa, q, k, v, do, m, False, 0, ("sm90", "sm80"),
                           ("sm90", "sm80"))
        assert all(e["fwd"][2] for e in err["fwd"].values()), err
        assert all(e[n][2] for e in err["bwd"].values()
                   for n in ("dkv", "dq")), err
        o, lse = fa.flash_fwd_cuda(q, k, v, m)
        delta = fa._delta(do, o)

        def fwd(impl):
            return lambda: fa.flash_fwd_cuda(q, k, v, m, _impl=impl)

        def dkv(impl):
            return lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, m,
                                                 _impl=impl)

        def dq(impl):
            return lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, m,
                                                _impl=impl)

        def lib_fwd():
            return sdpa(qh, kh, vh, attn_mask=lm)

        lib_out = sdpa(qh, kh, vh, attn_mask=lm)
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (qh, kh, vh), doh, retain_graph=True)
        turns = {"fwd": [], "dkv": [], "dq": []}
        for order in ((("sm80", "sm90", "sdpa"), ("sdpa", "sm90", "sm80"))):
            for impl in order:
                with torch.no_grad():
                    turns["fwd"].append((impl, cuda_ms(
                        lib_fwd if impl == "sdpa" else fwd(impl), flush,
                        iters=25)))
                for name, fn in (("dkv", dkv), ("dq", dq)):
                    if impl == "sdpa":
                        if name == "dkv":
                            turns[name].append(("sdpa_bwd", cuda_ms(
                                lib_bwd, flush, iters=25)))
                    else:
                        turns[name].append((impl, cuda_ms(fn(impl), flush,
                                                          iters=25)))
        ms = {name: {i: float(np.mean([t for j, t in ts if j == i]))
                     for i in {j for j, _ in ts}}
              for name, ts in turns.items()}
        esize = 2
        tensor = B * L * H * D * esize
        rows = B * H * L * 4
        mbytes = B * L * 4 if masked else 0            # the float32 mask
        pairs = H * L * (visible_keys if masked else B * L)
        product = 2 * pairs * D
        costs = {"fwd": (4 * tensor + rows + mbytes, 2 * product),
                 "dkv": (6 * tensor + 2 * rows + mbytes, 4 * product),
                 "dq": (5 * tensor + 2 * rows + mbytes, 3 * product)}
        bounds = {}
        for name, (nbytes, flops) in costs.items():
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            o_ms = flops / BF16_FLOPS * 1e3
            bounds[name] = {"bytes": nbytes, "flops": flops,
                            "bound_ms": max(b_ms, o_ms),
                            "bound_by": "bytes" if b_ms >= o_ms
                            else "operations"}
        out["masked" if masked else "unmasked"] = {
            "turns_ms": turns, "ms": ms, "bounds": bounds,
            "dkv_plus_dq_ms": {f: ms["dkv"][f] + ms["dq"][f]
                               for f in ("sm90", "sm80")},
            "dkv_plus_dq_bound_ms": bounds["dkv"]["bound_ms"]
            + bounds["dq"]["bound_ms"],
            "sdpa_bwd_ms": ms["dkv"]["sdpa_bwd"],
            "max_abs_err": {f"{n}_{fam}": v[n][0] for kind, d in err.items()
                            for fam, v in d.items() for n in (
                                ("fwd",) if kind == "fwd" else ("dkv", "dq"))},
            "library": "torch SDPA on [B, H, L, D]"
                       + (" with the same additive mask" if masked else "")
                       + "; sdpa_bwd: its backward (dq, dk, dv together)"}
    out["shape"] = {"B": B, "L": L, "H": H, "D": D, "dtype": "bfloat16",
                    "causal": False, "mask": "[32, 1, 1, 128] additive, "
                    f"{visible_keys} of {B * L} keys visible"}
    return out


def fp32_fwd_timing(fa, flush):
    """The float32 forward, TF32 off: at ERNIE's shape (B 32, L 128, H 12,
    D 64, non-causal) as `ernie_infer` runs it (no mask) and under the
    [32, 1, 1, 128] additive padding mask, and once at the `train_fp32`
    case's shape (B 4, L 1024, H 16, D 128, causal: D 128 and the causal
    edge tiles).  The fp32 kernel (the route's family) and the sm80
    kernel forced, in turns with float32 SDPA on [B, H, L, D] under the
    same mask (fp32, sm80, SDPA, SDPA, sm80, fp32), each against the
    plain version, the plain version's time, and the bound: float32
    operations at 67 TFLOP/s (no TF32) or bytes, the larger."""
    dtype = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rtol, atol = FLASH_FWD_TOL[dtype]
    out = {"library": "torch SDPA on [B, H, L, D], float32, TF32 off, the "
                      "same additive mask (is_causal at the causal shape)"}
    for name, (B, L, H, D, causal), seed in (
            ("ernie", (32, 128, 12, 64, False), 15),
            ("train_fp32", (4, 1024, 16, 128, True), 17)):
        q, k, v, _, _ = flash_inputs(B, L, L, H, H, D, None, dtype, seed)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        mask = bert_padding_mask(B, L, dtype, g) if name == "ernie" else None
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        rec = {"shape": {"B": B, "L": L, "H": H, "D": D, "dtype": "float32",
                         "causal": causal, "tf32": False}}
        for masked in (False, True) if mask is not None else (False,):
            m = mask if masked else None
            assert fa._fwd_route(q, k, v, fa._normalize_mask(m),
                                 dtype) == "fp32"
            ref_o, ref_lse = fa.flash_fwd_plain(q, k, v, m, is_causal=causal)
            errs = {}
            for impl in ("fp32", "sm80"):
                o, lse = fa.flash_fwd_cuda(q, k, v, m, is_causal=causal,
                                           _impl=impl)
                d = (o - ref_o).abs()
                errs[impl] = float(d.max())
                errs[f"{impl}_lse"] = float((lse - ref_lse).abs().max())
                assert bool((d <= atol + rtol * ref_o.abs()).all()), \
                    (name, impl, errs)
            with torch.no_grad():
                lib = sdpa(qh, kh, vh, attn_mask=m, is_causal=causal)
                errs["sdpa"] = float((lib.transpose(1, 2) - ref_o).abs()
                                     .max())
            del ref_o, ref_lse, lib

            def run(impl, m=m):
                if impl == "sdpa":
                    return lambda: sdpa(qh, kh, vh, attn_mask=m,
                                        is_causal=causal)
                return lambda: fa.flash_fwd_cuda(q, k, v, m, is_causal=causal,
                                                 _impl=impl)

            with torch.no_grad():
                turns = [(impl, cuda_ms(run(impl), flush, iters=25))
                         for impl in ("fp32", "sm80", "sdpa", "sdpa", "sm80",
                                      "fp32")]
            ms = {i: sum(t for j, t in turns if j == i) / 2
                  for i in ("fp32", "sm80", "sdpa")}
            plain_ms = cuda_ms(lambda: fa.flash_fwd_plain(
                q, k, v, m, is_causal=causal), flush, iters=10)
            keys = int((mask[:, 0, 0] == 0).sum()) if masked else B * L
            pairs = (H * L * keys if not causal
                     else B * H * L * (L + 1) // 2)   # visible (q, k) pairs
            nbytes = 4 * q.numel() * 4 + B * H * L * 4 + (B * L * 4 if masked
                                                           else 0)
            flops = 2 * 2 * pairs * D
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / FP32_FLOPS * 1e3
            bound = max(bytes_ms, ops_ms)
            rec["masked" if masked else "unmasked"] = {
                "turns_ms": turns, "ms": ms["fp32"], "sm80_ms": ms["sm80"],
                "library_ms": ms["sdpa"], "plain_ms": plain_ms,
                "sm80_over_fp32": ms["sm80"] / ms["fp32"],
                "fp32_over_library": ms["fp32"] / ms["sdpa"],
                "max_abs_err": errs["fp32"], "lse_max_abs_err":
                errs["fp32_lse"], "sm80_max_abs_err": errs["sm80"],
                "library_max_abs_err": errs["sdpa"], "visible_pairs": pairs,
                "bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
                "ops_ms": ops_ms, "bound_ms": bound,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "share_of_bound": bound / ms["fp32"],
                "sm80_share_of_bound": bound / ms["sm80"]}
        out[name] = rec
        del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    return out


def fp32_bwd_timing(fa, flush):
    """The float32 backward, TF32 off: the fp32 dK/dV and dQ (the float32
    route) and the sm80 ones forced, at `bert_e2e`'s shape (B 8, L 128,
    H 12, D 64, non-causal) and at ERNIE's (B 32), unmasked and under the
    [B, 1, 1, 128] additive padding mask, and at the `train_fp32` case's
    shape (B 4, L 1024, H 16, D 128, causal, no mask): each against its
    plain version (`flash_errors`: the fp32 pair twice, equal bits), then
    in turns with float32 SDPA's backward through autograd (dq, dk and dv
    in one call; is_causal at the causal shape) under the same mask
    (fp32, sm80, SDPA, SDPA, sm80, fp32), each beside its bound: float32
    operations at 67 TFLOP/s (dK/dV 4 products, dQ 3, SDPA's backward 5)
    or bytes, the larger, over the (query, key) pairs the mask leaves.
    Medians of 25 launches after 10 of warm-up: an autograd backward's
    host side outlasts the launch cover now and then (0.2-0.4 ms spikes
    against ~0.075 ms on an H100)."""
    dtype = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"library": "torch SDPA's backward through autograd (dq, dk, dv "
                      "together) on [B, H, L, D], float32, TF32 off, the "
                      "same additive mask (is_causal at the causal shape)"}
    for name, (B, L, H, D, causal), seed in (
            ("bert_e2e", (8, 128, 12, 64, False), 18),
            ("ernie", (32, 128, 12, 64, False), 20),
            ("train_fp32", (4, 1024, 16, 128, True), 22)):
        q, k, v, do, _ = flash_inputs(B, L, L, H, H, D, None, dtype, seed)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        mask = None if causal else bert_padding_mask(B, L, dtype, g)
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        doh = do.transpose(1, 2).contiguous()
        rec = {"shape": {"B": B, "L": L, "H": H, "D": D, "dtype": "float32",
                         "causal": causal, "tf32": False}}
        for masked in (False, True) if mask is not None else (False,):
            m = mask if masked else None
            kw = dict(is_causal=causal)
            err = flash_errors(fa, q, k, v, do, m, causal, 0, (None,),
                               (None, "sm80"))
            e, e80 = err["bwd"][None], err["bwd"]["sm80"]
            assert e["launched"] == "fp32" and e["dkv"][2] and e["dq"][2] \
                and e["repeat_equal"], (name, masked, e)
            assert e80["launched"] == "sm80" and e80["dkv"][2] \
                and e80["dq"][2], (name, masked, e80)
            o, lse = fa.flash_fwd_cuda(q, k, v, m, **kw)
            delta = fa._delta(do, o)
            lib_out = sdpa(qh, kh, vh, attn_mask=m, is_causal=causal)
            fns = {"sdpa_bwd": lambda: torch.autograd.grad(
                lib_out, (qh, kh, vh), doh, retain_graph=True)}
            for impl in ("fp32", "sm80"):
                fns[f"dkv_{impl}"] = lambda impl=impl: fa.flash_bwd_dkv_cuda(
                    q, k, v, do, lse, delta, m, **kw, _impl=impl)
                fns[f"dq_{impl}"] = lambda impl=impl: fa.flash_bwd_dq_cuda(
                    q, k, v, do, lse, delta, m, **kw, _impl=impl)
            for fn in fns.values():
                for _ in range(10):
                    fn()
            turns = []
            for impl in ("fp32", "sm80", "sdpa", "sdpa", "sm80", "fp32"):
                for kname in (("sdpa_bwd",) if impl == "sdpa" else
                              (f"dkv_{impl}", f"dq_{impl}")):
                    turns.append((kname, cuda_ms(fns[kname], flush,
                                                 iters=25, median=True)))
            ms = {n: sum(t for j, t in turns if j == n) / 2 for n in fns}
            plain_ms = cuda_ms(lambda: fa.flash_bwd_plain(
                q, k, v, do, lse, delta, m, **kw), flush, iters=5)
            keys = int((mask[:, 0, 0] == 0).sum()) if masked else B * L
            pairs = (B * H * L * (L + 1) // 2 if causal
                     else H * L * keys)       # visible (query, key) pairs
            tensor = B * L * H * D * 4
            rows = B * H * L * 4
            mbytes = B * L * 4 if masked else 0
            product = 2 * pairs * D
            bounds = {}
            for kname, nbytes, flops in (
                    ("dkv", 6 * tensor + 2 * rows + mbytes, 4 * product),
                    ("dq", 5 * tensor + 2 * rows + mbytes, 3 * product),
                    ("sdpa_bwd", 7 * tensor + 2 * rows + mbytes,
                     5 * product)):
                b_ms = nbytes / HBM_BYTES_PER_S * 1e3
                o_ms = flops / FP32_FLOPS * 1e3
                bounds[kname] = {"bytes": nbytes, "flops": flops,
                                 "bytes_ms": b_ms, "ops_ms": o_ms,
                                 "bound_ms": max(b_ms, o_ms),
                                 "bound_by": "bytes" if b_ms >= o_ms
                                 else "operations"}
            pair_bound = bounds["dkv"]["bound_ms"] + bounds["dq"]["bound_ms"]
            fp32_ms = ms["dkv_fp32"] + ms["dq_fp32"]
            sm80_ms = ms["dkv_sm80"] + ms["dq_sm80"]
            rec["masked" if masked else "unmasked"] = {
                "turns_ms": turns,
                "ms": {"dkv": ms["dkv_fp32"], "dq": ms["dq_fp32"]},
                "sm80_ms": {"dkv": ms["dkv_sm80"], "dq": ms["dq_sm80"]},
                "library_ms": ms["sdpa_bwd"], "plain_ms": plain_ms,
                "bounds": bounds, "dkv_plus_dq_ms": fp32_ms,
                "sm80_dkv_plus_dq_ms": sm80_ms,
                "dkv_plus_dq_bound_ms": pair_bound,
                "sm80_over_fp32": sm80_ms / fp32_ms,
                "fp32_over_library": fp32_ms / ms["sdpa_bwd"],
                "sm80_over_library": sm80_ms / ms["sdpa_bwd"],
                "share_of_bound": pair_bound / fp32_ms,
                "sm80_share_of_bound": pair_bound / sm80_ms,
                "dkv_max_err": e["dkv"][1], "dq_max_err": e["dq"][1],
                "dkv_max_abs_err": e["dkv"][0], "dq_max_abs_err": e["dq"][0],
                "sm80_dkv_max_err": e80["dkv"][1],
                "sm80_dq_max_err": e80["dq"][1],
                "repeat_equal": e["repeat_equal"], "visible_pairs": pairs}
            del lib_out, o, lse, delta, fns
        out[name] = rec
        del q, k, v, do, qh, kh, vh, doh
        torch.cuda.empty_cache()
    return out


def decode_shape_timing(fa, flush):
    """The flash forward at the Mistral-7B decode shape: Lq 1, a per-row
    [4, 1, 1, 576] bool mask, GQA 32 / 8, D 128, bf16.  The decode kernel
    (the route's family) and the sm80 kernel forced, in turns on the same
    inputs (sm80, decode, decode, sm80), PyTorch's SDPA with the same mask
    as a yardstick between them, the decode kernel's plain version, a
    sweep of forced split counts, and the bound."""
    B, Lk, H, Hkv, D = 4, 576, 32, 8, 128
    dtype = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn(B, 1, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Lk, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Lk, Hkv, D, generator=g, device="cuda").to(dtype)
    lens = torch.tensor([576, 560, 544, 530], device="cuda")
    mask = (torch.arange(Lk, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    route = fa._fwd_route(q, k, v, fa._normalize_mask(mask), dtype)
    assert route == "decode", route
    rtol, atol = FLASH_FWD_TOL[dtype]
    ref, _ = fa.flash_fwd_plain(q, k, v, mask)
    errs = {}
    for impl in ("decode", "sm80"):
        o, _ = fa.flash_fwd_cuda(q, k, v, mask, _impl=impl)
        for want in ((ref, fa.flash_decode_plain(q, k, v, mask)[0])
                     if impl == "decode" else (ref,)):
            d = (o.float() - want.float()).abs()
            errs[impl] = max(errs.get(impl, 0.0), float(d.max()))
            assert bool((d <= atol + rtol * want.float().abs()).all()), \
                (impl, errs)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def run(impl):
        if impl == "sdpa":
            return lambda: sdpa(qh, kh, vh, attn_mask=mask, enable_gqa=True)
        return lambda: fa.flash_fwd_cuda(q, k, v, mask, _impl=impl)

    with torch.no_grad():
        turns = [(impl, cuda_ms(run(impl), flush))
                 for impl in ("sm80", "decode", "sdpa", "decode", "sm80",
                              "sdpa")]
    ms = {i: sum(t for j, t in turns if j == i) / 2
          for i in ("sm80", "decode", "sdpa")}
    splits, keys = fa.decode_split_plan(Lk)
    sweep = [{"splits": fa.decode_split_plan(Lk, n)[0],
              "split_keys": fa.decode_split_plan(Lk, n)[1],
              "ms": cuda_ms(lambda: fa.flash_fwd_cuda(
                  q, k, v, mask, _impl="decode", _splits=n), flush,
                  iters=25)}
             for n in (1, 3, 5, 18, 36)]
    plain_ms = cuda_ms(lambda: fa.flash_decode_plain(q, k, v, mask), flush,
                       iters=20)
    visible = int(lens.sum())
    nbytes = (q.numel() * 2 + 2 * k.numel() * 2 + mask.numel()
              + q.numel() * 2 + B * H * 4)   # q, k, v, mask; o, lse
    flops = 4 * visible * H * D
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return {"shape": {"B": B, "Lq": 1, "Lk": Lk, "H": H, "Hkv": Hkv, "D": D,
                      "mask": "[4, 1, 1, 576] bool, lens 576/560/544/530",
                      "dtype": "bfloat16"},
            "family": route, "splits": splits, "split_keys": keys,
            "turns_ms": turns, "ms": ms["decode"], "sm80_ms": ms["sm80"],
            "sm80_over_decode": ms["sm80"] / ms["decode"],
            "split_sweep": sweep, "plain_ms": plain_ms,
            "library_ms": ms["sdpa"],
            "library": "torch SDPA, the same bool mask, enable_gqa",
            "max_abs_err": errs["decode"], "sm80_max_abs_err": errs["sm80"],
            "bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "achieved_bytes_per_s": nbytes / (ms["decode"] * 1e-3)}


def masked_prefill_timing(fa, flush):
    """The flash forward of generation's masked prefill: B 4, Lq 512, Lk
    576 (the preallocated buffer), GQA 32 / 8, D 128, bf16, the
    `prefill_buffer` mask [1, 1, 512, 576].  The sm90 kernel (the route's
    family) and the sm80 kernel forced, in turns (sm80, sm90, sm90, sm80),
    SDPA with the same mask, and the bound."""
    B, Lq, Lk, H, Hkv, D = 4, 512, 576, 32, 8, 128
    dtype = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn(B, Lq, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Lk, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Lk, Hkv, D, generator=g, device="cuda").to(dtype)
    mask = generation_mask("prefill_buffer", B, Lq, Lk, g)
    route = fa._fwd_route(q, k, v, fa._normalize_mask(mask), dtype)
    assert route == "sm90", route
    rtol, atol = FLASH_FWD_TOL[dtype]
    ref, _ = fa.flash_fwd_plain(q, k, v, mask)
    errs = {}
    for impl in ("sm90", "sm80"):
        d = (fa.flash_fwd_cuda(q, k, v, mask, _impl=impl)[0].float()
             - ref.float()).abs()
        errs[impl] = float(d.max())
        assert bool((d <= atol + rtol * ref.float().abs()).all()), \
            (impl, errs)
    del ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    turns = [(impl, cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, mask,
                                                      _impl=impl), flush,
                            iters=20))
             for impl in ("sm80", "sm90", "sm90", "sm80")]
    ms = {i: sum(t for j, t in turns if j == i) / 2 for i in ("sm80", "sm90")}
    with torch.no_grad():
        library_ms = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask,
                                          enable_gqa=True), flush, iters=20)
    visible = B * H * Lq * (Lq + 1) // 2     # row r sees cols 0 .. r
    nbytes = (2 * q.numel() * 2 + 2 * k.numel() * 2 + mask.numel()
              + B * H * Lq * 4)              # q, o; k, v; mask; lse
    flops = 4 * visible * D
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return {"shape": {"B": B, "Lq": Lq, "Lk": Lk, "H": H, "Hkv": Hkv,
                      "D": D, "mask": "prefill_buffer [1, 1, 512, 576] bool",
                      "dtype": "bfloat16"},
            "family": route, "turns_ms": turns, "ms": ms["sm90"],
            "sm80_ms": ms["sm80"], "sm80_over_sm90": ms["sm80"] / ms["sm90"],
            "library_ms": library_ms,
            "library": "torch SDPA, the same bool mask, enable_gqa",
            "max_abs_err": errs["sm90"], "sm80_max_abs_err": errs["sm80"],
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# ------------------------------------------------------------------- MoE
# GPT-MoE 4.1B: GPT-3 1.3B at full width and depth (hidden 2048, 24
# layers, 16 heads, intermediate 8192, vocab 50304) with a top-2 MoE FFN
# of 8 experts in every other block (GShard's routing and the JAX
# defaults: capacity factor 1.25, aux weight 0.01)
GPT_MOE = dict(num_experts=8, moe_top_k=2, moe_every=2,
               moe_capacity_factor=1.25, moe_aux_weight=0.01)
# E * sum_e(mean prob_e * first-choice share_e) is 1 for a router that
# spreads tokens evenly and approaches E when every token goes to one
# expert with certainty: the band holds each layer's first-step aux off
# zero and below E, which an aux scaled by 1 / E or by E would leave
MOE_AUX_BAND = (0.9, float(GPT_MOE["num_experts"]))
MOE_STAGES = ("moe_route", "moe_dispatch", "moe_experts", "moe_combine")


def gpt_moe(seq, dtype=torch.float32, seed=0, device="cuda", **over):
    """(cfg, model): GPT-MoE 4.1B (or `over` applied) with random weights
    from `seed`, dropout off."""
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM
    cfg = GPTConfig.from_preset("gpt3-1.3B", max_position_embeddings=seq,
                                hidden_dropout=0.0, attention_dropout=0.0,
                                **dict(GPT_MOE, **over))
    model = GPTForCausalLM(
        cfg, device=device, dtype=dtype,
        generator=torch.Generator(device=device).manual_seed(seed))
    return cfg, model


def moe_layers(model):
    from paddle_tpu_torch.incubate import MoELayer
    return [m for m in model.modules() if isinstance(m, MoELayer)]


def active_params(model):
    """The parameters a token passes through: all, less the experts it is
    not routed to (E - top_k of each routed block's w1, b1, w2, b2)."""
    n = sum(p.numel() for p in model.parameters())
    for m in moe_layers(model):
        expert = sum(p.numel() for p in (m.w1, m.b1, m.w2, m.b2))
        n -= expert * (m.num_experts - m.top_k) // m.num_experts
    return n


def moe_stage_ms(prof, steps, attr="self_device_time_total"):
    """Time a step of each MoE stage (`MOE_STAGES`) from a torch.profiler
    run, forward and backward ("_bwd"), in ms.  An op's time (`attr`: the
    device time of the kernels it launched itself, or on the CPU
    `self_cpu_time_total`) goes to the record_function range around it;
    a backward op's to the range of the forward op whose autograd node
    it evaluates (the profiler's sequence numbers tie the two)."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def around(e, test):
        while e is not None and not test(e.name):
            e = e.cpu_parent
        return e

    forward = {}
    for e in events:
        rng = around(e, MOE_STAGES.__contains__)
        if rng is not None and e.sequence_nr >= 0:
            forward[e.sequence_nr] = rng.name
    out = {}
    for e in events:
        t = getattr(e, attr)
        if not t or e.name in MOE_STAGES:
            continue
        rng = around(e, MOE_STAGES.__contains__)
        stage = rng.name if rng is not None else None
        if stage is None:
            node = around(e, lambda n: n.startswith(
                "autograd::engine::evaluate_function"))
            if node is not None and node.sequence_nr in forward:
                stage = forward[node.sequence_nr] + "_bwd"
        if stage is not None:
            out[stage] = out.get(stage, 0.0) + t
    return {k: v / steps / 1e3 for k, v in sorted(out.items())}


def phase_moe_train(steps=10, warmup=3, batch=4, seq=1024):
    """GPT-MoE 4.1B trained as `train` trains GPT-3 1.3B: seq 1024, batch
    4, AMP O2 bf16 without master weights, Adafactor(1e-4), TrainStep,
    gpt_loss_fn with the aux loss; 3 warm-up and 10 timed steps.  The
    first loss (cross entropy plus 0.01 x the aux losses) and each routed
    layer's aux against `plain_first_loss` on the float32 weights; each
    flash kernel 24 times a step on sm90, no plain sdpa; every expert's
    w1 moved.  MFU counts the active parameters (two experts of each
    routed block), not the dispatch and combine.  Then a profile of 2
    steps with the MoE stages named."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import Adafactor
    from paddle_tpu_torch.text import gpt_loss_fn

    t_phase = time.perf_counter()
    cfg, model = gpt_moe(seq)
    layers = moe_layers(model)
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                           device="cuda")
    ref_loss = plain_first_loss(gpt_loss_fn, model, ids, labels)
    ref_aux = [m.aux_loss.item() for m in layers]
    n_params = sum(p.numel() for p in model.parameters())
    n_active = active_params(model)
    opt = Adafactor(learning_rate=1e-4, parameters=model.parameters())
    model, opt = amp.decorate(models=model, optimizers=opt,
                              dtype="bfloat16", master_weight=False)
    step = train_step(model, gpt_loss_fn, opt)
    w1_before = [m.w1.detach()[:, :4].clone() for m in layers]
    release()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, times, aux = [], [], []
    for _ in range(warmup + steps):
        t0 = time.perf_counter()
        losses.append(step(ids, labels).item())     # waits for the card
        times.append(time.perf_counter() - t0)
        aux.append([m.aux_loss.detach().item() for m in layers])
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = [bool((m.w1.detach()[:, :4] != w).flatten(1).any(1).all())
             for m, w in zip(layers, w1_before)]
    timed = np.array(times[warmup:])
    p50 = float(np.percentile(timed, 50))
    flops = train_flops(n_active, cfg, batch, seq)
    aux_err = max(abs(a - r) / r for a, r in zip(aux[0], ref_aux))
    fl = flash_part(counts)
    rec = {"phase": "moe_train", "model": "gpt-moe-4.1B (gpt3-1.3B, "
           "8 experts top-2 every other block)", "layers": cfg.num_layers,
           "routed_layers": len(layers), "experts": cfg.num_experts,
           "top_k": cfg.moe_top_k,
           "capacity_factor": cfg.moe_capacity_factor,
           "seq": seq, "batch": batch, "dtype": "bfloat16",
           "amp": "O2, master_weight=False", "optimizer": "Adafactor(1e-4)",
           "n_params": n_params, "n_active_params": n_active,
           "warmup_steps": warmup, "timed_steps": steps,
           "tokens_per_s": steps * batch * seq / float(timed.sum()),
           "step_p50_ms": p50 * 1e3,
           "step_p99_ms": float(np.percentile(timed, 99)) * 1e3,
           "step_ms": [t * 1e3 for t in times],
           "flops_per_step_active": flops,
           "mfu_active": flops / float(timed.mean()) / BF16_FLOPS,
           "mfu_peak_flops": BF16_FLOPS, "peak_memory_gib": peak,
           "losses": losses, "aux_sum": [sum(a) for a in aux],
           "aux_first_step": aux[0], "aux_first_float32_plain": ref_aux,
           "aux_rel_err": aux_err, "aux_band": MOE_AUX_BAND,
           "first_loss_float32_plain": ref_loss,
           "first_loss_err": abs(losses[0] - ref_loss),
           "first_loss_tol": BF16_FIRST_LOSS_TOL,
           "experts_w1_moved": moved, "launches": counts}
    n = cfg.num_layers * (warmup + steps)
    assert all(np.isfinite(losses)), losses
    assert all(np.isfinite(a) and MOE_AUX_BAND[0] <= a <= MOE_AUX_BAND[1]
               for a in aux[0]), rec
    assert aux_err <= BF16_FIRST_LOSS_TOL, rec
    assert rec["first_loss_err"] <= BF16_FIRST_LOSS_TOL, rec
    assert (fl["fwd"], fl["dkv"], fl["dq"]) == (n, n, n), fl
    assert (fl["fwd_sm90"], fl["dkv_sm90"], fl["dq_sm90"]) == (n, n, n), fl
    assert counts["sdpa_plain"] == 0, counts
    assert all(moved), f"an expert's w1 did not move: {moved}"
    rec["profile"] = moe_train_profile(step, ids, labels, p50)
    rec["phase_seconds"] = time.perf_counter() - t_phase
    emit(rec)
    del step, opt, model, layers
    release()
    return fl


def moe_train_profile(step, ids, labels, step_p50_s, steps=2):
    """`steps` steps under torch.profiler: the busy share against the
    unprofiled p50, device ms by kernel class (cuBLAS GEMMs, flash, the
    rest) and by MoE stage, forward and backward."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(ids, labels)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events, by_name, busy_us = device_time(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    gemm = sum(us for name, us in by_name.items()
               if any(tag in name.lower() for tag in GEMM_TAGS))
    flash = sum(us for name, us in by_name.items() if "flash_" in name)
    total = sum(by_name.values())
    stages = moe_stage_ms(prof, steps)
    busy_ms = busy_us / steps / 1e3
    return {"steps": steps, "device_events": events,
            "profiled_wall_ms_per_step": wall_us / steps / 1e3,
            "unprofiled_step_p50_ms": step_p50_s * 1e3,
            "device_busy_ms_per_step": busy_ms,
            "device_busy_share": busy_ms / (step_p50_s * 1e3),
            "kernel_class_ms_per_step": {
                "gemm": gemm / steps / 1e3, "flash": flash / steps / 1e3,
                "other": (total - gemm - flash) / steps / 1e3},
            "moe_stage_ms_per_step": stages,
            "moe_share_of_busy": sum(stages.values()) / busy_ms,
            "top_device_ms_per_step": [[name[:90], us / steps / 1e3]
                                       for name, us in top]}


def phase_moe_generate(batch=4, prompt=512, new=64):
    """GPT-MoE 4.1B in bf16, batch 4, 512-token prompts, 64 greedy tokens:
    `generate(use_jit=True)` (the decode step captured, routing and all)
    against the uncaptured static step and the first call (identical
    tokens: the same kernels on the same calls) and the eager loop over
    concat caches (its attention sums over another buffer length, so in
    bf16 its tokens may part from the captured ones: the share is
    printed); each path's flash launches by family (decode steps on the
    decode kernel, prefills on sm90, 0 on sm80)."""
    from paddle_tpu_torch.text import decode

    t_phase = time.perf_counter()
    cfg, model = gpt_moe(prompt + new, dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(2)
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                        device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first, build_s = sync_time(lambda: model.generate(ids,
                                                      max_new_tokens=new))
    zero_counts()
    captured, cap_s = sync_time(lambda: model.generate(ids,
                                                       max_new_tokens=new))
    paths = {"captured": read_counts()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    key = (prompt, new, False, 1.0, None, None, None, batch)
    prog = model._jit_decode_cache[key]
    assert prog.graph is not None, "the decode step was not captured"
    _, prefill_s = sync_time(lambda: prog.prefill(ids))
    cap_steps = step_ms(prog.step, new - 1)

    zero_counts()
    eager, eager_s = sync_time(lambda: model.generate(ids, max_new_tokens=new,
                                                      use_jit=False))
    paths["eager"] = read_counts()
    zero_counts()
    static, static_s = sync_time(lambda: decode.jit_generate(
        model, ids, max_new_tokens=new, _capture=False))
    paths["static"] = read_counts()
    prog = model._jit_decode_cache[key]
    prog.prefill(ids)
    static_steps = step_ms(prog.step, new - 1)
    model._jit_decode_cache.clear()
    del prog
    families = {name: {"flash_fwd_sm80": c["flash_fwd"] - c["flash_fwd_sm90"]
                       - c["flash_fwd_decode"] - c["flash_fwd_fp32"],
                       "flash_fwd_sm90": c["flash_fwd_sm90"],
                       "flash_fwd_decode": c["flash_fwd_decode"],
                       "sdpa_plain_calls": c["sdpa_plain"]}
                for name, c in paths.items()}
    tok = batch * new
    rec = {"phase": "moe_generate", "model": "gpt-moe-4.1B",
           "dtype": "bfloat16", "layers": cfg.num_layers,
           "n_params": sum(p.numel() for p in model.parameters()),
           "batch": batch, "prompt_tokens": prompt, "new_tokens": new,
           "captured": {"tokens_per_s": tok / cap_s, "wall_s": cap_s,
                        "first_call_s": build_s,
                        "decode_tokens_per_s": batch * 1e3
                        / pct(cap_steps)["p50"],
                        "step_ms": pct(cap_steps)},
           "eager": {"tokens_per_s": tok / eager_s, "wall_s": eager_s},
           "static_uncaptured": {"tokens_per_s": tok / static_s,
                                 "wall_s": static_s,
                                 "step_ms": pct(static_steps)},
           "prefill_ms": prefill_s * 1e3, "peak_memory_gib": peak,
           "tokens_equal": {
               "captured_vs_first_call": bool(torch.equal(first, captured)),
               "captured_vs_static": bool(torch.equal(captured, static)),
               "captured_vs_eager_share": float(
                   (captured == eager)[:, prompt:].float().mean()),
               # each row's first new token where the eager loop parts
               "captured_vs_eager_first_difference": [
                   int(row.nonzero()[0]) if row.any() else None
                   for row in (captured != eager)[:, prompt:].cpu()]},
           "launches": paths, "flash_families": families}
    n = new * cfg.num_layers
    for name, c in paths.items():
        fam = families[name]
        assert c["sdpa_plain"] == 0, (name, c)
        assert fam["flash_fwd_sm80"] == 0, (name, fam)
        # the prefill once a layer on sm90, each of the new - 1 steps once
        # a layer on the decode kernel
        assert fam["flash_fwd_sm90"] == cfg.num_layers, (name, fam)
        assert fam["flash_fwd_decode"] == n - cfg.num_layers, (name, fam)
    assert torch.equal(first, captured), rec["tokens_equal"]
    assert torch.equal(captured, static), rec["tokens_equal"]
    rec["phase_seconds"] = time.perf_counter() - t_phase
    emit(rec)
    del model, first, captured, eager, static
    release()
    return {f"moe_generate/{n}": flash_part(c) for n, c in paths.items()}


def phase_moe_serve():
    """GPT-MoE 4.1B bf16 served by LLMEngine with serve's request mix (16
    requests, prompts of 128 to 1024 tokens, 32 greedy tokens each):
    every request finishes, no pool leak, the paged kernel once a layer
    a decode step, no plain sdpa.  The served tokens are not held to a
    dense forward: at E 8, top-2 a choice can drop because of the other
    tokens of its step (ROADMAP.md C), which a dense forward does not
    reproduce; moe_e2e holds the engine where nothing drops."""
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.serving import LLMEngine

    t_phase = time.perf_counter()
    cfg, model = gpt_moe(2048, dtype=torch.bfloat16)
    eng = LLMEngine(model, num_blocks=2048, block_size=16, max_running=16,
                    prefill_chunk=512)
    rng = np.random.default_rng(0)
    plens = rng.integers(128, 1025, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in plens]
    eng.generate_batch([prompts[0][:64]], max_new_tokens=2)    # warm-up

    reg = metrics.registry()
    reg.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, max_new_tokens=32) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    steps = reg.counter("serving_decode_steps_total").value
    step_s = reg.histogram("serving_decode_step_seconds")
    ttft = reg.histogram("serving_ttft_seconds")
    tokens = sum(len(r.generated) for r in reqs)
    reasons = sorted({r.finish_reason for r in reqs})
    peak = torch.cuda.max_memory_allocated() / 2**30
    leaks = eng.close()
    rec = {"phase": "moe_serve", "model": "gpt-moe-4.1B",
           "dtype": "bfloat16", "layers": cfg.num_layers,
           "requests": len(reqs), "prompt_tokens": int(plens.sum()),
           "output_tokens": tokens, "wall_s": wall,
           "output_tokens_per_s": tokens / wall, "decode_steps": steps,
           "decode_step_p50_ms": step_s.percentile(50) * 1e3,
           "decode_step_p99_ms": step_s.percentile(99) * 1e3,
           "ttft_p50_s": ttft.percentile(50),
           "ttft_p99_s": ttft.percentile(99), "peak_memory_gib": peak,
           "launches": counts, "paged_kernel_launches": counts["paged_decode"],
           "finish_reasons": reasons, "leaks": leaks,
           "phase_seconds": time.perf_counter() - t_phase}
    emit(rec)
    assert reasons == ["length"], f"requests finished with {reasons}"
    assert leaks == ([], []), f"pool leaks {leaks}"
    assert counts["paged_decode"] == steps * cfg.num_layers and steps > 0, \
        f"{counts['paged_decode']} paged launches for {steps} decode steps"
    assert counts["sdpa_plain"] == 0, counts
    del eng, model
    release()
    return counts["paged_decode"]


def router_gaps(model):
    """Forward pre-hooks on each MoELayer of `model` that keep the
    smallest gap between a token's first and second router probability
    and between its second and third (the margins its two argmax
    choices are made by) over every call; returns the list they update
    and the hook handles."""
    gaps = [float("inf")]

    def hook(mod, args):
        x = args[0].detach().reshape(-1, args[0].shape[-1]).float()
        p = torch.softmax(x @ mod.gate_weight.detach().float(), -1)
        top = p.topk(mod.top_k + 1, dim=-1).values
        gaps[0] = min(gaps[0], float((top[:, :-1] - top[:, 1:]).min()))

    return gaps, [m.register_forward_pre_hook(hook)
                  for m in moe_layers(model)]


def phase_moe_e2e(steps=3, batch=2, seq=128, new=16):
    """GPT-MoE at full width, 2 layers, float32, E 4, top-2, a routed FFN
    in each block (eval capacity = n, so nothing drops in eval): 3 AdamW
    steps on the card against the CPU (the losses with aux, the final
    parameters); LLMEngine tokens against a dense teacher-forced forward
    on the CPU; the captured jit_generate on the card token for token
    against the CPU, and the eager loop on the card against both.  The
    smallest router probability gap the CPU model
    met is printed: a flip there would be float32 rounding, not a
    fault."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.serving import LLMEngine
    from paddle_tpu_torch.text import decode, generate, gpt_loss_fn

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    over = dict(num_layers=2, num_experts=4, moe_every=1)
    cfg, card = gpt_moe(512, seed=4, **over)
    _, cpu = gpt_moe(512, seed=4, device="cpu", **over)
    cpu.load_state_dict(card.state_dict())
    init = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    gaps, hooks = router_gaps(cpu)
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))

    def train(model, dev):
        step = train_step(model, gpt_loss_fn,
                          AdamW(learning_rate=1e-4, weight_decay=0.01,
                                parameters=model.parameters()))
        return [step(ids.to(dev), labels.to(dev)).item()
                for _ in range(steps)]

    zero_counts()
    card_losses = train(card, "cuda")
    counts = read_counts()
    t0 = time.perf_counter()
    cpu_losses = train(cpu, "cpu")
    cpu_train_s = time.perf_counter() - t0
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                       cpu_losses))
    num = den = 0.0
    card_params = dict(card.named_parameters())
    for n, p in cpu.named_parameters():
        num += float((card_params[n].detach().cpu() - p.detach())
                     .double().square().sum())
        den += float((p.detach() - init[n]).double().square().sum())
    param_err = (num / den) ** 0.5
    train_counts = flash_part(counts)
    n = steps * cfg.num_layers
    assert train_counts == {"fwd": n, "dkv": n, "dq": n, "fwd_sm90": 0,
                            "dkv_sm90": 0, "dq_sm90": 0, "fwd_decode": 0,
                            "fwd_fp32": n, "dkv_fp32": n,
                            "dq_fp32": n}, train_counts
    assert counts["sdpa_plain"] == 0, counts

    # the engine (paged decode kernel in float32) against a dense
    # teacher-forced forward of the same (trained) weights on the CPU
    cpu.load_state_dict(card.state_dict())
    zero_counts()
    eng = LLMEngine(card, num_blocks=256, block_size=16, max_running=4,
                    prefill_chunk=128)
    prompts = [rng.integers(0, cfg.vocab_size, size=k).tolist()
               for k in (17, 90, 200, 301)]
    outs = eng.generate_batch(prompts, max_new_tokens=8)
    leaks = eng.close()
    engine_counts = read_counts()
    cpu.eval()
    worst = 0.0
    for prompt, gen in zip(prompts, outs):
        with torch.no_grad():
            logits = cpu(torch.tensor([prompt + gen[:-1]]))[
                0, len(prompt) - 1:]
        chosen = logits[torch.arange(len(gen)), torch.tensor(gen)]
        worst = max(worst, float((logits.max(-1).values - chosen).max()))

    # the captured decode step on the card against the CPU
    gids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
    zero_counts()
    on_card = decode.jit_generate(card, gids.cuda(), max_new_tokens=new)
    gen_counts = read_counts()
    key = (seq, new, False, 1.0, None, None, None, batch)
    captured = card._jit_decode_cache[key].graph is not None
    on_card = on_card.cpu()
    zero_counts()
    eager = generate(card, gids.cuda(), max_new_tokens=new).cpu()
    eager_counts = read_counts()
    t0 = time.perf_counter()
    on_cpu = decode.jit_generate(cpu, gids, max_new_tokens=new)
    cpu_gen_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    rec = {"phase": "moe_e2e", "model": "gpt-moe width, 2 layers, E 4, "
           "top-2, every block routed", "dtype": "float32",
           "optimizer": "AdamW(1e-4, wd 0.01)", "batch": batch, "seq": seq,
           "steps": steps, "card_losses": card_losses,
           "cpu_losses": cpu_losses, "loss_max_rel_err": loss_err,
           "loss_tol": 1e-5, "param_rel_err": param_err, "param_tol": 1e-3,
           "cpu_train_seconds": cpu_train_s,
           "engine_tokens_checked": sum(len(g) for g in outs),
           "engine_max_logit_gap": worst, "engine_tol": 1e-4,
           "engine_leaks": leaks,
           "jit_generate_card_equals_cpu": bool(torch.equal(on_card,
                                                            on_cpu)),
           "eager_card_equals_jit_generate": bool(torch.equal(eager,
                                                              on_card)),
           "step_captured": captured, "cpu_generate_seconds": cpu_gen_s,
           "router_min_prob_gap": gaps[0],
           "launches": {"train": train_counts, "engine": engine_counts,
                        "jit_generate": gen_counts, "eager": eager_counts},
           "phase_seconds": time.perf_counter() - t_phase}
    emit(rec)
    assert loss_err <= 1e-5, f"card and CPU losses differ by {loss_err}"
    assert param_err <= 1e-3, f"card and CPU parameters differ: {param_err}"
    assert leaks == ([], []), leaks
    assert worst <= 1e-4, \
        f"an engine token sits {worst} below the CPU maximum logit"
    steps_run = engine_counts["paged_decode"]
    assert steps_run > 0 and steps_run % cfg.num_layers == 0, engine_counts
    assert captured, "the decode step was not captured"
    assert torch.equal(on_card, on_cpu), "card and CPU tokens differ"
    assert torch.equal(eager, on_card), "eager and captured tokens differ"
    for c in (gen_counts, eager_counts):
        assert c["sdpa_plain"] == 0 and \
            c["flash_fwd_fp32"] == cfg.num_layers and \
            c["flash_fwd_decode"] == (new - 1) * cfg.num_layers, c
    del card, cpu, eng
    release()
    return {"moe_e2e": train_counts,
            "moe_e2e/jit_generate": flash_part(gen_counts),
            "moe_e2e/eager": flash_part(eager_counts)}, steps_run


# ------------------------------------------------- Transformer-base MT
# Vaswani et al. 2017, Table 3 "base": d_model 512, 8 heads, 6 + 6
# layers, d_inner 2048, dropout 0.1; a shared source-target vocabulary of
# ~37,000 BPE tokens (WMT14 En-De, their 5.1), so the embedding is tied
MT_BASE = dict(src_vocab_size=37000, trg_vocab_size=37000, max_length=256,
               d_model=512, n_head=8, num_encoder_layers=6,
               num_decoder_layers=6, d_inner_hid=2048, dropout=0.1,
               weight_sharing=True)
MT_PAD = 2                  # bos 0, eos 1 (the model's defaults), pad 2
MT_E2E_LOSS_TOL = 1e-5
MT_E2E_PARAM_TOL = 1e-3


def mt_batch(batch, src_len, trg_len, vocab, seed, device):
    """Source ids with rows padded (MT_PAD) to ragged lengths from
    src_len / 2 to src_len, and targets of trg_len tokens starting with
    bos: ids from numpy's generator, no pad or special id inside."""
    rng = np.random.default_rng(seed)
    src = rng.integers(3, vocab, (batch, src_len))
    lens = rng.integers(src_len // 2, src_len + 1, batch)
    src[np.arange(src_len)[None, :] >= lens[:, None]] = MT_PAD
    trg = rng.integers(3, vocab, (batch, trg_len))
    trg[:, 0] = 0
    return (torch.from_numpy(src).to(device), torch.from_numpy(trg).to(
        device), lens)


def mt_model(device, seed, **over):
    from paddle_tpu_torch.text import TransformerModel
    g = torch.Generator(device=device).manual_seed(seed)
    return TransformerModel(**dict(MT_BASE, **over), device=device,
                            generator=g)


def mt_optimizer(model, learning_rate):
    """Adam with the paper's beta2 0.98 and epsilon 1e-9 (their 5.3)."""
    from paddle_tpu_torch.optimizer import Adam
    return Adam(learning_rate=learning_rate, beta1=0.9, beta2=0.98,
                epsilon=1e-9, parameters=model.parameters())


def mt_loss_o1(model, src, trg):
    """The label-smoothed loss (0.1, their 5.4) under AMP O1 bf16."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text import transformer_mt_loss
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        return transformer_mt_loss(model, src, trg, 0.1, pad_id=MT_PAD)


def mt_depth(model):
    """(encoder layers, decoder layers)."""
    enc = len(model.transformer.encoder.layers)
    dec = len(model.transformer.decoder.layers)
    return enc, dec


def phase_mt_train(steps=10, warmup=3, batch=32, src_len=128, trg_len=97):
    """Transformer-base MT (`MT_BASE`, random weights from seed 0) trained
    as the paper trains it: AMP O1 bf16 over float32 parameters, Adam
    (beta2 0.98, epsilon 1e-9) under NoamDecay(512, 4000), label
    smoothing 0.1, through TrainStep; 32 sources of 128 tokens padded to
    ragged lengths and 32 targets of 97 (96 fed).  3 warm-up and 10 timed
    steps, timed before any profile: step p50 / p99, tokens/s (source
    and target positions), peak memory, losses; every step launches the
    sm90 forward, dK/dV and dQ 18 times (6 encoder self-attentions under
    the padding mask, 6 decoder self-attentions under the additive
    causal mask, 6 cross-attentions, Lq 96 against Lk 128, under the
    padding mask), sdpa its plain path no time.  Then a profile of 3
    steps (the busy share).  Returns ({path: flash counts}, the model,
    the sources)."""
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import lr as lr_sched

    model = mt_model("cuda", 0)
    src, trg, lens = mt_batch(batch, src_len, trg_len,
                              MT_BASE["src_vocab_size"], 0, "cuda")
    sched = lr_sched.NoamDecay(MT_BASE["d_model"], 4000)
    step = train_step(model, mt_loss_o1, mt_optimizer(model, sched))
    enc, dec = mt_depth(model)
    per_step = enc + 2 * dec

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, times = [], []
    for _ in range(warmup + steps):
        t0 = time.perf_counter()
        losses.append(step(src, trg).item())          # waits for the card
        times.append(time.perf_counter() - t0)
        sched.step()
    counts = read_counts()
    timed = np.array(times[warmup:])
    p50 = float(np.percentile(timed, 50))
    positions = batch * (src_len + trg_len - 1)
    rec = {"phase": "mt_train", "model": "transformer-base (Vaswani et "
           "al. 2017, Table 3), shared 37000 vocabulary, tied embedding",
           "config": MT_BASE, "batch": batch, "src_len": src_len,
           "trg_len": trg_len, "src_rows": lens.tolist(),
           "dtype": "float32 parameters, AMP O1 bf16",
           "optimizer": "Adam(beta2 0.98, eps 1e-9), NoamDecay(512, 4000)",
           "label_smoothing": 0.1,
           "n_params": sum(p.numel() for p in model.parameters()),
           "warmup_steps": warmup, "timed_steps": steps,
           "step_p50_ms": p50 * 1e3,
           "step_p99_ms": float(np.percentile(timed, 99)) * 1e3,
           "step_ms": [t * 1e3 for t in times],
           "tokens_per_s": steps * positions / float(timed.sum()),
           "target_tokens_per_s": steps * batch * (trg_len - 1)
           / float(timed.sum()),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "losses": losses, "launches": counts}
    n = per_step * (warmup + steps)
    fl = flash_part(counts)
    assert all(np.isfinite(losses)), losses
    assert (fl["fwd"], fl["dkv"], fl["dq"]) == (n, n, n), fl
    assert (fl["fwd_sm90"], fl["dkv_sm90"], fl["dq_sm90"]) == (n, n, n), fl
    assert counts["sdpa_plain"] == 0, counts
    rec["profile"] = busy(lambda: step(src, trg), 3, p50 * 1e3)
    emit(rec)
    del step
    release()
    return {"mt_train": fl}, model, src


def phase_mt_generate(model, src, new=64):
    """mt_train's model cast to bf16 greedy-decodes up to `new` tokens for
    its 32 sources (`TransformerModel.generate`: the encoder once, then a
    step a token through the concat self-attention caches and the
    memory's StaticCache): 6 sm90 forwards for the encoder under the
    padding mask, and each decode step 12 decode-kernel launches (6
    unmasked self-attentions, 6 cross-attentions under the mask, Lq 1),
    none on sm80, sdpa's plain path never.  A second call times each
    step (a synchronize at each decoder call) for the step p50.  The
    tokens start with bos and lie in the vocabulary.  Returns {path:
    flash counts}."""
    model.astype("bfloat16")
    model.eval()
    enc, dec = mt_depth(model)
    zero_counts()
    out, wall_s = sync_time(lambda: model.generate(
        src, max_length=new, src_pad_id=MT_PAD))
    counts = read_counts()
    steps = out.shape[1] - 1
    fl = flash_part(counts)
    stamps = []

    def stamp(layer, args):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    handle = model.transformer.decoder.register_forward_pre_hook(stamp)
    again = model.generate(src, max_length=new, src_pad_id=MT_PAD)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    handle.remove()
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    b = src.shape[0]
    rec = {"phase": "mt_generate", "model": "transformer-base, bf16",
           "batch": b, "src_len": src.shape[1], "max_new_tokens": new,
           "decode_steps": steps, "wall_s": wall_s,
           "tokens_per_s": b * steps / wall_s,
           "step_ms": pct(step_ms), "launches": counts,
           "same_tokens_second_call": bool(torch.equal(out, again))}
    emit(rec)
    V = MT_BASE["trg_vocab_size"]
    assert out.shape == (b, steps + 1) and 1 <= steps <= new, out.shape
    assert bool((out[:, 0] == model.bos_id).all()), out[:, 0]
    assert bool(((out >= 0) & (out < V)).all())
    assert fl["fwd_sm90"] == enc, fl
    assert fl["fwd_decode"] == 2 * dec * steps, fl
    assert fl["fwd"] == enc + 2 * dec * steps, fl
    assert (fl["dkv"], fl["dq"]) == (0, 0), fl
    assert counts["sdpa_plain"] == 0, counts
    return {"mt_generate": fl}


def phase_mt_e2e(steps=3, batch=8, src_len=64, trg_len=33, layers=2,
                 new=16):
    """Transformer-base width at 2 + 2 layers, float32 (TF32 off), dropout
    0, the 37000 tied vocabulary: 3 Momentum steps (lr 0.01, 0.9) and a
    16-token greedy decode on the card (the fp32 forward, dK/dV and dQ in
    training, the decode kernel at each decode step) against the same on
    the CPU (the plain versions), from the same weights and batch: losses
    within MT_E2E_LOSS_TOL, parameters within MT_E2E_PARAM_TOL of how far
    they moved (the key projections' biases apart: their gradient is zero
    in exact arithmetic), greedy tokens equal.  Momentum, not the
    recipe's Adam: Adam's first steps move every parameter by about its
    rate whatever its gradient's size, so a weight whose gradient only
    rounding sets moves as far as any other, in a direction the rounding
    picks (with Adam, eps 1e-9, the card and the CPU ended 3.1e-3 of the
    distance moved apart).  Returns {path: flash counts}."""
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.text import transformer_mt_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    over = dict(num_encoder_layers=layers, num_decoder_layers=layers,
                dropout=0.0)
    card = mt_model("cuda", 3, **over)
    cpu = mt_model("cpu", 3, **over)
    cpu.load_state_dict(card.state_dict())
    init = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    src, trg, lens = mt_batch(batch, src_len, trg_len,
                              MT_BASE["src_vocab_size"], 3, "cpu")

    def loss_fn(model, s, t):
        return transformer_mt_loss(model, s, t, 0.1, pad_id=MT_PAD)

    def run(model, dev):
        step = train_step(model, loss_fn, Momentum(
            learning_rate=0.01, momentum=0.9,
            parameters=model.parameters()))
        s, t = src.to(dev), trg.to(dev)
        losses = [step(s, t).item() for _ in range(steps)]
        out = model.generate(s, max_length=new, src_pad_id=MT_PAD)
        return losses, out.cpu()

    zero_counts()
    card_losses, card_out = run(card, "cuda")
    counts = read_counts()
    t0 = time.perf_counter()
    cpu_losses, cpu_out = run(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    fl = flash_part(counts)
    decode_steps = card_out.shape[1] - 1
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                       cpu_losses))
    perr = param_error(card, cpu, init, skip="k_proj.bias")
    emit({"phase": "mt_e2e", "model": f"transformer-base width, {layers} + "
          f"{layers} layers, tied 37000 vocabulary", "dtype": "float32",
          "optimizer": "Momentum(0.01, 0.9)", "batch": batch,
          "src_len": src_len, "trg_len": trg_len, "steps": steps,
          "src_rows": lens.tolist(), "card_losses": card_losses,
          "cpu_losses": cpu_losses, "loss_max_rel_err": loss_err,
          "loss_tol": MT_E2E_LOSS_TOL, "param_rel_err": perr,
          "param_tol": MT_E2E_PARAM_TOL,
          "k_proj_bias_rel_err": param_error(card, cpu, init,
                                             only="k_proj.bias"),
          "decode_steps": decode_steps,
          "tokens_equal": bool(torch.equal(card_out, cpu_out)),
          "cpu_seconds": cpu_s, "launches": counts})
    attn = 3 * layers                   # enc self, dec self, cross a step
    assert loss_err <= MT_E2E_LOSS_TOL, \
        f"card and CPU losses differ by {loss_err}"
    assert perr <= MT_E2E_PARAM_TOL, f"card and CPU parameters differ: {perr}"
    assert torch.equal(card_out, cpu_out), (card_out, cpu_out)
    assert fl["fwd_fp32"] == attn * steps + layers, fl
    assert (fl["dkv_fp32"], fl["dq_fp32"]) == (attn * steps,) * 2, fl
    assert fl["fwd_decode"] == 2 * layers * decode_steps, fl
    assert fl["fwd"] == fl["fwd_fp32"] + fl["fwd_decode"], fl
    assert counts["sdpa_plain"] == 0, counts
    del card, cpu
    release()
    return {"mt_e2e": fl}


# ---------------------------------------------------- the high-level API
# Model.fit over io.DataLoader worker processes (hapi_bert, hapi_resnet).
# The datasets are classes of this module, so that a worker process finds
# them by name (the standard pickle; the worker imports this script).
HAPI_TOKEN_LOW = 1000       # token ids from here up: BERT keeps the rest
IMAGENET_MEAN = [0.485, 0.456, 0.406]
IMAGENET_STD = [0.229, 0.224, 0.225]


class HapiSequences:
    """`n` token sequences of 16 to `seq` tokens (the rest padding, id 0)
    drawn with numpy from `seed`; the label is 1 when the first token lies
    in the upper half of the ids drawn from, so a classifier can learn it.
    `labels=False` yields the inputs alone (what `predict` takes)."""

    def __init__(self, n, seq, vocab, seed, labels=True):
        rng = np.random.RandomState(seed)
        lens = rng.randint(16, seq + 1, n)
        self.mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int64)
        self.ids = rng.randint(HAPI_TOKEN_LOW, vocab, (n, seq)) * self.mask
        self.labels = (self.ids[:, 0] >= (HAPI_TOKEN_LOW + vocab) // 2
                       ).astype(np.int64)
        self.with_labels = labels

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        if self.with_labels:
            return self.ids[i], self.mask[i], self.labels[i]
        return self.ids[i], self.mask[i]


class HapiImages:
    """`n` uint8 HWC images of `size` x `size` x 3 made from the index (a
    random tile from `seed`, rolled by the index along both axes), each
    through `transform`; the label is index % `classes`."""

    def __init__(self, n, size=224, classes=1000, seed=0, transform=None):
        self.n, self.classes, self.transform = n, classes, transform
        self.base = np.random.RandomState(seed).randint(
            0, 256, (size, size, 3)).astype(np.uint8)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        img = np.roll(self.base, (i, 7 * i), axis=(0, 1))
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(i % self.classes)


def hapi_bert_classifier(cfg, device, generator):
    """The user's network: BertForSequenceClassification (2 classes) in a
    Layer whose forward(ids, mask) passes the padding mask."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.text import BertForSequenceClassification

    class BertClassifier(nn.Layer):
        def __init__(self):
            super().__init__()
            self.bert = BertForSequenceClassification(
                cfg, num_classes=2, device=device, generator=generator)

        def forward(self, ids, mask):
            return self.bert(ids, attention_mask=mask)

    return BertClassifier()


def hapi_recorders():
    """(StepClock, LossLog): callbacks that keep each train batch's begin
    and end times, and each logged loss."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class StepClock(Callback):
        def __init__(self):
            self.begin, self.end = [], []

        def on_train_batch_begin(self, step, logs=None):
            self.begin.append(time.perf_counter())

        def on_train_batch_end(self, step, logs=None):
            self.end.append(time.perf_counter())

    class LossLog(Callback):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            if logs and "loss" in logs:
                self.losses.append(logs["loss"])

    return StepClock, LossLog


def hapi_fp32_check(seed, steps=3, batch=32, seq=128, layers=2):
    """The hapi_bert workflow in float32 at 2 layers (TF32 off, dropout
    0): Model.fit for 3 steps and evaluate, on the card (process workers,
    the staging reader; fp32 flash kernels) and on the CPU (in-process
    loader, plain attention), from the same weights and batches."""
    from paddle_tpu_torch import io, metric, nn
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text import BertConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = BertConfig(num_hidden_layers=layers, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    card = hapi_bert_classifier(
        cfg, "cuda", torch.Generator(device="cuda").manual_seed(seed))
    cpu = hapi_bert_classifier(cfg, "cpu", None)
    cpu.load_state_dict(card.state_dict())
    train = HapiSequences(steps * batch, seq, cfg.vocab_size, seed + 2)
    evals = HapiSequences(2 * batch, seq, cfg.vocab_size, seed + 3)
    _, LossLog = hapi_recorders()

    def run(net, dev, workers):
        model = Model(net).prepare(
            AdamW(learning_rate=1e-4, parameters=net.parameters()),
            nn.CrossEntropyLoss(), metric.Accuracy())
        log = LossLog()
        np.random.seed(seed)
        model.fit(io.DataLoader(train, places=dev, batch_size=batch,
                                shuffle=True, num_workers=workers),
                  epochs=1, log_freq=1, verbose=0, callbacks=[log])
        acc = model.evaluate(io.DataLoader(evals, places=dev,
                                           batch_size=batch),
                             verbose=0)["acc"]
        return log.losses, acc

    zero_counts()
    card_losses, card_acc = run(card, "cuda", 2)
    counts = read_counts()
    t0 = time.perf_counter()
    cpu_losses, cpu_acc = run(cpu, "cpu", 0)
    cpu_s = time.perf_counter() - t0
    err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    rec = {"layers": layers, "steps": steps, "batch": batch,
           "card_losses": card_losses, "cpu_losses": cpu_losses,
           "loss_max_rel_err": err, "loss_tol": 1e-5,
           "card_acc": card_acc, "cpu_acc": cpu_acc, "cpu_seconds": cpu_s,
           "launches": counts}
    n_fwd = layers * (steps + len(evals) // batch)
    assert flash_part(counts) == {
        "fwd": n_fwd, "dkv": layers * steps, "dq": layers * steps,
        "fwd_sm90": 0, "dkv_sm90": 0, "dq_sm90": 0, "fwd_decode": 0,
        "fwd_fp32": n_fwd, "dkv_fp32": layers * steps,
        "dq_fp32": layers * steps}, rec
    assert counts["sdpa_plain"] == 0, rec
    assert len(card_losses) == len(cpu_losses) == steps, rec
    assert err <= 1e-5, rec
    assert card_acc == cpu_acc, rec
    del card, cpu
    release()
    return rec, flash_part(counts)


def phase_hapi_bert(seed=0, n_train=2048, n_eval=256, batch=32, seq=128,
                    workers=4, log_freq=8):
    """BERT-base (BertConfig(), 2 classes, bf16 through amp.decorate with
    master_weight=False, AdamW under LinearWarmup(PolynomialDecay))
    fine-tuned as examples/finetune_bert_cls.py does it, through the
    high-level API: Model.prepare(opt, CrossEntropyLoss, Accuracy) and fit
    over an io.DataLoader of 2,048 ragged sequences (batch 32, shuffled,
    4 worker processes through the shared-memory ring, the pinned
    staging reader) with 256 for evaluation, one epoch, MetricsLogger,
    EarlyStopping, LRScheduler(by_step) and a save_dir; then evaluate,
    predict, save, and load into a fresh Model (its predictions bit-equal);
    BERT-base built under LazyGuard against the eager build; and the
    float32 workflow at 2 layers on the card against the CPU.  Each
    training step launches the sm90 forward, dK/dV and dQ 12 times, each
    evaluation or prediction batch the forward 12 times; sdpa takes its
    plain path no time, no loader falls back to threads."""
    import tempfile

    from paddle_tpu_torch import amp, io, metric, nn
    from paddle_tpu_torch import seed as seed_all
    from paddle_tpu_torch.framework.lazy import LazyGuard
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import (EarlyStopping, LRScheduler,
                                                 MetricsLogger)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as lr_sched
    from paddle_tpu_torch.text import (BertConfig,
                                       BertForSequenceClassification)

    cfg = BertConfig()
    L, steps = cfg.num_hidden_layers, n_train // batch
    n_eval_batches = n_eval // batch
    train = HapiSequences(n_train, seq, cfg.vocab_size, seed)
    evals = HapiSequences(n_eval, seq, cfg.vocab_size, seed + 1)
    tests = HapiSequences(n_eval, seq, cfg.vocab_size, seed + 1,
                          labels=False)
    fallbacks = sum(io.fallback_counts.values())

    def build(gen_seed):
        net = hapi_bert_classifier(
            cfg, "cuda", torch.Generator(device="cuda").manual_seed(gen_seed))
        sched = lr_sched.LinearWarmup(
            lr_sched.PolynomialDecay(5e-5, decay_steps=steps,
                                     end_lr=5e-6),
            warmup_steps=4, start_lr=0.0, end_lr=5e-5)
        opt = AdamW(learning_rate=sched, weight_decay=0.01,
                    parameters=net.parameters())
        net, opt = amp.decorate(models=net, optimizers=opt,
                                dtype="bfloat16", master_weight=False)
        return Model(net).prepare(opt, nn.CrossEntropyLoss(),
                                  metric.Accuracy())

    model = build(seed)
    logger = MetricsLogger(batch_size=batch)
    clock = hapi_recorders()[0]()
    with tempfile.TemporaryDirectory(prefix="hapi_bert_") as tmp:
        np.random.seed(seed)
        loader = io.DataLoader(train, batch_size=batch, shuffle=True,
                               num_workers=workers)
        eval_loader = io.DataLoader(evals, batch_size=batch,
                                    num_workers=workers)
        test_loader = io.DataLoader(tests, batch_size=batch,
                                    num_workers=workers)
        release()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        history = model.fit(
            loader, eval_loader, epochs=1, log_freq=log_freq,
            save_dir=os.path.join(tmp, "fit"), save_freq=2, verbose=0,
            callbacks=[logger, clock,
                       EarlyStopping(monitor="acc", mode="max", patience=1,
                                     save_best_model=False),
                       LRScheduler(by_step=True)])
        fit_s = time.perf_counter() - t0
        fit_counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        zero_counts()
        ev = model.evaluate(eval_loader, verbose=0)
        pred = model.predict(test_loader, stack_outputs=True)[0]
        ep_counts = read_counts()
        t0 = time.perf_counter()
        model.save(os.path.join(tmp, "saved"))
        save_s = time.perf_counter() - t0
        fresh = build(seed + 7)
        t0 = time.perf_counter()
        fresh.load(os.path.join(tmp, "saved"))
        load_s = time.perf_counter() - t0
        pred2 = fresh.predict(test_loader, stack_outputs=True)[0]
        checkpointed = sorted(os.listdir(os.path.join(tmp, "fit")))
    logs = history[0]
    del model, fresh
    release()

    # LazyGuard: BERT-base on the meta device, materialised on the card
    seed_all(seed)
    t0 = time.perf_counter()
    eager = BertForSequenceClassification(cfg, num_classes=2, device="cuda")
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    rng_eager = torch.cuda.get_rng_state()
    seed_all(seed)
    t0 = time.perf_counter()
    with LazyGuard():
        lazy = BertForSequenceClassification(cfg, num_classes=2,
                                             device="cuda")
    torch.cuda.synchronize()
    lazy_s = time.perf_counter() - t0
    rng_lazy = torch.cuda.get_rng_state()
    sd_e, sd_l = eager.state_dict(), lazy.state_dict()
    lazy_equal = list(sd_e) == list(sd_l) and all(
        torch.equal(sd_e[k], sd_l[k]) and sd_l[k].device.type == "cuda"
        for k in sd_e)
    del eager, lazy, sd_e, sd_l
    release()

    fp32, fp32_counts = hapi_fp32_check(seed)
    fl, fl_ep = flash_part(fit_counts), flash_part(ep_counts)
    rec = {"phase": "hapi_bert", "model": "bert-base (BertConfig())",
           "layers": L, "batch": batch, "seq": seq, "dtype": "bfloat16",
           "amp": "amp.decorate, master_weight=False",
           "optimizer": "AdamW(LinearWarmup(PolynomialDecay(5e-5)))",
           "train_sequences": n_train, "eval_sequences": n_eval,
           "steps": steps, "workers": workers, "log_freq": log_freq,
           "fit_seconds": fit_s, "history": history,
           "sequences_per_s": logs.get("samples_per_s"),
           # from the first log boundary's read of the loss (the card done
           # with step log_freq) to the last one's: the workers' start and
           # the first steps left out
           "sequences_per_s_after_first_log": (steps - log_freq) * batch
           / (clock.end[-1] - clock.end[log_freq - 1]),
           "step_p50_ms": logs["step_time_p50"] * 1e3,
           "step_p99_ms": logs["step_time_p99"] * 1e3,
           "bert_phase_step_p50_ms": PHASE_NOTES.get("bert_step_p50_ms"),
           "data_wait_share": logs.get("data_wait_share"),
           "data_wait_p50_ms": logs["data_wait_p50"] * 1e3,
           "data_wait_p99_ms": logs["data_wait_p99"] * 1e3,
           "peak_memory_gib": peak / 2**30,
           "eval": ev, "fit_eval_acc": logs.get("eval_acc"),
           "launches_fit": fit_counts, "launches_eval_predict": ep_counts,
           "thread_fallbacks": sum(io.fallback_counts.values()) - fallbacks,
           "predictions_bit_equal_after_load": bool(np.array_equal(pred,
                                                                   pred2)),
           "save_seconds": save_s, "load_seconds": load_s,
           "checkpoints": checkpointed,
           "lazy_guard": {"bit_equal": lazy_equal,
                          "cuda_rng_equal": bool(torch.equal(rng_eager,
                                                             rng_lazy)),
                          "eager_build_s": eager_s, "lazy_build_s": lazy_s},
           "float32_card_vs_cpu": fp32}
    emit(rec)
    n_fwd = L * (steps + n_eval_batches)
    assert (fl["fwd"], fl["fwd_sm90"]) == (n_fwd, n_fwd), rec
    assert (fl["dkv"], fl["dkv_sm90"], fl["dq"], fl["dq_sm90"]) == \
        (L * steps,) * 4, rec
    assert (fl_ep["fwd"], fl_ep["fwd_sm90"], fl_ep["dkv"], fl_ep["dq"]) \
        == (2 * L * n_eval_batches, 2 * L * n_eval_batches, 0, 0), rec
    assert fit_counts["sdpa_plain"] == 0 == ep_counts["sdpa_plain"], rec
    assert rec["thread_fallbacks"] == 0, rec
    assert np.isfinite(logs["loss"]) and 0.0 <= ev["acc"] <= 1.0, rec
    assert np.all(np.isfinite(pred)) and pred.shape == (n_eval, 2), rec
    assert rec["predictions_bit_equal_after_load"], rec
    assert checkpointed == ["final"], rec
    assert lazy_equal and rec["lazy_guard"]["cuda_rng_equal"], rec
    paths = {"hapi_bert": {k: fl[k] + fl_ep[k] for k in fl},
             "hapi_bert_fp32": fp32_counts}
    return paths


def phase_hapi_resnet(batch=256, steps=12, warmup=3, workers=8,
                      drill_batch=32, drill_steps=24):
    """ResNet-50 (NHWC, s2d_stem, bf16 O2 without master weights,
    Momentum(0.1, 0.9)) as the resnet phase trains it, fed by Model.fit
    from an io.DataLoader of uint8 224 x 224 x 3 images made from the
    index through Compose([RandomHorizontalFlip(), ToTensor(),
    Normalize(mean, std)]) (ToTensor + Normalize fused into one native
    pass), batch 256, 8 worker processes, rings of two batches: 12 steps,
    the first 3 not timed (log_freq 1: every step's loss is read, so each
    step ends on the card).  Images/s beside the resnet phase's NHWC
    images/s, and the share of the timed steps' wall time spent waiting
    for the loader.  Then the drill: loader.worker_kill@2#1 kills worker
    1 at its second batch (batch 32, 24 steps, a sampler over a fixed
    permutation); the pool respawns it and every batch of the epoch
    arrives once, in the sampler's order (the labels the loss saw
    against the permutation's).  The loader probes one sample before it
    draws a shuffled order (as the reference does), and that probe's
    random flip draws from numpy too, so the drill fixes its order."""
    from paddle_tpu_torch import amp, io, nn
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.observability import metrics as obs_metrics
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.models import resnet50

    class NhwcResNet(nn.Layer):
        """CHW float32 batches in, the NHWC bf16 ResNet-50 inside."""

        def __init__(self):
            super().__init__()
            self.net = resnet50(
                num_classes=1000, s2d_stem=True, data_format="NHWC",
                device="cuda",
                generator=torch.Generator("cuda").manual_seed(0))

        def forward(self, x):
            return self.net(x.to(torch.bfloat16).permute(0, 2, 3, 1)
                            .contiguous())

    class LabelLog(nn.Layer):
        """Cross entropy that keeps every label batch it is given."""

        def __init__(self):
            super().__init__()
            self.seen = []
            self.ce = nn.CrossEntropyLoss()

        def forward(self, pred, label):
            self.seen.append(label.detach())
            return self.ce(pred, label)

    transform = T.Compose([T.RandomHorizontalFlip(), T.ToTensor(),
                           T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])
    fused = type(transform.transforms[1]).__name__
    StepClock, _ = hapi_recorders()
    fallbacks = sum(io.fallback_counts.values())
    respawned = obs_metrics.registry().counter(
        "loader_worker_respawns_total")
    respawns0 = respawned.value

    def build():
        net = NhwcResNet()
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=net.parameters())
        net, opt = amp.decorate(models=net, optimizers=opt,
                                dtype="bfloat16", master_weight=False)
        loss = LabelLog()
        return Model(net).prepare(opt, loss), loss

    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True     # as the resnet phase
    model, _ = build()
    batch_bytes = batch * 3 * 224 * 224 * 4 + batch * 8
    clock = StepClock()
    np.random.seed(1)
    loader = io.DataLoader(HapiImages(steps * batch, transform=transform),
                           batch_size=batch, shuffle=True,
                           num_workers=workers,
                           ring_bytes=2 * batch_bytes + (1 << 20))
    release()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = model.fit(loader, epochs=1, log_freq=1, verbose=0,
                        callbacks=[clock])
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    timed_s = clock.end[-1] - clock.end[warmup - 1]
    waits = [clock.begin[i] - clock.end[i - 1]
             for i in range(warmup, steps)]
    ips = (steps - warmup) * batch / timed_s
    del model
    release()

    # the drill: a worker killed at its second batch, respawned
    torch.backends.cudnn.benchmark = False
    model, labels = build()
    n = drill_steps * drill_batch
    order = np.random.RandomState(2).permutation(n)
    with chaos.scoped("loader.worker_kill@2#1") as plan:
        model.fit(io.DataLoader(HapiImages(n, transform=transform),
                                batch_sampler=io.BatchSampler(
                                    sampler=order.tolist(),
                                    batch_size=drill_batch),
                                num_workers=workers),
                  epochs=1, log_freq=drill_steps, verbose=0)
    seen = torch.cat(labels.seen).cpu().numpy()
    torch.backends.cudnn.benchmark = bench
    respawns = respawned.value - respawns0
    rec = {"phase": "hapi_resnet", "model": "resnet50", "batch": batch,
           "image": 224, "s2d_stem": True, "data_format": "NHWC",
           "dtype": "bfloat16", "amp": "O2, master_weight=False",
           "optimizer": "Momentum(0.1, 0.9)", "workers": workers,
           "ring_bytes": 2 * batch_bytes + (1 << 20),
           "transform": "Compose([RandomHorizontalFlip(), ToTensor(), "
                        "Normalize(mean, std)])", "fused_stage": fused,
           "steps": steps, "warmup_steps": warmup, "fit_seconds": fit_s,
           "images_per_s": ips,
           "resnet_phase_nhwc_images_per_s":
               PHASE_NOTES.get("resnet_nhwc_images_per_s"),
           "step_ms": [(e - b) * 1e3 for b, e in zip(clock.begin,
                                                      clock.end)],
           "data_wait_ms": [w * 1e3 for w in waits],
           "data_wait_share": sum(waits) / timed_s,
           "loss": history[0]["loss"], "peak_memory_gib": peak / 2**30,
           "thread_fallbacks": sum(io.fallback_counts.values()) - fallbacks,
           "drill": {"plan": "loader.worker_kill@2#1", "fired": plan.log,
                     "respawns": respawns, "batch": drill_batch,
                     "steps": drill_steps, "batches_seen": len(labels.seen),
                     "order_kept": bool(np.array_equal(seen, order % 1000))}}
    emit(rec)
    assert fused == "_FusedToTensorNormalize", rec
    assert len(clock.end) == steps and np.isfinite(rec["loss"]), rec
    assert rec["thread_fallbacks"] == 0, rec
    assert plan.log == [("loader.worker_kill", "1", 2)] and respawns == 1, rec
    assert len(labels.seen) == drill_steps and rec["drill"]["order_kept"], \
        rec
    del model, labels
    release()


# to_static_train: GPT-3 1.3B at full width, cut to this many of its 24
# layers for Inductor's compile time (the program a layer compiles grows
# with the depth Dynamo unrolls)
TO_STATIC_LAYERS = 2
# to_static_train's gates on the compiled run against the eager copy.
# Losses: sound runs differ by under 3e-4 (Inductor keeps fused
# intermediates in float32 where eager rounds each op to bf16), while the
# eager loss falls about 3e-3 a step at 6 layers and 2.2e-3 at 2, so a
# compiled model that does not learn falls outside 2e-3 from its second
# step on.  Gradients of the first step (the same weights and batch on
# both sides): each leaf's |gc - ge| / |ge|, where a gradient left out
# gives 1 on its part of a leaf; sound runs stay under 0.015 at 2 and 6
# layers, a zeroed dQ reads about 0.5 on the first qkv weight (`tools/
# torch_compile_probe.py --broken`).  The parameters' changes are not compared: in pure bf16 an
# Adafactor step (lr x the leaf's rms, about 2e-6 on a weight) moves only
# elements near zero, so which of them round onward decides that gap.
TO_STATIC_LOSS_TOL = 2e-3
TO_STATIC_GRAD_TOL = 0.1


def grad_gaps(named, compiled, eager):
    """Each leaf's relative gradient gap |gc - ge| / |ge| (0 where both
    are zero, 1 where one side has no gradient), largest first."""
    gaps = []
    for n, gc, ge in zip(named, compiled, eager):
        if gc is None or ge is None:
            gaps.append((1.0 if (gc is None) != (ge is None) else 0.0, n))
            continue
        gc, ge = gc.float(), ge.float()
        num, den = float((gc - ge).norm()), float(ge.norm())
        gaps.append((num / den if den else float(num > 0), n))
    return sorted(gaps, reverse=True)


def card_name_power():
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def to_static_gpt(layers, batch, seq):
    """to_static_train's GPT-3 1.3B (full width, `layers` of its 24) from
    seed 0 and its batch from seed 1: the model, the config, ids and
    labels.  34 and 34a's restarted process build the same."""
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM
    cfg = GPTConfig.from_preset("gpt3-1.3B", vocab_size=50304,
                                max_position_embeddings=seq,
                                hidden_dropout=0.0, attention_dropout=0.0,
                                num_layers=layers)
    model = GPTForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                           device="cuda")
    return model, cfg, ids, labels


def bf16_adafactor(model):
    """(model, optimizer) in pure bf16 (O2 without master weights) with
    Adafactor(1e-4), as to_static_train trains."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import Adafactor
    opt = Adafactor(learning_rate=1e-4, parameters=model.parameters())
    return amp.decorate(models=model, optimizers=opt, dtype="bfloat16",
                        master_weight=False)


def phase_to_static_train(layers=TO_STATIC_LAYERS, steps=10, warmup=3,
                          batch=4, seq=1024, store=None):
    """GPT-3 1.3B at full width (hidden 2048, 16 heads, D 128, vocab
    50304), seq 1024, batch 4, pure bf16 (`amp.decorate(master_weight=
    False)`), Adafactor, as `phase_train` builds it, with the model
    wrapped by `jit.to_static` (full_graph=True, Inductor) and each step
    the reference's eager loop: loss = gpt_loss_fn(model, ids, labels);
    loss.backward(); opt.step(); opt.clear_grad().  An eager copy with the
    same weights and batches runs the same steps after it.  Asserts over
    the compiled steps: the sm90 flash forward, dK/dV and dQ launch
    layers x steps times each (inside the compiled forward and backward
    graphs), the plain sdpa runs 0 times, and the compile tracker saw one
    compile and no graph break; the compiled losses lie within
    TO_STATIC_LOSS_TOL of the eager ones, and the first step's gradients
    within TO_STATIC_GRAD_TOL of the eager copy's, leaf by leaf.  The
    first compiled step's wall seconds beyond the steady p50 are the
    compile's (the forward and backward graphs' at the first call: with
    a store the backward compiles with the forward).  With `store` (a
    directory) the persistent compile cache is on for the compiled run,
    so its compile publishes there (publish seconds and the store's bytes
    printed); returns the launch counts and what 34a compares with."""
    import copy
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.jit import compile_cache as cc
    from paddle_tpu_torch.observability import compile_tracker as ct
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.text import gpt_loss_fn

    t_phase = time.perf_counter()
    model, cfg, ids, labels = to_static_gpt(layers, batch, seq)
    eager = copy.deepcopy(model)
    models = {name: bf16_adafactor(m) for name, m in
              (("compiled", model), ("eager", eager))}
    cc.configure(store)
    assert cc.mesh_fingerprint() == "", "an earlier phase left a mesh"
    st = jit.to_static(models["compiled"][0])
    named = [n for n, _ in models["compiled"][0].named_parameters()]

    def run(net, opt):
        losses, times, grads = [], [], None
        for _ in range(warmup + steps):
            t0 = time.perf_counter()
            loss = gpt_loss_fn(net, ids, labels)
            loss.backward()
            if grads is None:
                grads = [None if p.grad is None else p.grad.detach().clone()
                         for p in net.parameters()]
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())      # waits for the card
            times.append(time.perf_counter() - t0)
        return losses, times, grads

    torch.cuda.synchronize()
    ct.reset()
    zero_counts()
    losses, times, grads = run(st, models["compiled"][1])
    counts = read_counts()
    events = ct.events(st._label)
    compiles, breaks = ct.compile_count(st._label), ct.graph_breaks()
    published = {"store_stats": cc.stats(), "store_bytes":
                 cc.cache().total_bytes() if store else 0,
                 "publish_s": metrics.registry().histogram(
                     "compile_cache_publish_seconds",
                     fn=st._fn_cache.label).sum}
    cc.configure(None)
    eager_losses, eager_times, eager_grads = run(*models["eager"])
    n = warmup + steps
    p50 = float(np.percentile(times[warmup:], 50))
    eager_p50 = float(np.percentile(eager_times[warmup:], 50))
    diff = max(abs(a - b) for a, b in zip(losses, eager_losses))
    gaps = grad_gaps(named, grads, eager_grads)
    del grads, eager_grads
    emit({"phase": "to_static_train", "model": "gpt3-1.3B",
          "layers": layers, "layers_full": 24, "seq": seq, "batch": batch,
          "dtype": "bfloat16", "amp": "O2, master_weight=False",
          "optimizer": "Adafactor(1e-4)", "backend": jit._BACKEND,
          "full_graph": True, "steps": n,
          "compile_s_first_step": times[0] - p50,
          "compile_cache": published,
          "compile_events": [{"cause": e.cause, "wall_s": e.wall_s,
                              "graphs": e.graphs,
                              "graph_breaks": e.graph_breaks}
                             for e in events],
          "compiles": compiles, "graph_breaks": breaks,
          "step_p50_ms": p50 * 1e3, "eager_step_p50_ms": eager_p50 * 1e3,
          "step_ms": [t * 1e3 for t in times],
          "eager_step_ms": [t * 1e3 for t in eager_times],
          "losses": losses, "eager_losses": eager_losses,
          "max_loss_diff": diff, "loss_tol": TO_STATIC_LOSS_TOL,
          "eager_loss_drop": eager_losses[0] - eager_losses[-1],
          "grad_gaps_worst": gaps[:6], "grad_gap_median":
          gaps[len(gaps) // 2][0], "grad_tol": TO_STATIC_GRAD_TOL,
          "flash_launches": flash_part(counts),
          "sdpa_plain_calls": counts["sdpa_plain"],
          "card": card_name_power(),
          "phase_seconds": time.perf_counter() - t_phase})
    assert all(np.isfinite(losses)), f"nonfinite loss in {losses}"
    want = layers * n
    assert counts["flash_fwd_sm90"] == counts["flash_dkv_sm90"] == \
        counts["flash_dq_sm90"] == want, \
        f"sm90 launches {flash_part(counts)}, want {want} of each kernel"
    assert counts["sdpa_plain"] == 0, \
        f"sdpa took its plain path {counts['sdpa_plain']} times"
    assert compiles == 1 and breaks == 0, \
        f"{compiles} compiles, {breaks} graph breaks: {events}"
    assert diff <= TO_STATIC_LOSS_TOL, \
        f"compiled losses {losses} vs eager {eager_losses}"
    assert gaps[0][0] <= TO_STATIC_GRAD_TOL, \
        f"first-step gradients off the eager ones: {gaps[:6]}"
    if store:
        s = published["store_stats"]
        assert (s["misses"], s["puts"], s["hits"]) == (1, 1, 0), published
    del st, models, model, eager
    release()
    return flash_part(counts), {"losses": losses, "layers": layers,
                                "steps": warmup + steps,
                                "compile_s": times[0] - p50,
                                "first_step_s": times[0],
                                "settings": torch_settings()}


def torch_settings():
    """The process-wide torch settings an Inductor cache key reads (the
    float32 matmul precision, reduced-precision reductions, deterministic
    algorithms, the default dtype), as their own getters give them: a
    restarted process applies the cold run's (`apply_torch_settings`), as
    a restarted trainer runs its own configuration again."""
    m, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    out = {"default_dtype": str(torch.get_default_dtype()),
           "float32_matmul_precision": torch.get_float32_matmul_precision(),
           "bf16_reduced": m.allow_bf16_reduced_precision_reduction,
           "fp16_reduced": m.allow_fp16_reduced_precision_reduction,
           "deterministic": torch.are_deterministic_algorithms_enabled(),
           "deterministic_warn_only":
               torch.is_deterministic_algorithms_warn_only_enabled(),
           "fill_uninitialized_memory":
               torch.utils.deterministic.fill_uninitialized_memory}
    # torch with the fp32_precision API keys on it ("none" when never
    # set), older torch on allow_tf32
    for name, obj in (("matmul", m), ("cudnn", cudnn)):
        if hasattr(obj, "fp32_precision"):
            out[f"{name}_fp32_precision"] = obj.fp32_precision
        else:
            out[f"{name}_allow_tf32"] = obj.allow_tf32
    return out


def apply_torch_settings(want):
    """Set each of `torch_settings()` that differs from `want` (setting
    one that already matches can move another key: allow_tf32 = False
    turns an unset fp32 precision "none" into "ieee")."""
    m, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    have = torch_settings()
    setters = {
        "default_dtype": lambda v: torch.set_default_dtype(
            getattr(torch, v.split(".")[1])),
        "float32_matmul_precision": torch.set_float32_matmul_precision,
        "bf16_reduced": lambda v: setattr(
            m, "allow_bf16_reduced_precision_reduction", v),
        "fp16_reduced": lambda v: setattr(
            m, "allow_fp16_reduced_precision_reduction", v),
        "fill_uninitialized_memory": lambda v: setattr(
            torch.utils.deterministic, "fill_uninitialized_memory", v),
        "matmul_fp32_precision": lambda v: setattr(m, "fp32_precision", v),
        "cudnn_fp32_precision": lambda v: setattr(cudnn, "fp32_precision",
                                                  v),
        "matmul_allow_tf32": lambda v: setattr(m, "allow_tf32", v),
        "cudnn_allow_tf32": lambda v: setattr(cudnn, "allow_tf32", v)}
    if (want["deterministic"], want["deterministic_warn_only"]) != \
            (have["deterministic"], have["deterministic_warn_only"]):
        torch.use_deterministic_algorithms(
            want["deterministic"], warn_only=want["deterministic_warn_only"])
    for k, v in want.items():
        if k in setters and torch_settings()[k] != v:
            setters[k](v)
    assert torch_settings() == want, (torch_settings(), want)


def cache_warm(store, settings, steps=3, layers=TO_STATIC_LAYERS, batch=4,
               seq=1024):
    """`chip_smoke.py --cache-warm STORE SETTINGS`: 34a's restarted process
    (its Inductor and Triton caches are the parent's choice, empty), under
    the cold run's torch settings (SETTINGS, JSON).  Builds
    to_static_train's model and batch, wraps the model in to_static
    against STORE and takes `steps` steps.  Prints one JSON line: the
    losses, the wall from to_static to the first step's end, Dynamo's
    share of it (`torch._dynamo.utils.compilation_time_metrics`: the
    compile minus the backend's call, which loads from the caches), the
    backend's once-a-process costs (importing Inductor, hashing torch's
    sources for the cache keys), the
    store's stats, Inductor's FX-graph and AOTAutograd cache counters,
    the compile tracker's compiles and causes, and the launch counts."""
    from torch._dynamo.utils import compilation_time_metrics, counters
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.jit import compile_cache as cc
    from paddle_tpu_torch.observability import compile_tracker as ct
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.text import gpt_loss_fn

    t_start = time.perf_counter()
    # the interpreter's start and imports (torch, the port) before this
    started = time.time() - float(os.environ.get("CHIP_SMOKE_SPAWNED_AT",
                                                 time.time()))
    apply_torch_settings(json.loads(settings))
    model, _, ids, labels = to_static_gpt(layers, batch, seq)
    model, opt = bf16_adafactor(model)
    cc.configure(store)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    st = jit.to_static(model)
    losses, first_s = [], None
    for _ in range(steps):
        loss = gpt_loss_fn(st, ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())      # waits for the card
        if first_s is None:
            first_s = time.perf_counter() - t0
    counts = read_counts()
    def took(name):
        return sum(compilation_time_metrics.get(name, []))

    compile_s = took("_compile.compile_inner")
    backend_s = took("OutputGraph.call_user_compiler")
    print(json.dumps({
        "losses": losses, "warm_first_step_s": first_s,
        "dynamo_s": compile_s - backend_s, "backend_s": backend_s,
        # once a process, whatever the cache: importing Inductor and
        # hashing torch's sources for its cache keys
        "inductor_import_s": took("inductor_import"),
        "torch_key_s": took("inductor_codecache_torch_key"),
        "load_s": metrics.registry().histogram(
            "compile_cache_load_seconds", fn=st._fn_cache.label).sum,
        "store_stats": cc.stats(),
        "inductor": {k: v for k, v in counters["inductor"].items()
                     if k.startswith("fxgraph_cache")},
        "aot_autograd": {k: v for k, v in counters["aot_autograd"].items()
                         if k.startswith("autograd_cache")},
        "tracker_compiles": ct.compile_count(st._label),
        "causes": [e.cause for e in ct.events(st._label)],
        "flash_launches": flash_part(counts),
        "sdpa_plain_calls": counts["sdpa_plain"],
        "start_s": started,
        "process_s": time.perf_counter() - t_start}), flush=True)
    return 0


def phase_compile_cache(store, cold):
    """34a: to_static_train restarted in a fresh interpreter on its store
    (`cache_warm`), with Inductor's and Triton's cache directories of its
    own, empty, so that what it does not compile came from the store.
    Gates (each printed): 0 Inductor compiles (FX-graph cache misses and
    bypasses 0), a store hit with one graph a hit for the forward and the
    backward and 0 misses, 0 tracker compiles and a "persistent cache
    hit" event, the sm90 forward, dK/dV and dQ layers x steps times each,
    0 plain sdpa, the first loss equal to the cold run's in every bit and
    the others within TO_STATIC_LOSS_TOL (the embedding backward sums
    with atomics); then one entry damaged by `chaos.corrupt_cache_entry`
    reads as a miss here and moves to quarantine/.  Returns the restarted
    process's flash launch counts."""
    import tempfile
    from paddle_tpu_torch.jit import compile_cache as cc
    from paddle_tpu_torch.resilience import chaos

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="warm_caches_") as caches:
        env = dict(os.environ,
                   TORCHINDUCTOR_CACHE_DIR=os.path.join(caches, "inductor"),
                   TRITON_CACHE_DIR=os.path.join(caches, "triton"),
                   CHIP_SMOKE_SPAWNED_AT=repr(time.time()))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cache-warm",
             store, json.dumps(cold["settings"])], capture_output=True,
            text=True, timeout=600, env=env)
        child_s = time.perf_counter() - t0
    assert proc.returncode == 0, \
        f"cache-warm exited {proc.returncode}: {proc.stderr[-4000:]}"
    warm = json.loads(proc.stdout.strip().splitlines()[-1])
    n = len(warm["losses"])
    s, fx, aot = warm["store_stats"], warm["inductor"], warm["aot_autograd"]
    inductor_compiles = fx.get("fxgraph_cache_miss", 0) + \
        fx.get("fxgraph_cache_bypass", 0)
    first_equal = warm["losses"][0] == cold["losses"][0]
    loss_diff = max(abs(a - b) for a, b in zip(warm["losses"],
                                               cold["losses"]))
    # the damaged entry: a miss in this process, moved to quarantine/
    entries = [f for f in os.listdir(store) if f.endswith(".ccx")]
    victim = chaos.corrupt_cache_entry(store, mode="flip")
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", cc.CacheUnavailableWarning)
        reread = cc.CompileCache(store).get(
            os.path.basename(victim)[:-len(".ccx")])
    quarantined = os.listdir(os.path.join(store, "quarantine"))
    want = cold["layers"] * n
    fl = warm["flash_launches"]
    emit({"phase": "compile_cache", "model": "gpt3-1.3B",
          "layers": cold["layers"], "steps": n,
          "cold_compile_s": cold["compile_s"],
          "cold_first_step_s": cold["first_step_s"],
          "warm_first_step_s": warm["warm_first_step_s"],
          "warm_dynamo_s": warm["dynamo_s"],
          "warm_dynamo_share": warm["dynamo_s"] / warm["warm_first_step_s"],
          "warm_backend_s": warm["backend_s"], "warm_load_s": warm["load_s"],
          "warm_inductor_import_s": warm["inductor_import_s"],
          "warm_torch_key_s": warm["torch_key_s"],
          "warm_start_s": warm["start_s"],
          "warm_process_s": warm["process_s"], "child_wall_s": child_s,
          "inductor_compiles": inductor_compiles, "fxgraph": fx,
          "aot_autograd": aot, "store_stats": s,
          "tracker_compiles": warm["tracker_compiles"],
          "tracker_causes": warm["causes"],
          "flash_launches": fl, "want_launches": want,
          "sdpa_plain_calls": warm["sdpa_plain_calls"],
          "losses": warm["losses"], "cold_losses": cold["losses"][:n],
          "first_loss_bit_equal": first_equal, "max_loss_diff": loss_diff,
          "loss_tol": TO_STATIC_LOSS_TOL, "store_entries": len(entries),
          "corrupt_reread_is_miss": reread is None,
          "quarantined": quarantined, "card": card_name_power(),
          "phase_seconds": time.perf_counter() - t_phase})
    assert inductor_compiles == 0, f"the restart compiled: {fx}"
    assert (s["hits"], s["misses"]) == (1, 0) and s["hit_graphs"] == 2, \
        f"store: {s}"
    assert fx.get("fxgraph_cache_hit", 0) == 2, fx
    assert warm["tracker_compiles"] == 0 and \
        "persistent cache hit" in warm["causes"], warm["causes"]
    assert fl["fwd_sm90"] == fl["dkv_sm90"] == fl["dq_sm90"] == want, \
        f"sm90 launches {fl}, want {want} of each kernel"
    assert warm["sdpa_plain_calls"] == 0, warm["sdpa_plain_calls"]
    assert first_equal, (warm["losses"][0], cold["losses"][0])
    assert loss_diff <= TO_STATIC_LOSS_TOL, (warm["losses"], cold["losses"])
    assert reread is None and len(quarantined) == 1, quarantined
    return fl


class _Gate(torch.nn.Module):
    """A Linear, then a tensor-dependent `if` (dy2static: torch.cond).
    Its bias is zero, so x and -x take the two branches."""

    def __init__(self, width):
        super().__init__()
        self.fc = torch.nn.Linear(width, width, device="cuda")
        torch.nn.init.zeros_(self.fc.bias)

    def forward(self, x):
        h = self.fc(x)
        if h.mean() > 0:
            out = h * 2.0
        else:
            out = h * -0.5
        return out


def _halve_until_small(x):
    """A tensor-dependent `while`: bounded (while_max_iters) it is a
    masked loop that can be differentiated."""
    while x.abs().max() > 1.0:
        x = x / 2.0
    return x


def _halvings(x):
    """A tensor-dependent `while` with a counter: unbounded, it is
    `while_loop` (forward only)."""
    n = torch.zeros((), device=x.device)
    while x.sum() > 1.0:
        x = x * 0.5
        n = n + 1.0
    return x, n


def phase_dy2static(width=1024):
    """dy2static on the card: a Layer with a tensor-dependent `if`, a
    bounded `while` (while_max_iters, with a backward) and an unbounded
    forward-only `while`, each compiled by `jit.to_static` (Inductor)
    and held against the same code run eagerly under
    `enable_to_static(False)`: outputs and gradients within float32
    rounding (rtol 1e-5, atol 1e-6: Inductor may reorder a reduction),
    the branch taken and the loop counts equal.  Each case runs two
    inputs of one signature, which take the `if`'s two branches and
    different loop counts, through one compile."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.observability import compile_tracker as ct

    t_phase = time.perf_counter()
    ct.reset()
    g = torch.Generator(device="cuda").manual_seed(5)
    gate = _Gate(width)
    x = torch.randn(8, width, generator=g, device="cuda")
    cases = {
        "if": (jit.to_static(gate), lambda s: (x * s,), (1.0, -1.0)),
        "while_bounded": (jit.to_static(_halve_until_small,
                                        while_max_iters=16),
                          lambda s: (torch.full((4, 4), s, device="cuda",
                                                requires_grad=True),),
                          (40.0, 0.5)),
        "while_unbounded": (jit.to_static(_halvings), lambda s: (
            torch.full((8,), s, device="cuda"),), (3.0, 0.01)),
    }
    rec = {}
    for name, (st, make, scales) in cases.items():
        errs = []
        for s in scales:
            args = make(s)
            out = st(*args)
            jit.enable_to_static(False)
            try:
                eargs = [a.detach().requires_grad_(a.requires_grad)
                         for a in args]
                ref = st(*eargs)
            finally:
                jit.enable_to_static(True)
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            if name == "while_bounded":
                outs[0].sum().backward()
                refs[0].sum().backward()
                outs, refs = outs + (args[0].grad,), refs + (eargs[0].grad,)
            for a, b in zip(outs, refs):
                torch.testing.assert_close(a.detach(), b.detach(),
                                           rtol=1e-5, atol=1e-6)
                errs.append(float((a.detach() - b.detach()).abs().max()))
        rec[name] = {"max_abs_err": max(errs),
                     "compiles": ct.compile_count(st._label),
                     "graph_breaks": ct.graph_breaks(st._label)}
    with torch.no_grad():
        rec["if"]["branches"] = [bool(gate.fc(x * s).mean() > 0)
                                 for s in cases["if"][2]]
    emit({"phase": "dy2static", "cases": rec, "backend": jit._BACKEND,
          "card": card_name_power(),
          "phase_seconds": time.perf_counter() - t_phase})
    for r in rec.values():
        assert r["compiles"] == 1 and r["graph_breaks"] == 0, rec
    assert sorted(rec["if"]["branches"]) == [False, True], rec


def phase_static_graph(steps=30, batch=64):
    """`examples/static_mnist.py`'s program at its own width (784-128-10,
    Adam 1e-3, batch 64, the mean cross entropy) through `enable_static`
    / `static.data` / `Executor.run` on the card (the replay compiled by
    Inductor), its losses held to the same `Sequential` trained eagerly
    from the same weights on the same batches (rtol 1e-4, atol 1e-5:
    float32, Adam normalises each update, sums in another order); then
    `save_inference_model` / `load_inference_model` round-trip and give
    the for_test program's logits (rtol 1e-5, atol 1e-5: the loaded
    program runs eagerly, the replay compiled)."""
    import copy
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer, static
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.observability import compile_tracker as ct

    t_phase = time.perf_counter()
    rng = np.random.RandomState(0)
    centers = rng.randn(10, 784).astype(np.float32)
    batches = []
    for _ in range(steps):
        lab = rng.randint(0, 10, batch)
        img = centers[lab] + 0.3 * rng.randn(batch, 784).astype(np.float32)
        batches.append((img, lab.astype(np.int64)))
    torch.manual_seed(0)
    net = nn.Sequential(nn.Linear(784, 128), nn.ReLU(), nn.Linear(128, 10))
    ref_net = copy.deepcopy(net)
    ct.reset()
    paddle.enable_static()
    try:
        x = static.data("x", [None, 784], "float32")
        y = static.data("y", [None], "int64")
        logits = net(x)
        loss = F.cross_entropy(logits, y, reduction="mean")
        optimizer.Adam(learning_rate=1e-3,
                       parameters=net.parameters()).minimize(loss)
        exe = static.Executor()
        exe.run(static.default_startup_program())
        losses, times = [], []
        for img, lab in batches:
            t0 = time.perf_counter()
            (lv,) = exe.run(feed={"x": img, "y": lab}, fetch_list=[loss])
            times.append(time.perf_counter() - t0)
            losses.append(float(lv))
        test_prog = static.default_main_program().clone(for_test=True)
        img = batches[-1][0]
        (ref_logits,) = exe.run(test_prog, feed={"x": img},
                                fetch_list=[logits])
        with tempfile.TemporaryDirectory(prefix="static_mnist_") as tmp:
            static.save_inference_model(tmp + "/model", [x], [logits], exe)
            prog, feeds, fetches = static.load_inference_model(
                tmp + "/model", exe)
            (out,) = exe.run(prog, feed={feeds[0]: img},
                             fetch_list=fetches)
    finally:
        paddle.disable_static()
    opt = optimizer.Adam(learning_rate=1e-3, parameters=ref_net.parameters())
    eager_losses = []
    for img_b, lab_b in batches:
        lv = F.cross_entropy(ref_net(torch.from_numpy(img_b).cuda()),
                             torch.from_numpy(lab_b).cuda(),
                             reduction="mean")
        lv.backward()
        opt.step()
        opt.clear_grad()
        eager_losses.append(lv.item())
    events = ct.events()
    emit({"phase": "static_graph", "program": "784-128-10, Adam(1e-3)",
          "batch": batch, "steps": steps, "losses": losses,
          "eager_losses": eager_losses,
          "max_loss_diff": max(abs(a - b)
                               for a, b in zip(losses, eager_losses)),
          "run_p50_ms": float(np.percentile(times[1:], 50)) * 1e3,
          "first_run_s": times[0],
          "compile_events": [{"label": e.label, "cause": e.cause,
                              "wall_s": e.wall_s} for e in events],
          "reload_max_abs_err": float(np.abs(out - ref_logits).max()),
          "card": card_name_power(),
          "phase_seconds": time.perf_counter() - t_phase})
    np.testing.assert_allclose(losses, eager_losses, rtol=1e-4, atol=1e-5)
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(out, ref_logits, rtol=1e-5, atol=1e-5)
    assert sum(e.cause == "first compile" for e in events) == 2, events


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on "
              "an NVIDIA card", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--aot-export"]:
        return aot_export(*sys.argv[2:4])
    if sys.argv[1:2] == ["--cache-warm"]:
        return cache_warm(*sys.argv[2:4])
    timed("build", phase_build)
    started = start_aot_compile()
    try:
        return run_phases(started)
    finally:
        stop_aot(started[0])


PHASE_SECONDS = {}
# what a later phase prints beside its own numbers: the bert phase's step
# p50 (hapi_bert), the resnet phase's NHWC images/s (hapi_resnet)
PHASE_NOTES = {}


def timed(name, fn, *args, **kwargs):
    """fn(*args, **kwargs), its wall seconds kept in PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    return out


def run_phases(started):
    """Every phase after the build, in the order of their numbers (see
    the module note), each one's wall seconds in the phase_seconds line:
    first those that load no package, beside the compiles that
    `start_aot_compile` started, then the wait for them (aot_compile),
    then the serving phases and ernie_infer, then the timings."""
    timed("kernels", phase_kernels)
    timed("flash_kernels", phase_flash_kernels)
    timed("tensor_api", phase_tensor_api)
    timed("e2e", phase_e2e)
    paths = {}
    paths["train"], train_losses = timed("train", phase_train)
    paths.update(timed("fleet", phase_fleet, train_losses))
    paths["train_e2e"] = timed("train_e2e", phase_train_e2e)
    paths.update({f"generate/{name}": counts for name, counts in
                  timed("generate", phase_generate,
                        layers=GENERATE_LAYERS).items()})
    serve_llama = timed("serve_llama", phase_serve_llama)
    paths["generate_e2e"] = timed("generate_e2e", phase_generate_e2e)
    paths["train_llama"] = timed("train_llama", phase_train_llama)
    paths["train_llama_e2e"] = timed("train_llama_e2e",
                                     phase_train_llama_e2e)
    paths.update(timed("lora", phase_lora, layers=LORA_LAYERS))
    paths.update(timed("weight_only", phase_weight_only,
                       layers=WEIGHT_ONLY_LAYERS))
    timed("resnet", phase_resnet)
    timed("resnet_e2e", phase_resnet_e2e)
    paths.update(timed("bert", phase_bert))
    paths["bert_e2e"] = timed("bert_e2e", phase_bert_e2e)
    paths["bert_fp32_train"], fp32_p50, fp32_busy = timed(
        "bert_fp32_train", phase_bert_fp32_train)
    paths["bert_resume"] = timed("bert_resume", phase_bert_resume, fp32_p50,
                                 fp32_busy)
    paths["ernie_e2e"] = timed("ernie_e2e", phase_ernie_e2e)
    paths["moe_train"] = timed("moe_train", phase_moe_train)
    paths.update(timed("moe_generate", phase_moe_generate))
    moe_paged = timed("moe_serve", phase_moe_serve)
    moe_e2e, moe_e2e_paged = timed("moe_e2e", phase_moe_e2e)
    paths.update(moe_e2e)
    mt_paths, mt, mt_src = timed("mt_train", phase_mt_train)
    paths.update(mt_paths)
    paths.update(timed("mt_generate", phase_mt_generate, mt, mt_src))
    del mt, mt_src
    release()
    paths.update(timed("mt_e2e", phase_mt_e2e))
    paths.update(timed("hapi_bert", phase_hapi_bert))
    timed("hapi_resnet", phase_hapi_resnet)
    # Inductor's compiles, last before the wait: the AOT jobs are done
    # by now (or at nice 19), so the compiles meet the least contention
    import tempfile
    with tempfile.TemporaryDirectory(prefix="compile_store_") as store:
        paths["to_static_train"], cold = timed(
            "to_static_train", phase_to_static_train, store=store)
        paths["compile_cache"] = timed("compile_cache", phase_compile_cache,
                                       store, cold)
    timed("dy2static", phase_dy2static)
    timed("static_graph", phase_static_graph)
    aot = timed("aot_compile", finish_aot_compile, started)
    launches, lens, serve = timed("serve", phase_serve)
    serve_aot = timed("serve_aot", phase_serve_aot, serve, aot)
    aot_e2e_paged = timed("serve_aot_e2e", phase_serve_aot_e2e, aot)
    router = timed("serve_router", phase_serve_router, serve, serve_aot)
    drill = timed("router_drill", phase_router_drill,
                  router["spawn_to_ready_s"], layers=ROUTER_DRILL_LAYERS)
    paths.update(timed("ernie_infer", phase_ernie_infer, aot))
    paths["serve_aot"] = serve_aot["flash"]
    paths["serve_router"] = router["flash"]
    paths["router_drill"] = drill["flash"]
    paged = timed("timings", phase_timings,
                  launches + serve_aot["paged"] + aot_e2e_paged
                          + serve_llama["paged_decode"]
                          + router["paged"] + drill["paged"] + moe_paged
                          + moe_e2e_paged, lens)
    paged["launches_by_path"] = {"serve": launches,
                                 "serve_aot": serve_aot["paged"],
                                 "serve_aot_e2e": aot_e2e_paged,
                                 "serve_llama": serve_llama["paged_decode"],
                                 "serve_router": router["paged"],
                                 "router_drill": drill["paged"],
                                 "moe_serve": moe_paged,
                                 "moe_e2e": moe_e2e_paged}
    flash = timed("flash_timings", phase_flash_timings, paths)
    emit({"phase": "phase_seconds", "seconds": PHASE_SECONDS,
          "total_s": sum(PHASE_SECONDS.values())})
    emit({"kernels": [paged] + flash})
    print(card_name_power(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
