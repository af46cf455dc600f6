#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: build its kernels, hold
each against its plain PyTorch version, serve Llama-3-8B, train
ResNet-50 data-parallel, run the JAX recipe's GPT-2-medium ZeRO-1
configuration with checkpoints, train GPT-2-medium, run the JAX
recipe's Llama-3-8B FSDP full-shard configuration at full width, and
run the JAX recipe's BERT-base fine-tune in bf16 and fp16, and run
generation (GPT-2 decode, beams, speculative decoding, the int8 KV
cache), int8/int4 Llama-3-8B and BERT-base LoRA.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises (and so exits non-zero) on a failed check:

1. build: ``nvcc`` compiles ``pytorch_distributed_tpu_torch/csrc/*.cu``,
   one process per source, all at once, into
   ``pytorch_distributed_tpu_torch/_build/`` (ignored by git); then each
   kernel's registers and spills (``ptxas -v``) and its tensor-core
   instructions (``HMMA``/``HGMMA`` in ``cuobjdump -sass``): the bf16 and
   fp16 flash forward, dq and dkv kernels and the bf16 paged kernel must
   have some at every head_dim and the f32 flash forward and f32 paged
   kernel none; the bf16 and fp16 flash forwards must not spill up to
   head_dim 64, the bf16 paged kernel up to 128.
2. paged kernel: the paged-attention kernel at the decode tick's shapes
   (Llama-3-8B attention: 32 query / 8 kv heads, head_dim 128, 32-token
   pages, 8 rows of seeded lengths up to 2000), plus a W=5 verify block,
   a 256-token window, a row through every split of the key axis, W=5
   rows with a split boundary just past their length, a window that
   empties the leading splits, buckets of 1 and 2 pages, and garbage in
   the null page, in bf16 and f32, against the plain ``stream`` and
   ``gather`` versions, and bitwise equal over two launches; then its
   time (replayed from a CUDA graph, eager beside) next to the plain
   version's, a bytes bound, and ``scaled_dot_product_attention`` over
   the same K/V gathered dense.
3. flash kernels: the forward, dq and dkv kernels against their plain
   versions (the backward ones fed the same dO, lse and delta), in bf16,
   fp16 and f32, at GPT-2-medium's training shapes (B=8, S=T=1024, 16 heads,
   head_dim 64, causal), on packed rows from ``pack_documents``, with a
   ragged ``kv_mask``, at Llama-3-8B's GQA shapes (32/8 heads, head_dim
   128, S=2048, full), at Llama-3-8B's training shape (8b: B=8,
   S=T=2048, 32/8 heads, head_dim 128, causal), with ``sm_scale=1.0``,
   at S=T=1000 and at BERT-base's (B=32, S=T=128, 12 heads of 64,
   non-causal, padded to seeded lengths 16-128); the bf16
   forward, dq and dkv must give the same bits on two launches; then each
   kernel's time at GPT-2-medium's and at Llama-3-8B's training shapes,
   and at BERT's in bf16 and in fp16, beside its plain version's, a
   bound, and ``scaled_dot_product_attention``'s flash backend (at
   BERT's padded shape its memory-efficient one, the one that takes a
   bias: the mask as a ``[B, H, S, T]`` bias made outside the timing; K/V
   expanded to the query heads outside the timed region at Llama's GQA
   shape, which that backend does not take): its
   forward for the forward kernel, its backward alone (one call that
   computes dq, dk and dv, so the dq and dkv kernels share it) for the
   backward kernels. The kernels and the yardsticks are replayed from a
   CUDA graph, so they time the card, not the host's dispatch (the
   kernels' eager time is printed beside).
4. serve: ``ServeEngine`` on Llama-3-8B at full width and depth, weights
   drawn from a seeded generator: 8 requests (6 greedy, 2 sampled, two
   sharing a 256-token prefix). Every request must finish with its full
   token count, the kernel must have launched once per layer per decode
   tick, and every greedy token must be, within a stated bf16 margin,
   the argmax of a dense teacher-forced forward of the same model on the
   plain einsum attention (``attn_impl="xla"``: the reference runs no
   kernel).
5. train: GPT-2-medium at full width and depth under ``Policy.train()``,
   seeded weights, clip(1.0) then adamw(3e-4) (weight decay 1e-4) through
   ``DataLoader``/``Trainer``/``build_train_step``: 10 steps on one
   repeated batch of 8 x 1024 tokens, then 3 steps of 2 microbatches on
   packed rows. Every loss must be finite, the repeated batch's loss must
   fall by ``LOSS_DROP``, each flash kernel must have launched 24 times
   per microbatch, and one step's loss, gradient norm and q/k/v weight
   gradients with the flash kernels must match the einsum attention's
   within bf16 tolerances.
   Step time, tokens/s, peak memory and the kernels' share of the step
   (from their timed ms, and from ``torch.profiler`` over two more
   steps, which is why this phase runs last).

6. ResNet-50 data-parallel (before train, whose profiler would slow the
   host after it): (a) bench.py's primary shape, ResNet-50 at batch 128
   x 224^2 under ``Policy.train()``, SGD(0.1, momentum 0.9), in
   ``DataParallel`` at world size 1 over NCCL on a localhost store torn
   down after the phase, one placed f32 batch fed again every step, 5
   warm-up and 50 timed steps ending in a value fetch:
   ``resnet50_imagenet_images_per_sec_per_chip``, step ms, peak memory,
   and the loss, which must be finite and fall; (d) on the trained
   weights, the bf16-product logits against an f32 copy's (TF32 off),
   one DDP backward's gradients against a plain copy's (at world 1 that
   checks DDP's wrapping; the global statistics across ranks are
   ``scripts/port_dp_scale.py``'s check on four cards), and the port's
   BatchNorm (SyncBatchNorm's ATen kernels) against ``F.batch_norm`` on
   a ResNet-50 activation, forward, backward and statistics; (b)
   ``dp_step_overhead_ms`` at bench.py's shape (ResNet [2, 2]
   BasicBlock, width 32, CIFAR stem, 100 classes, 64^2, batch 64): the
   DDP step minus the plain step on the same weights, in turns; (c)
   ``recipes/resnet50_imagenet.main`` at batch 128, uint8 data through
   the prefetching loader, normalize and flip on the card: its images/s
   over the whole training loop and the share of the loop spent in
   ``train.data_wait``. None of the four kernels runs on this path
   (their counts are read; a launch fails the run).
   Last of all, (e) ``torch.profiler`` over two steps of (a): device
   busy ms, idle share, and the time by kernel family.
7. the JAX recipe's default GPT-2 run (after ResNet, before train):
   GPT-2-medium at full width and depth under ``Policy.train()``,
   ``ZeRO1`` (DDP + ``ZeroRedundancyOptimizer`` over AdamW) at world 1
   over NCCL on a localhost store torn down after, full remat, vocab
   chunk 8192, batch 8 x 1024 in 2 microbatches, clip(1.0) then
   adamw(3e-4). (a) 6 steps with a checkpoint every 3 into a temporary
   directory: finite losses, flash launches as the remat implies (the
   forward twice per layer and microbatch) and no paged launch, the
   median of steps 2-6 (the logged times leave the saves out) and the
   same step in a plain loop on one placed batch, before and after
   ``os.sync`` writes the saves' dirty pages out, the host's time in
   the garbage collector, tokens/s, peak memory and save time (printed
   beside the train phase's at the end);
   (b) a fresh model, optimizer and trainer restore step 3: parameters,
   both moments, step and sampler cursor equal to the bit, and steps
   4-6 repeat the first run's losses within ``RESUME_LOSS_RTOL``; (c)
   the chunked loss against the full logits at the head's shapes (N =
   8 x 1023, D = 1024, V = 50257, tied ``wte``): loss and gradients
   within stated limits, its peak memory above the inputs under half
   the full one's; (d) one microbatch's gradients with each remat
   policy against none, dropout on, to the bit, and each policy's flash
   launches; (e) the recipe's ``--text-file --pack`` at GPT-2-medium
   width on a corpus written here from a seed: 3 steps give finite
   losses and the recipe's tokenizer round-trips the corpus.

8. the JAX recipe's Llama-3-8B run (``recipes/llama_fsdp.py --strategy
   fsdp --remat --vocab-chunk 8192``), last before the ResNet profile:
   (a) Llama-3-8B at full width and 4 of its 32 layers (1.92 B
   parameters: one card cannot hold the 8B AdamW state) under
   ``Policy.train()``, FSDP full-shard at world 1 over NCCL (made on the
   meta device, each rank drawing its rows of the seeded weights), full
   remat, vocab chunk 8192, batch 8 x 2048, clip(1.0) then adamw(1e-4,
   decay 1e-4), 6 steps with one checkpoint at step 3: finite losses,
   flash launches 8 forward, 4 dq, 4 dkv a step and no paged launch, the
   median of steps 2-6, tokens/s and peak memory; a fresh model restores
   step 3 (parameters, both moments, step and cursor equal to the bit)
   and repeats steps 4-6 to the bit; then ``torch.profiler`` over two
   steps: device busy ms, idle share, time by kernel family. (b) is
   phase 3's Llama-shape case and timing.

9. the JAX recipe's BERT-base fine-tune (``recipes/bert_finetune.py``,
   through its ``build_trainer``), after phase 8: BERT-base at full width
   and depth, ``BertForSequenceClassification`` with 2 labels,
   ``DataParallel`` at world 1 over NCCL, AdamW(2e-5, decay 0.01, the
   no-decay groups), the recipe's batch 32 x 128 over one batch of its
   synthetic rows padded to seeded lengths 16-128. (a) bf16 and (b)
   fp16 (the recipe's scaler), ``BERT_STEPS`` steps each through fit():
   finite losses, the rows' loss with dropout off falling, the median
   step, samples/s, peak memory, then torch.profiler over two steps
   (device busy ms, idle share, time by family); (b) fp16 from a scale
   of 2^40 (growth interval 3) for ``BERT_FP16_STEPS`` steps through
   fit(), each step checked: a skipped one leaves every parameter and
   AdamW tensor bitwise, the scale and tracker follow the JAX rule, at
   least one skip and one growth, the optimizer's count lags ``step`` by
   the skips, the rows' loss falls; (c) the checkpoint fit() wrote
   after them restored into a model of other weights to the bit (the
   scaler's state, step and cursor included) and the next 3 steps
   repeated to the bit; (d) ``--mlm`` at lr 1e-4 for 8 steps: the rows'
   loss under a fixed masking falls, each step's ``mask_frac`` within
   0.02 of 0.15 x the rows' unpadded share. Flash launches 12 of each
   kernel a step, the paged kernel none.

10. generation, quantization and LoRA (after 7, before train, whose
   profiler would slow the host-bound decode): (a) ``recipes/gpt2.py
   --size medium``, 2 steps at 8 x 512 then ``--sample 32`` (2 rows of
   32 new ids); on that model, greedy ``generate`` over 8 left-padded
   prompts of seeded lengths 64-256 (``prompt_mask``), 64 new tokens,
   every token within ``GEN_MARGIN`` of the argmax of a teacher-forced,
   cache-free forward of its row (einsum attention), and a sampled call
   repeated with the same generator giving the same ids: prefill ms,
   decode ms a token, tokens/s; (b) ``repetition_penalty=1.3`` and
   ``no_repeat_ngram_size=3``: no 3-gram repeats; ``generate_beam`` with
   4 beams and ``return_scores``: each score within ``BEAM_MARGIN`` of
   its sequence's teacher-forced log-probs over ``len**length_penalty``;
   (c) ``generate_speculative`` (k=4, greedy) with a seeded GPT-2-small
   draft and with the target as its own draft: every token within
   ``GEN_MARGIN`` of the teacher-forced argmax, the self-draft accepting
   >= 95%; acceptance and tokens/s beside ``generate``'s, and the
   sampled mode's acceptance; (e) ``kv_cache_quantize="int8"`` on the
   same weights: agreement with the exact cache, each token within
   ``KV8_MARGIN`` of the exact model's teacher-forced argmax, cache
   bytes 0.5 + 2/head_dim of bf16's; (d) Llama-3-8B at full width and
   ``QUANT_LAYERS`` layers, seeded bf16 weights, then int8 and int4
   trees (``quantize_for_scan_dequant``) in ``QuantizedModel``: every
   quantized leaf within scale/2 of its source, prefill logits against
   the same model with the dequantized weights loaded as plain bf16,
   resident bytes equal to ``quantized_bytes``, the decode's peak above
   them under one layer's bf16 weights plus the cache plus a stated
   activation margin; decode ms a token for bf16, int8 and int4; (f)
   the BERT recipe's ``--lora 8`` through ``build_trainer`` at
   BERT-base, 20 bf16 steps over phase 9's padded rows: trainable count
   = ``lora_param_count``, every base tensor bitwise unchanged, the
   optimizer's state the adapters' alone, the rows' dropout-free loss
   falling, 12 launches of each flash kernel a step, the checkpoint
   ``fit()`` wrote restored into fresh adapters to the bit; then 5 QLoRA
   steps on an int8 base with finite losses. Paths: ``gpt2_sample``
   (the recipe), ``generation`` (a-c, e: no kernel), ``quant`` (d: the
   prefill checks' plain forwards launch the flash forward) and
   ``lora`` (f).

Serve, ResNet, 7a, train, 8a, 9 and each path of 10 set all four kernel
counts to 0 just before their run and read all four just after; a
kernel off the path that launched fails the run.

Output: a ``details`` JSON line (every check and serve number), a
``kernels`` JSON line (each kernel's ``launches`` summed over the paths,
``launches_by_path`` per path as read, and for the flash kernels their
numbers ``at_llama_shape`` and ``at_bert_shape`` per dtype), then the
card's name and power
limit as ``nvidia-smi`` prints them, then the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import sys
import time

# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 (and fp16)
# tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# kernel vs plain tolerances, relative to max|reference|: f32 differs
# only in summation order (chunks of 32-128 keys vs pages of 32, FMA
# contraction), a few ulp of f32; bf16 rounds the probabilities to bf16
# (8-bit mantissa) before P.V at different running maxima, and rounds
# the output, so about 2^-8 of the largest output plus accumulation
F32_RTOL = 1e-5
BF16_RTOL = 2e-2
# greedy tokens vs the dense teacher-forced forward: bf16 weights and
# activations, other matmul shapes and another attention path move the
# logits (themselves bf16 values of magnitude 4-8, ulp 2^-5) by a few
# ulps; on an H100 the worst gap measured 0.156 for the paged tick and
# 0.1875 for the dense tick without the kernel (the A/B below), against
# a reference on the einsum attention, so the margin is 8 such ulps. A
# wrong token sits several units below the max (the logits' spread is
# about 1.3 at std-0.02 weights).
GREEDY_MARGIN = 0.25
# flash kernels vs plain versions (as in tests/test_torch_kernels_cuda.py),
# two limits per tensor: "norm" on ||got - ref|| / ||ref||, which a kernel
# wrong on any sizeable share of rows or keys fails, and "max" on
# max|got - ref| / max|ref|, which one wrong entry near the top fails.
# f32 sums in another order: a few ulp, 5x for the gradients' longer
# sums. bf16: the outputs are bf16, and an entry can land one bf16 step
# apart, at most 2^-7 of itself, where the two round from f32 values a
# few ulp apart; the forward rounds P against its running maximum, which
# differs with the tiling (every 64 keys in the kernel, 128 in the plain
# version), while the backward recomputes P from the same lse on both
# sides, so its entries differ far more rarely. H100 readings over the
# six cases, tensor-core kernels in bf16: max 3.6e-3 (out, sm_scale=1.0)
# and 4.1e-3 (dk); norm 1.4e-3 (out, kv_mask) and 3.1e-4 (dv, GQA); f32:
# norm 8.4e-7 (out) and 1.7e-6 (grads).
# fp16 rounds at the same points with 3 more mantissa bits (11): H100
# readings over tests/test_torch_kernels_cuda.py's 18 cases, BERT's
# padded shape among them: max 5.2e-4 (out) and 5.1e-4 (dk); norm 2.0e-4
# (out) and 1.2e-4 (dv).
FLASH_TOL = {
    "float32": {"out": dict(max=1e-5, norm=1e-5),
                "grad": dict(max=5e-5, norm=1e-5)},
    "bfloat16": {"out": dict(max=1e-2, norm=5e-3),
                 "grad": dict(max=1e-2, norm=1e-3)},
    "float16": {"out": dict(max=2e-3, norm=1e-3),
                "grad": dict(max=2e-3, norm=5e-4)},
}
LSE_TOL = dict(max=1e-5, norm=1e-5)   # f32 in both dtypes
# the repeated batch's loss must fall at least this far (nats) over the
# 10 timed steps: Adam moves each tied-embedding row by ~lr per step, so
# the logits of the batch's tokens rise by roughly lr * sum|h| ~ 0.25 a
# step; a broken gradient leaves the loss where it was
LOSS_DROP = 0.25
# flash vs einsum attention on one bf16 step (dropout off, same weights
# and batch), relative. The loss and global gradient norm read 1.3e-6 and
# 4.6e-5 on an H100; q and k carry only ~18% each of the gradient norm,
# so those two catch a wrong output, not a wrong dq or dk. The q, k and v
# slices of every layer's qkv weight gradient (||flash - einsum|| over
# ||einsum||) do: the kernels round dS to bf16 where the einsum path
# keeps f32, and dq = sum dS K cancels, so they differ by a few 1e-3
# (H100 readings: q 3.5e-3, k 3.7e-3, v 2.3e-3); a zero or wrong dq
# reads ~1.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GNORM_RTOL = 1e-3
TRAIN_QKV_RTOL = 2e-2


def _time_ms(fn, iters):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _graph_ms(fn, iters):
    """``_time_ms`` of ``fn`` captured once in a CUDA graph and replayed:
    the device's time alone. The library calls timed as yardsticks
    (SDPA, its backward op) spend longer on the host per call than
    on the card when the shared host is loaded, so eager timing of them
    measures the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = _time_ms(graph.replay, iters)
    del graph
    return ms


def _paged_case(gen, *, B, W, Hq, Hkv, D, ps, n, dtype, max_len, device,
                lengths=None):
    """A page pool with seeded ragged lengths (or the ``lengths`` given);
    each row owns distinct random pages for its live keys, the rest of its
    table is null page 0, which holds large garbage that must stay
    unobservable."""
    import torch

    if lengths is None:
        lengths = torch.randint(1, max_len + 1, (B,), generator=gen)
    else:
        lengths = torch.tensor(lengths)
    live = [-(-(int(L) + W) // ps) for L in lengths]
    P1 = sum(live) + 1
    perm = torch.randperm(P1 - 1, generator=gen) + 1
    tables = torch.zeros(B, n, dtype=torch.int32)
    off = 0
    for b, k in enumerate(live):
        tables[b, :k] = perm[off:off + k].int()
        off += k
    kw = dict(generator=gen, dtype=torch.float32)
    q = torch.randn(B, W, Hq, D, **kw)
    kp = torch.randn(P1, ps, Hkv, D, **kw)
    vp = torch.randn(P1, ps, Hkv, D, **kw)
    kp[0] = 3e4
    vp[0] = -3e4
    to = lambda t: t.to(device=device, dtype=dtype)  # noqa: E731
    return (to(q), to(kp), to(vp), tables.to(device),
            lengths.int().to(device))


def _live_keys(lengths, W, n, ps, window):
    out = []
    for L in lengths.tolist():
        end = min(L + W, n * ps)
        start = max(0, L - window + 1) if window else 0
        out.append(max(end - start, 0))
    return out


_FLASH_KERNEL = re.compile(
    r"(flash_(?:fwd|dq|dkv)_kernel(?:_tc)?)I(f|13__nv_bfloat16|6__half)"
    r"Li(\d+)E"
)
_MANGLED_DTYPES = {"f": "float32", "13__nv_bfloat16": "bfloat16",
                   "6__half": "float16"}


_TC_KERNELS = ("flash_fwd_kernel_tc", "flash_dq_kernel_tc",
               "flash_dkv_kernel_tc")
_HEAD_DIMS = (16, 32, 64, 128)
_TC_DTYPES = ("bfloat16", "float16")


def flash_label(fn):
    """``"<kernel> <dtype> D=<head_dim>"`` of a mangled flash kernel name,
    or None for any other kernel."""
    m = _FLASH_KERNEL.search(fn)
    if not m:
        return None
    return f"{m.group(1)} {_MANGLED_DTYPES[m.group(2)]} D={m.group(3)}"


def check_flash_routes(report):
    """The flash routes the library must hold, from the build report
    (``{label: ptxas fields and SASS counts}``): bf16 and fp16 forward, dq
    and dkv on the tensor cores (HMMA or HGMMA in their SASS) at every
    head_dim, the bf16 and fp16 forwards without spills up to D = 64; f32
    on the CUDA-core kernels, the forward with no tensor-core instruction;
    and nothing else, so no bf16 or fp16 instantiation of a CUDA-core
    kernel. Raises naming every departure."""
    tc = {f"{k} {t} D={d}" for k in _TC_KERNELS for t in _TC_DTYPES
          for d in _HEAD_DIMS}
    f32 = {f"flash_{k}_kernel float32 D={d}" for k in ("fwd", "dq", "dkv")
           for d in _HEAD_DIMS}
    found = {k for k in report if k.startswith("flash_")}
    wrong = [f"missing {k}" for k in sorted((tc | f32) - found)]
    wrong += [f"unexpected {k}" for k in sorted(found - tc - f32)]
    for k in sorted(tc & found):
        if report[k].get("HMMA", 0) + report[k].get("HGMMA", 0) == 0:
            wrong.append(f"{k}: no tensor-core instructions")
    for t in _TC_DTYPES:
        for d in _HEAD_DIMS[:3]:
            info = report.get(f"flash_fwd_kernel_tc {t} D={d}", {})
            if info.get("spill_stores", 0) or info.get("spill_loads", 0):
                wrong.append(f"flash_fwd_kernel_tc {t} D={d} spills")
    for d in _HEAD_DIMS:
        info = report.get(f"flash_fwd_kernel float32 D={d}", {})
        if info.get("HMMA", 0) + info.get("HGMMA", 0):
            wrong.append(f"flash_fwd_kernel float32 D={d}: tensor-core "
                         "instructions")
    if wrong:
        raise AssertionError("flash kernel routes: " + "; ".join(wrong))


_PAGED_KERNEL = re.compile(
    r"(paged_(?:decode_kernel(?:_tc)?|combine_kernel))"
    r"I(f|13__nv_bfloat16)?(?:Li(\d+)E)?"
)
_PAGED_HEAD_DIMS = (64, 128, 256)


def paged_label(fn):
    """``"<kernel> <dtype>[ D=<head_dim>]"`` of a mangled paged-attention
    kernel name (the tensor-core kernel is bf16 only), or None."""
    m = _PAGED_KERNEL.search(fn)
    if not m:
        return None
    dtype = "float32" if m.group(2) == "f" else "bfloat16"
    return f"{m.group(1)} {dtype}" + (f" D={m.group(3)}" if m.group(3)
                                      else "")


def check_paged_routes(report):
    """The paged-attention routes the library must hold: the bf16 split
    kernel on the tensor cores (HMMA or HGMMA) at every head_dim, without
    spills up to D = 128; the f32 split kernel on the CUDA cores, with no
    tensor-core instruction; a combine kernel for each dtype; and nothing
    else. Raises naming every departure."""
    tc = {f"paged_decode_kernel_tc bfloat16 D={d}" for d in _PAGED_HEAD_DIMS}
    f32 = {f"paged_decode_kernel float32 D={d}" for d in _PAGED_HEAD_DIMS}
    combine = {f"paged_combine_kernel {t}" for t in ("bfloat16", "float32")}
    want = tc | f32 | combine
    found = {k for k in report if k.startswith("paged_")}
    wrong = [f"missing {k}" for k in sorted(want - found)]
    wrong += [f"unexpected {k}" for k in sorted(found - want)]
    for k in sorted(tc & found):
        info = report[k]
        if info.get("HMMA", 0) + info.get("HGMMA", 0) == 0:
            wrong.append(f"{k}: no tensor-core instructions")
        if not k.endswith("D=256") and (info.get("spill_stores", 0)
                                        or info.get("spill_loads", 0)):
            wrong.append(f"{k} spills")
    for k in sorted(f32 & found):
        if report[k].get("HMMA", 0) + report[k].get("HGMMA", 0):
            wrong.append(f"{k}: tensor-core instructions")
    if wrong:
        raise AssertionError("paged kernel routes: " + "; ".join(wrong))


def kernel_report(libs):
    """Each kernel's registers and spills (``ptxas -v``) and the
    tensor-core instructions in its SASS (``cuobjdump``), held to
    :func:`check_flash_routes` and :func:`check_paged_routes`."""
    from pytorch_distributed_tpu_torch.ops import kernel_build

    report = {}
    for name in libs:
        ptxas = kernel_build.ptxas_report(name)
        sass = kernel_build.sass_counts(name)
        for fn, info in sorted(ptxas.items()):
            label = flash_label(fn) or paged_label(fn) or fn
            tc = sass.get(fn, {})
            report[label] = dict(info, **tc)
            print(f"  {name}: {label}: {info.get('registers')} registers, "
                  f"spill stores {info.get('spill_stores')} B, loads "
                  f"{info.get('spill_loads')} B"
                  + (f"; SASS HMMA {tc['HMMA']}, HGMMA {tc['HGMMA']}"
                     if tc else ""))
    check_flash_routes(report)
    check_paged_routes(report)
    return report


def kernel_counts(reset=False):
    """The launch counts of the four kernels' wrappers by kernel name,
    set to 0 first with ``reset``. Each path reads all four around its
    run, so a count that should stay 0 is read, not assumed."""
    from pytorch_distributed_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_tpu_torch.ops.paged_attention import (
        paged_attention,
    )

    fns = (paged_attention, fa.flash_fwd, fa.flash_dq, fa.flash_dkv)
    if reset:
        for fn in fns:
            fn.launches = 0
    return {fn.__name__: fn.launches for fn in fns}


def off_path(counts, on):
    """Fail if a kernel not in ``on`` launched: ``counts`` is a path's."""
    stray = {k: n for k, n in counts.items() if k not in on and n}
    if stray:
        raise AssertionError(f"kernels off this path launched: {stray}")


FLASH = ("flash_fwd", "flash_dq", "flash_dkv")


def paged_cases(shape):
    """The paged checks: (name, W, window, n, lengths or None for seeded
    ragged ones). With the wrapper's split (``pages_per_split``: 8 pages,
    256 keys a CTA at the decode tick), they take a row through every
    split, W = 5 rows whose next split starts just past lengths[b] (there
    query 0 sees none of that split's keys: its carry ends at the -1e30
    sentinel with l > 0, which only the merge's weight wipes), a window
    that leaves the leading splits empty, and buckets of 1 and 2 pages."""
    from pytorch_distributed_tpu_torch.ops.paged_attention import (
        pages_per_split,
    )

    B, n, ps = shape["B"], shape["n"], shape["ps"]
    split_keys = pages_per_split(B, shape["Hkv"], n) * ps
    return (
        ("decode W=1", 1, None, n, None),
        ("verify W=5", 5, None, n, None),
        ("window 256", 1, 256, n, None),
        ("every split", 1, None, n, [n * ps - 1] + [700] * (B - 1)),
        ("split sentinel W=5", 5, None, n,
         [split_keys * (i % (n * ps // split_keys - 1) + 1) - 1
          for i in range(B)]),
        ("window empties leading splits", 1, 256, n,
         [2000 - 250 * i for i in range(B)]),
        ("bucket n=1", 1, None, 1, None),
        ("bucket n=2 W=5", 5, None, 2, None),
    )


def kernel_phase(device, seed):
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_tpu_torch.ops.paged_attention import (
        gather_dense,
        paged_attention,
        pages_per_split,
    )

    gen = torch.Generator().manual_seed(seed)
    shape = dict(B=8, Hq=32, Hkv=8, D=128, ps=32, n=64, max_len=2000)
    checks = []
    same = {}
    main = None
    for dtype, rtol in ((torch.bfloat16, BF16_RTOL), (torch.float32,
                                                       F32_RTOL)):
        dname = str(dtype).replace("torch.", "")
        for name, W, window, n, lengths in paged_cases(shape):
            max_len = min(shape["max_len"], n * shape["ps"] - W)
            q, kp, vp, tables, lengths = _paged_case(
                gen, dtype=dtype, device=device,
                **dict(shape, n=n, max_len=max_len), W=W, lengths=lengths,
            )
            args = dict(page_tables=tables, lengths=lengths, window=window)
            out = paged_attention(q, kp, vp, **args)
            # two launches on the same inputs give the same bits
            same[f"{name} {dname}"] = torch.equal(
                out, paged_attention(q, kp, vp, **args))
            out = out.float()
            torch.cuda.synchronize()
            for impl in ("stream", "gather"):
                ref = paged_attention(q, kp, vp, impl=impl, **args).float()
                err = (out - ref).abs().max().item()
                scale = ref.abs().max().item()
                ok = math.isfinite(err) and err <= rtol * scale
                checks.append(dict(
                    case=name, dtype=dname, plain=impl, max_abs_err=err,
                    max_abs_ref=scale, tol=rtol * scale, ok=ok,
                ))
                print(f"kernel {name} {dname} vs {impl}: max|err| "
                      f"{err:.3e} <= {rtol:g} * max|ref| {scale:.4f} -> "
                      f"{'ok' if ok else 'FAIL'}")
            if dtype is torch.bfloat16 and name == "decode W=1":
                main = (q, kp, vp, tables, lengths)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    print(f"paged kernel bitwise equal over two launches: "
          f"{all(same.values())}")
    if not all(same.values()):
        raise AssertionError(f"the paged kernel is not deterministic: {same}")

    # time at the decode tick's shapes (bf16, W=1)
    q, kp, vp, tables, lengths = main
    B, W, Hq, D = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    n = tables.shape[1]
    pps = pages_per_split(B, Hkv, n)
    ctas = Hkv * -(-(Hq // Hkv * W) // 16) * B * -(-n // pps)
    print(f"split: {pps} pages ({pps * ps} keys) per CTA, grid of {ctas} "
          f"CTAs (B x Hkv = {B * Hkv})")
    if ctas <= B * Hkv:
        raise AssertionError(f"the split leaves {ctas} CTAs <= B x Hkv")
    args = dict(page_tables=tables, lengths=lengths)
    # the kernel's device time, replayed from a CUDA graph as the library
    # call is; eager calls add the ctypes launches and the wrapper's checks
    kernel_ms = _graph_ms(lambda: paged_attention(q, kp, vp, **args), 200)
    eager_ms = _time_ms(lambda: paged_attention(q, kp, vp, **args), 200)
    plain_ms = _time_ms(
        lambda: paged_attention(q, kp, vp, impl="stream", **args), 5
    )
    # the library yardstick: SDPA over the same K/V gathered dense, with
    # the ragged lengths as a boolean mask. Its default (cuDNN) backend
    # lets the null page's large garbage through the mask, so the pages
    # it reads are gathered with a zeroed null page.
    kp0, vp0 = kp.clone(), vp.clone()
    kp0[0], vp0[0] = 0, 0
    kd = gather_dense(kp0, tables).transpose(1, 2)         # [B, Hkv, T, D]
    vd = gather_dense(vp0, tables).transpose(1, 2)
    qd = q.transpose(1, 2)                                 # [B, Hq, W, D]
    kpos = torch.arange(n * ps, device=device)
    mask = (kpos[None, :] <= lengths[:, None].long())[:, None, None, :]
    lib_out = F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True
    ).transpose(1, 2)
    ours = paged_attention(q, kp, vp, **args).float()
    lib_err = (lib_out.float() - ours).abs().max().item()
    garbage_out = F.scaled_dot_product_attention(
        qd, gather_dense(kp, tables).transpose(1, 2),
        gather_dense(vp, tables).transpose(1, 2), attn_mask=mask,
        enable_gqa=True,
    ).transpose(1, 2)
    garbage_err = (garbage_out.float() - ours).abs().max().item()
    library_ms = _graph_ms(
        lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True
        ), 200,
    )
    live = _live_keys(lengths, W, n, ps, None)
    itemsize = q.element_size()
    nbytes = (sum(live) * Hkv * D * 2 * itemsize     # K and V, read once
              + 2 * q.numel() * itemsize              # q in, out
              + tables.numel() * 4 + lengths.numel() * 4)
    flops = sum(live) * Hq * W * D * 4                # QK^T and PV
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    record = dict(
        name="paged_attention", route="cuda",
        source="pytorch_distributed_tpu_torch/csrc/paged_attention.cu",
        replaces="pytorch_distributed_tpu/ops/paged_attention.py:423",
        launches=None,
        max_abs_err=max(c["max_abs_err"] for c in checks
                        if c["case"] == "decode W=1"
                        and c["dtype"] == "bfloat16"),
        ms=kernel_ms, eager_ms=eager_ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms,
    )
    print(f"kernel time {kernel_ms:.4f} ms (graph replay; eager "
          f"{eager_ms:.4f} ms; {nbytes / kernel_ms / 1e6:.0f} GB/s), plain "
          f"(stream) {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (max|diff| "
          f"vs kernel {lib_err:.3e}; {garbage_err:.3e} with the null page's "
          f"garbage left in), bound {record['bound_ms']:.4f} ms ({nbytes} "
          f"bytes, {flops} flops)")
    details = dict(checks=checks, deterministic=same, bytes=nbytes,
                   flops=flops, live_keys=live, pages_per_split=pps,
                   ctas=ctas, sdpa_max_abs_diff=lib_err,
                   sdpa_max_abs_diff_null_page_garbage=garbage_err)
    return record, details


# --------------------------------------------------------------------------
# flash attention kernels (csrc/flash_attention.cu)
# --------------------------------------------------------------------------

_TRAIN_SHAPE = dict(B=8, S=1024, T=1024, Hq=16, Hkv=16, D=64)
# Llama-3-8B's training shape (phase 8b): 32 query heads over 8 kv heads
# of 128, causal, batch 8 x 2048
_LLAMA_SHAPE = dict(B=8, S=2048, T=2048, Hq=32, Hkv=8, D=128)
# BERT-base's fine-tune batch (phase 9): 12 heads of 64, non-causal, a
# padded tail per row (lengths 16-128, as padded GLUE sentences)
_BERT_SHAPE = dict(B=32, S=128, T=128, Hq=12, Hkv=12, D=64)
_BERT_PAD = {"lengths": (16, 128)}
FLASH_CASES = (
    # name, shape, causal, extras
    ("train", _TRAIN_SHAPE, True, {}),
    ("llama_train", _LLAMA_SHAPE, True, {}),
    ("packed", _TRAIN_SHAPE, True, {"packed": True}),
    ("kv_mask", dict(_TRAIN_SHAPE, B=4), False, {"kv_mask": True}),
    ("gqa_llama", dict(B=2, S=2048, T=2048, Hq=32, Hkv=8, D=128), False, {}),
    ("sm_scale_1", dict(_TRAIN_SHAPE, B=2, S=512, T=512), True,
     {"sm_scale": 1.0}),
    ("ragged_1000", dict(_TRAIN_SHAPE, B=4, S=1000, T=1000), True, {}),
    ("bert", _BERT_SHAPE, False, _BERT_PAD),
)
FLASH_DTYPES = ("bfloat16", "float16", "float32")
_REPLACES = {
    "flash_fwd": "pytorch_distributed_tpu/ops/flash_attention.py:80",
    "flash_dq": "pytorch_distributed_tpu/ops/flash_attention.py:234",
    "flash_dkv": "pytorch_distributed_tpu/ops/flash_attention.py:288",
}


def _packed_rows(seed, rows, S, vocab):
    """``rows`` packed rows of S tokens from documents of seeded lengths
    64-900 (``pack_documents``'s first-fit)."""
    import numpy as np

    from pytorch_distributed_tpu_torch import pack_documents

    rng = np.random.default_rng(seed)
    docs = []
    while True:
        docs.append(rng.integers(1, vocab, size=int(rng.integers(64, 901))))
        packed = pack_documents(docs, S)
        if len(packed["input_ids"]) > rows:
            return {k: v[:rows] for k, v in packed.items()}


def _flash_inputs(gen, seed, shape, dtype, device, extras):
    import torch

    from pytorch_distributed_tpu_torch.ops import flash_attention as fa

    B, S, T, Hq, Hkv, D = (shape[k] for k in ("B", "S", "T", "Hq", "Hkv",
                                              "D"))
    q = torch.randn(B, S, Hq, D, generator=gen)
    k = torch.randn(B, T, Hkv, D, generator=gen)
    v = torch.randn(B, T, Hkv, D, generator=gen)
    bias = seg = None
    if extras.get("kv_mask") or "lengths" in extras:
        # a ragged padded tail per row, lengths in [lo, hi]
        lo, hi = extras.get("lengths", (T // 2, T))
        lengths = torch.randint(lo, hi + 1, (B,), generator=gen)
        keep = torch.arange(T)[None, :] < lengths[:, None]
        bias = torch.zeros(B, T).masked_fill(~keep, fa._NEG_INF).to(device)
    if extras.get("packed"):
        seg = torch.from_numpy(
            _packed_rows(seed, B, S, 50257)["segment_ids"]
        ).to(device)
    to = lambda t: t.to(device=device, dtype=dtype)  # noqa: E731
    return to(q), to(k), to(v), bias, seg


def _live_pairs(B, S, T, Hq, causal, bias, seg):
    """(query, key) pairs the masks leave live, over every head: the
    work this run's data needs."""
    import torch

    dev = bias.device if bias is not None else (
        seg.device if seg is not None else "cpu")
    keep = torch.ones(B, S, T, dtype=torch.bool, device=dev)
    if causal:
        keep &= (torch.arange(S, device=dev)[:, None]
                 >= torch.arange(T, device=dev)[None, :])
    if bias is not None:
        keep &= (bias == 0)[:, None, :]
    if seg is not None:
        keep &= seg[:, :, None] == seg[:, None, :]
    return int(keep.sum().item()) * Hq


def flash_phase(device, seed):
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from pytorch_distributed_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(seed + 1)
    checks = []
    worst = {}
    for dname in FLASH_DTYPES:
        dtype = getattr(torch, dname)
        tol = FLASH_TOL[dname]
        for name, shape, causal, extras in FLASH_CASES:
            q, k, v, bias, seg = _flash_inputs(gen, seed, shape, dtype,
                                               device, extras)
            kw = dict(sm_scale=extras.get("sm_scale",
                                          shape["D"] ** -0.5),
                      causal=causal)
            out, lse = fa.flash_fwd(q, k, v, bias, seg, **kw)
            ref, ref_lse = fa._flash_fwd_plain(q, k, v, bias, seg, **kw)
            dout = torch.randn(out.shape, generator=gen).to(device, dtype)
            delta = fa._delta(dout, out)
            args = (q, k, v, dout, lse, delta, bias, seg)
            dq = fa.flash_dq(*args, **kw)
            dk, dv = fa.flash_dkv(*args, **kw)
            ref_dk, ref_dv = fa._flash_dkv_plain(*args, **kw)
            pairs = (
                ("out", out, ref, tol["out"]),
                ("lse", lse, ref_lse, LSE_TOL),
                ("dq", dq, fa._flash_dq_plain(*args, **kw), tol["grad"]),
                ("dk", dk, ref_dk, tol["grad"]),
                ("dv", dv, ref_dv, tol["grad"]),
            )
            torch.cuda.synchronize()
            for what, got, want, lim in pairs:
                want = want.float()
                diff = got.float() - want
                err = diff.abs().max().item()
                scale = want.abs().max().item()
                norm = (diff.norm() / want.norm()).item()
                ok = (math.isfinite(err) and err <= lim["max"] * scale
                      and norm <= lim["norm"])
                checks.append(dict(case=name, dtype=dname, what=what,
                                   max_abs_err=err, max_abs_ref=scale,
                                   tol=lim["max"] * scale, norm_rel_err=norm,
                                   norm_tol=lim["norm"], ok=ok))
                print(f"flash {name} {dname} {what}: max|err| {err:.3e} <= "
                      f"{lim['max']:g} * max|ref| {scale:.4f}, norm "
                      f"{norm:.3e} <= {lim['norm']:g} -> "
                      f"{'ok' if ok else 'FAIL'}")
                worst.setdefault(dname, {}).setdefault(name, {})[what] = err
            del q, k, v, out, ref, dout, dq, dk, dv, ref_dk, ref_dv, pairs
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"flash kernels disagree with plain: {bad}")

    records, details = _flash_times(gen, seed, _TRAIN_SHAPE, device,
                                    worst["bfloat16"]["train"])
    details["checks"] = checks
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    # 8b: the same kernels at Llama-3-8B's training shape, beside the
    # GPT-2 records as their ``at_llama_shape``
    lrecords, ldetails = _flash_times(gen, seed, _LLAMA_SHAPE, device,
                                      worst["bfloat16"]["llama_train"])
    for rec, lrec in zip(records, lrecords):
        rec["at_llama_shape"] = {k: lrec[k] for k in keys}
    details["llama_shape"] = ldetails
    # phase 9's shape: BERT-base, non-causal with its padding, in bf16
    # and in fp16, as ``at_bert_shape``
    details["bert_shape"] = {}
    for dname in ("bfloat16", "float16"):
        # one generator a dtype: both time the same tensors and mask
        bgen = torch.Generator().manual_seed(seed + 2)
        brecords, bdetails = _flash_times(
            bgen, seed, _BERT_SHAPE, device, worst[dname]["bert"],
            dtype=getattr(torch, dname), causal=False, extras=_BERT_PAD)
        for rec, brec in zip(records, brecords):
            rec.setdefault("at_bert_shape", {})[dname] = {
                k: brec[k] for k in keys}
        details["bert_shape"][dname] = bdetails
    return records, details


def _flash_times(gen, seed, shape, device, worst, *, dtype=None,
                 causal=True, extras=None):
    """The three kernels at ``shape`` (bf16 and causal unless given;
    ``extras`` as ``_flash_inputs`` takes them: a padding mask): bitwise
    equal over two launches, then each one's time replayed from a CUDA
    graph beside its eager time, its plain version's, its bound and
    ``scaled_dot_product_attention``'s. Without a mask the yardstick is
    SDPA's flash backend (K/V expanded to the query heads outside the
    timed region when the shape has GQA: that backend takes equal head
    counts); with one it is the memory-efficient backend, the one that
    takes an additive bias, given the mask as a ``[B, H, S, T]`` bias in
    the input dtype (made outside the timed region)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from pytorch_distributed_tpu_torch.ops import flash_attention as fa

    dtype = dtype or torch.bfloat16
    B, S, T, Hq, Hkv, D = (shape[k] for k in ("B", "S", "T", "Hq", "Hkv",
                                              "D"))
    q, k, v, bias, seg = _flash_inputs(gen, seed, shape, dtype, device,
                                       extras or {})
    kw = dict(sm_scale=D ** -0.5, causal=causal)
    out, lse = fa.flash_fwd(q, k, v, bias, seg, **kw)
    dout = torch.randn(out.shape, generator=gen).to(device, out.dtype)
    delta = fa._delta(dout, out)
    bargs = (q, k, v, dout, lse, delta, bias, seg)
    # two launches on the same inputs give the same bits (no atomics)
    same = {
        "flash_fwd": all(torch.equal(a, b) for a, b in zip(
            fa.flash_fwd(q, k, v, bias, seg, **kw),
            fa.flash_fwd(q, k, v, bias, seg, **kw))),
        "flash_dq": torch.equal(fa.flash_dq(*bargs, **kw),
                                fa.flash_dq(*bargs, **kw)),
        "flash_dkv": all(torch.equal(a, b) for a, b in zip(
            fa.flash_dkv(*bargs, **kw), fa.flash_dkv(*bargs, **kw))),
    }
    print(f"bitwise equal over two launches: {same}")
    if not all(same.values()):
        raise AssertionError(f"a flash kernel is not deterministic: {same}")
    calls = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, bias, seg, **kw),
        "flash_dq": lambda: fa.flash_dq(*bargs, **kw),
        "flash_dkv": lambda: fa.flash_dkv(*bargs, **kw),
    }
    # the kernels' device time, replayed from a CUDA graph as the library
    # calls are; eager calls add the ctypes launch and the wrappers' checks
    ms = {name: _graph_ms(fn, 50) for name, fn in calls.items()}
    eager_ms = {name: _time_ms(fn, 20) for name, fn in calls.items()}
    plain_ms = {
        "flash_fwd": _time_ms(
            lambda: fa._flash_fwd_plain(q, k, v, bias, seg, **kw), 3),
        "flash_dq": _time_ms(lambda: fa._flash_dq_plain(*bargs, **kw), 3),
        "flash_dkv": _time_ms(lambda: fa._flash_dkv_plain(*bargs, **kw), 3),
    }
    # the library yardsticks (never called by the port), on the same
    # tensors in SDPA's [B, H, S, D] layout. The backward is the backend's
    # aten op alone, fed the out and logsumexp of its forward made outside
    # the graph: one call for dq, dk and dv, so the dq and dkv kernels
    # share it (hold dq_ms + dkv_ms against it)
    group = Hq // Hkv
    qt, kt, vt = (t.repeat_interleave(group, dim=2).transpose(1, 2)
                  if t is not q and group > 1 else t.transpose(1, 2)
                  for t in (q, k, v))
    aten = torch.ops.aten
    gout = torch.empty(B, Hq, S, D, dtype=dtype,
                       device=device).copy_(dout.transpose(1, 2))
    scale = kw["sm_scale"]
    if bias is None:
        backend = "flash"
        lib = aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, causal, False, scale=scale)
        lo, llse, cum_q, cum_k, max_q, max_k, seed_t, offset_t = lib[:8]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)

        def sdpa_bwd():
            return aten._scaled_dot_product_flash_attention_backward(
                gout, qt, kt, vt, lo, llse, cum_q, cum_k, max_q, max_k, 0.0,
                causal, seed_t, offset_t, scale=scale)

        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            lib_fwd = _graph_ms(sdpa_fwd, 20)
            lib_out = sdpa_fwd()
    else:
        backend = "efficient"
        if causal:
            raise ValueError("the masked yardstick is non-causal")
        abias = bias.to(dtype)[:, None, None, :].expand(
            B, Hq, S, T).contiguous()
        lo, llse, seed_t, offset_t = (
            aten._scaled_dot_product_efficient_attention(
                qt, kt, vt, abias, True, 0.0, False, scale=scale))

        def sdpa_fwd():
            return aten._scaled_dot_product_efficient_attention(
                qt, kt, vt, abias, False, 0.0, False, scale=scale)[0]

        def sdpa_bwd():
            return aten._scaled_dot_product_efficient_attention_backward(
                gout, qt, kt, vt, abias, lo, llse, seed_t, offset_t, 0.0,
                [True, True, True, False], False, scale=scale)

        lib_fwd = _graph_ms(sdpa_fwd, 20)
        lib_out = sdpa_fwd()
    lib_err = (lib_out.transpose(1, 2).float() - out.float()).abs().max()
    lib_err = lib_err.item()
    lib_bwd = _graph_ms(sdpa_bwd, 20)
    lib_dq = sdpa_bwd()[0].transpose(1, 2).float()
    lib_dq_err = (lib_dq - fa.flash_dq(*bargs, **kw).float()).abs().max()
    lib_dq_err = lib_dq_err.item()
    pairs = _live_pairs(B, S, T, Hq, causal, bias, seg)
    n_q, n_kv, rows = B * S * Hq * D, B * T * Hkv * D, B * Hq * S
    item = q.element_size()
    extra = 4 * B * T if bias is not None else 0   # the f32 bias row
    work = {   # (bytes: each input read once, each output written once; flops)
        "flash_fwd": ((2 * n_q + 2 * n_kv) * item + 4 * rows + extra,
                      4 * D * pairs),
        "flash_dq": ((3 * n_q + 2 * n_kv) * item + 8 * rows + extra,
                     6 * D * pairs),
        "flash_dkv": ((2 * n_q + 4 * n_kv) * item + 8 * rows + extra,
                      8 * D * pairs),
    }
    dname = str(dtype).replace("torch.", "")
    records = []
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        nbytes, flops = work[name]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS * 1e3
        err = {"flash_fwd": worst["out"], "flash_dq": worst["dq"],
               "flash_dkv": max(worst["dk"], worst["dv"])}[name]
        records.append(dict(
            name=name, route="cuda",
            source="pytorch_distributed_tpu_torch/csrc/flash_attention.cu",
            replaces=_REPLACES[name], launches=None, max_abs_err=err,
            ms=ms[name], plain_ms=plain_ms[name],
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=lib_fwd if name == "flash_fwd" else lib_bwd,
        ))
        print(f"{name} at {shape} {dname}{' causal' if causal else ''}"
              f"{' padded' if bias is not None else ''}: {ms[name]:.4f} ms "
              f"(graph replay; eager {eager_ms[name]:.4f} ms), plain "
              f"{plain_ms[name]:.4f} ms, bound "
              f"{max(bytes_ms, ops_ms):.4f} ms ({nbytes} bytes, {flops} "
              f"flops), {flops / ms[name] / 1e9:.1f} TFLOP/s")
    print(f"sdpa ({backend} backend): forward {lib_fwd:.4f} ms (max|diff| "
          f"vs the forward kernel {lib_err:.3e}), backward {lib_bwd:.4f} ms "
          f"(dq max|diff| vs the dq kernel {lib_dq_err:.3e}) against dq + "
          f"dkv {ms['flash_dq'] + ms['flash_dkv']:.4f} ms")
    details = dict(shape=shape, dtype=dname, causal=causal,
                   padded=bias is not None, live_pairs=pairs,
                   eager_ms=eager_ms, deterministic=same,
                   sdpa_backend=backend, sdpa_fwd_ms=lib_fwd,
                   sdpa_bwd_ms=lib_bwd, sdpa_max_abs_diff=lib_err,
                   sdpa_bwd_dq_max_abs_diff=lib_dq_err,
                   work={k: dict(bytes=b, flops=f)
                         for k, (b, f) in work.items()})
    return records, details


# --------------------------------------------------------------------------
# train GPT-2-medium
# --------------------------------------------------------------------------

TRAIN_STEPS = 10     # timed steps on one repeated batch
PACKED_STEPS = 3     # then steps of 2 microbatches on packed rows


class GCTimer:
    """Time the host spends in Python's cyclic garbage collector while
    the block runs (``gc.callbacks``): ``ms`` and ``count`` by
    generation. A host-bound step pays a collection where it happens."""

    def __init__(self):
        self.ms, self.count, self._t0 = [0.0] * 3, [0] * 3, None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.ms[g] += 1e3 * (time.perf_counter() - self._t0)
            self.count[g] += 1
            self._t0 = None

    def __enter__(self):
        import gc

        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._on_gc)
        return False


def profile_step(step, state, batch):
    """Device time by kernel over two steps, from torch.profiler:
    (total busy us, [(kernel, us, count)] largest first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): host-side records
        # carry their children's device time too and would count it twice,
        # and so do the device-timeline copies of annotated host ranges
        # (the optimizer's "Optimizer.step#AdamW.step")
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us:
            rows.append((e.key, float(us), int(e.count)))
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def train_phase(device, seed, flash_records):
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_tpu_torch import (
        ArrayDataset,
        DataLoader,
        GPT2Config,
        GPT2LMHead,
        Policy,
        SyntheticTextDataset,
        Trainer,
        TrainerConfig,
        TrainState,
        build_train_step,
        causal_lm_loss_fn,
        optim,
    )
    from pytorch_distributed_tpu_torch.runtime import tracing

    cfg = GPT2Config.medium()
    policy = Policy.train()
    B, S = 8, 1024
    # earlier phases can leave memory allocated (0.07-1.06 GiB after the
    # ZeRO-1 phase on the H100, varying from run to run: see
    # scripts/port_smoke_memory.py); the peak is this phase's own, above it
    gc.collect()
    torch.cuda.empty_cache()
    left_mem = torch.cuda.memory_allocated(device) / 2**30
    t0 = time.perf_counter()
    model = GPT2LMHead(cfg, device=device, policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: GPT-2-medium, {n_params} params in f32, bf16 products, "
          f"seeded init {time.perf_counter() - t0:.1f} s")
    opt = optim.clip_grad_norm(
        optim.AdamW(model, lr=3e-4, weight_decay=1e-4), 1.0
    )
    state = TrainState(model, opt, policy=policy)
    loss_fn = causal_lm_loss_fn(model)
    step1 = build_train_step(loss_fn, accum_steps=1)
    step2 = build_train_step(loss_fn, accum_steps=2)
    rows = SyntheticTextDataset(n=B, seq_len=S, vocab_size=cfg.vocab_size,
                                seed=seed)
    batch = np.stack([rows[i]["input_ids"] for i in range(B)])
    repeated = DataLoader(
        ArrayDataset(input_ids=np.tile(batch, (TRAIN_STEPS, 1))), B,
        shuffle=False,
    )
    packed = DataLoader(
        ArrayDataset(**_packed_rows(seed, PACKED_STEPS * B, S,
                                    cfg.vocab_size)), B, shuffle=False,
    )
    dev_batch = {"input_ids": torch.from_numpy(batch).to(device)}

    # warm-up (cuBLAS handles, allocator) on the same batch
    for _ in range(2):
        state, metrics = step1(state, dev_batch)
    first_loss = float(metrics["loss"])
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(device)
    held_mem = torch.cuda.memory_allocated(device) / 2**30
    kernel_counts(reset=True)
    with tracing.enabled() as tracer:   # the main path
        t0 = time.perf_counter()
        main = Trainer(state, step1, repeated,
                       config=TrainerConfig(log_every=1))
        main.fit()
        pk = Trainer(main.state, step2, packed,
                     config=TrainerConfig(log_every=1))
        pk.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    state = pk.state
    counts = kernel_counts()
    off_path(counts, FLASH)
    launches = {k: counts[k] for k in FLASH}
    peak_mem = torch.cuda.max_memory_allocated(device) / 2**30 - left_mem
    microbatches = TRAIN_STEPS * 1 + PACKED_STEPS * 2
    want = cfg.num_layers * microbatches
    print(f"train: {TRAIN_STEPS} steps x 1 + {PACKED_STEPS} packed steps x 2"
          f" microbatches in {wall:.2f} s; launches {launches} (want "
          f"{want} each = {cfg.num_layers} layers x {microbatches} "
          f"microbatches)")
    if any(n != want for n in launches.values()):
        raise AssertionError(f"flash launches {launches} != {want} each")
    losses = [r["loss"] for r in main.history]
    packed_losses = [r["loss"] for r in pk.history]
    if len(losses) != TRAIN_STEPS or len(packed_losses) != PACKED_STEPS:
        raise AssertionError(f"logged {len(losses)} + {len(packed_losses)} "
                             "steps")
    if not all(math.isfinite(x) for x in losses + packed_losses):
        raise AssertionError(f"non-finite loss: {losses} {packed_losses}")
    print(f"losses on the repeated batch: {first_loss:.4f} (warm-up) then "
          + " ".join(f"{x:.4f}" for x in losses)
          + "; packed: " + " ".join(f"{x:.4f}" for x in packed_losses))
    if losses[-1] > losses[0] - LOSS_DROP:
        raise AssertionError(
            f"the repeated batch's loss went {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, less than the {LOSS_DROP} drop required"
        )
    step_s = sorted(r["step_time_s"] for r in main.history)
    step_ms = 1e3 * step_s[len(step_s) // 2]
    tokens_s = B * S / (step_ms / 1e3)
    kernel_ms = {r["name"]: r["ms"] for r in flash_records}
    est_share = cfg.num_layers * sum(kernel_ms.values()) / step_ms
    roll = tracer.rollups()
    total_us, rows = profile_step(step1, state, dev_batch)
    flash_us = sum(r[1] for r in rows if "flash_" in r[0] and "kernel" in r[0])
    top = rows[:12]
    print(f"train step (batch {B} x {S}, median of {TRAIN_STEPS}): "
          f"{step_ms:.2f} ms, {tokens_s:.0f} tokens/s, peak memory "
          f"{peak_mem:.2f} GiB ({held_mem - left_mem:.2f} GiB of it held "
          f"before the first step: weights, gradients, moments; "
          f"{left_mem:.3f} GiB that earlier phases left not counted); "
          f"flash kernels ~{100 * est_share:.1f}% of "
          f"the step (24 x their timed ms)")
    if total_us:
        print(f"profiler, 2 steps: device busy {total_us / 2e3:.2f} ms/step "
              f"(idle {100 * (1 - total_us / 2e3 / step_ms):.1f}% of the "
              f"unprofiled step), flash kernels {flash_us / 2e3:.2f} ms/step "
              f"({100 * flash_us / total_us:.1f}% of device time)")
        for key, us, count in top:
            print(f"  {us / 2e3:9.3f} ms/step  x{count // 2:<5d} {key[:90]}")
    else:
        print("profiler: no device time recorded (not measured)")

    # flash vs the einsum attention on one step's loss and gradients,
    # dropout off, same weights and batch (not counted: read above)
    ids = dev_batch["input_ids"].long()
    D = cfg.hidden_size
    ab = {}
    for impl in (None, "xla"):
        model.zero_grad(set_to_none=True)
        logits = model(ids, attn_impl=impl)
        loss = F.cross_entropy(
            logits[:, :-1].float().reshape(-1, cfg.vocab_size),
            ids[:, 1:].reshape(-1),
        )
        loss.backward()
        gnorm = optim.global_norm([p.grad for p in model.parameters()])
        qkv = torch.stack([b.attn_qkv.weight.grad for b in model.blocks])
        ab[impl or "flash"] = (loss.item(), gnorm.item(), qkv)
        del logits, loss
    (lf, gf, qkv_f), (lx, gx, qkv_x) = ab["flash"], ab["xla"]
    qkv_rel = {}
    for i, part in enumerate("qkv"):   # [L, 3D, D] rows: q, k, v
        f, x = qkv_f[:, i * D:(i + 1) * D], qkv_x[:, i * D:(i + 1) * D]
        qkv_rel[part] = ((f - x).norm() / x.norm()).item()
    del ab, qkv_f, qkv_x
    rel = dict(loss=abs(lf - lx) / abs(lx), grad_norm=abs(gf - gx) / gx)
    print(f"flash vs einsum attention: loss {lf:.6f} vs {lx:.6f} (rel "
          f"{rel['loss']:.2e} <= {TRAIN_LOSS_RTOL:g}), grad norm {gf:.6f} vs "
          f"{gx:.6f} (rel {rel['grad_norm']:.2e} <= {TRAIN_GNORM_RTOL:g}), "
          "qkv weight gradients "
          + ", ".join(f"{k} {v:.2e}" for k, v in qkv_rel.items())
          + f" (<= {TRAIN_QKV_RTOL:g})")
    if (rel["loss"] > TRAIN_LOSS_RTOL or rel["grad_norm"] > TRAIN_GNORM_RTOL
            or max(qkv_rel.values()) > TRAIN_QKV_RTOL):
        raise AssertionError("flash and einsum attention disagree on a step")
    stats = dict(
        params=n_params, batch=B, seq=S, steps=TRAIN_STEPS,
        packed_steps=PACKED_STEPS, launches=launches, wall_s=wall,
        warmup_loss=first_loss, losses=losses, packed_losses=packed_losses,
        step_ms_median=step_ms, step_ms=[1e3 * x for x in step_s],
        tokens_per_s=tokens_s, peak_mem_gib=peak_mem,
        held_mem_gib=held_mem - left_mem, left_mem_gib=left_mem,
        flash_share_from_kernel_ms=est_share,
        profile_device_ms_per_step=total_us / 2e3,
        profile_flash_ms_per_step=flash_us / 2e3,
        profile_top=[dict(name=k, ms_per_step=us / 2e3, count=c // 2)
                     for k, us, c in top],
        spans={k: roll[k]["mean_ms"] for k in roll},
        flash_vs_einsum=dict(loss=[lf, lx], grad_norm=[gf, gx],
                             rel=rel, qkv_grad_rel=qkv_rel),
    )
    del model, opt, state, main, pk, step1, step2, loss_fn, dev_batch, ids
    gc.collect()
    torch.cuda.empty_cache()
    return counts, stats



def _requests(seed, vocab):
    """8 requests: seeded prompt lengths 64-1024 and 32-64 new tokens;
    requests 6 and 7 sample (T 0.8, top_p 0.95); request 7 repeats
    request 0's first 256 tokens (it is submitted after request 0's
    prefill has registered them, so it maps those pages shared)."""
    import numpy as np

    from pytorch_distributed_tpu_torch.serve import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(8):
        P = int(rng.integers(64, 1025))
        if i in (0, 7):
            P = max(P, 300)   # longer than the shared 256-token prefix
        prompt = rng.integers(1, vocab, size=P).astype(np.int32)
        if i == 7:
            prompt[:256] = reqs[0].prompt_ids[:256]
        sampled = i >= 6
        reqs.append(Request(
            prompt_ids=prompt, max_new_tokens=int(rng.integers(32, 65)),
            temperature=0.8 if sampled else 0.0,
            top_p=0.95 if sampled else None, seed=100 + i,
            request_id=f"r{i}",
        ))
    return reqs


def _drive(model, ecfg, reqs):
    """Serve ``reqs`` on a fresh engine: the first 7 at once, the last
    once request 0 decodes (so its prefix pages are registered)."""
    import torch

    from pytorch_distributed_tpu_torch import RequestStatus, ServeEngine
    from pytorch_distributed_tpu_torch.runtime import tracing

    engine = ServeEngine(model, ecfg)
    with tracing.enabled() as tracer:
        t0 = time.perf_counter()
        handles = [engine.submit(r) for r in reqs[:7]]
        while handles[0].status is not RequestStatus.DECODING:
            engine.step()
        handles.append(engine.submit(reqs[7]))
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for r, h in zip(reqs, handles):
        if h.status is not RequestStatus.COMPLETED or len(h.tokens) != (
            r.max_new_tokens
        ):
            raise AssertionError(
                f"{ecfg.decode_mode} {r.request_id}: {h.status} with "
                f"{len(h.tokens)} of {r.max_new_tokens} tokens"
            )
    engine.pool.check_consistency()
    roll = tracer.rollups()
    tick = [roll[k] for k in ("serve.decode_tick", "serve.token_fetch")]
    return engine, handles, dict(
        wall_s=wall,
        decode_tick_ms=sum(x["mean_ms"] for x in tick),
        decode_tick_ms_p50=sum(x["p50_ms"] for x in tick),
        prefill_chunk_ms=roll["serve.prefill_chunk"]["mean_ms"],
    )


def _teacher_gaps(model, reqs, handles, device):
    """For every greedy token: the dense teacher-forced forward's max
    logit minus the logit of the token the engine chose. The forward
    takes the einsum attention, so the reference runs no kernel."""
    import torch

    gaps, exact = [], 0
    with torch.no_grad():
        for r, h in zip(reqs, handles):
            if r.temperature > 0:
                continue
            seq = torch.tensor(
                list(r.prompt_ids) + h.tokens, device=device
            )[None].long()
            logits = model(seq, attn_impl="xla")[0, r.prompt_len - 1:-1]
            if not torch.isfinite(logits).all():
                raise AssertionError(f"{r.request_id}: non-finite logits")
            toks = torch.tensor(h.tokens, device=device)
            mine = logits.gather(1, toks[:, None])[:, 0]
            gaps.extend((logits.max(dim=-1).values - mine).tolist())
            exact += int((logits.argmax(dim=-1) == toks).sum())
    return exact, gaps


def serve_phase(device, seed):
    import torch

    from pytorch_distributed_tpu_torch import (
        EngineConfig,
        LlamaConfig,
        LlamaForCausalLM,
        ServeEngine,
    )
    from pytorch_distributed_tpu_torch.serve import Request

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    model.requires_grad_(False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: Llama-3-8B, {n_params} params in bf16, seeded init "
          f"{init_s:.1f} s")
    ecfg = EngineConfig(num_slots=8, max_len=2048, prefill_chunk=256)

    # warm-up (cuBLAS handles, allocator) on its own engine
    warm = ServeEngine(model, ecfg)
    warm.submit(Request(prompt_ids=list(range(1, 40)), max_new_tokens=4))
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()

    reqs = _requests(seed, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats(device)
    kernel_counts(reset=True)
    engine, handles, timing = _drive(model, ecfg, reqs)   # the main path
    counts = kernel_counts()
    off_path(counts, ("paged_attention",))
    launches = counts["paged_attention"]
    ticks = engine.decode_ticks
    summary = engine.telemetry.summary()
    peak_mem = torch.cuda.max_memory_allocated(device) / 2**30
    if engine.pool.prefix_hits < 1:
        raise AssertionError("the shared 256-token prefix was not shared")
    if launches != ticks * cfg.num_layers:
        raise AssertionError(
            f"paged_attention launched {launches} times over {ticks} "
            f"decode ticks x {cfg.num_layers} layers"
        )
    print(f"serve: {len(reqs)} requests completed, {ticks} decode ticks, "
          f"{launches} kernel launches (= ticks x {cfg.num_layers}), "
          f"prefix hits {engine.pool.prefix_hits}")
    exact, gaps = _teacher_gaps(model, reqs, handles, device)
    worst = max(gaps)
    print(f"greedy vs teacher-forced: {exact}/{len(gaps)} exact argmax, "
          f"worst logit gap {worst:.4f} (margin {GREEDY_MARGIN})")
    if worst > GREEDY_MARGIN:
        raise AssertionError(
            f"a greedy token sits {worst:.4f} below the teacher-forced "
            f"argmax (margin {GREEDY_MARGIN})"
        )
    stats = dict(
        requests=len(reqs), decode_ticks=ticks, launches=launches,
        tokens_per_s=summary["tokens_per_sec"],
        completed_tokens=summary["completed_tokens"],
        ttft_ms_p50=summary["ttft_ms_p50"], ttft_ms_p99=summary["ttft_ms_p99"],
        peak_pages=engine.pool.peak_pages, pages_total=engine.pool.num_pages,
        prefix_hits=engine.pool.prefix_hits, peak_mem_gib=peak_mem,
        greedy_exact=exact, greedy_tokens=len(gaps), greedy_worst_gap=worst,
        greedy_margin=GREEDY_MARGIN, model_init_s=init_s, **timing,
    )
    print(f"serve: {stats['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{stats['ttft_ms_p50']:.1f} ms p99 {stats['ttft_ms_p99']:.1f} ms, "
          f"decode tick {timing['decode_tick_ms']:.2f} ms, prefill chunk "
          f"{timing['prefill_chunk_ms']:.2f} ms, peak pages "
          f"{stats['peak_pages']}/{stats['pages_total']}, peak memory "
          f"{peak_mem:.1f} GiB")

    # A/B: the same requests through the dense-gather tick (no kernel),
    # which also shows the bf16 noise floor of the teacher-forced check
    del engine
    dense_engine, dhandles, dtiming = _drive(
        model, dataclasses.replace(ecfg, decode_mode="dense"), reqs
    )
    dexact, dgaps = _teacher_gaps(model, reqs, dhandles, device)
    print(f"dense A/B: decode tick {dtiming['decode_tick_ms']:.2f} ms, "
          f"greedy vs teacher-forced {dexact}/{len(dgaps)} exact, worst "
          f"gap {max(dgaps):.4f}")
    if max(dgaps) > GREEDY_MARGIN:
        raise AssertionError("the dense tick misses the teacher-forced check")
    stats["dense"] = dict(greedy_exact=dexact, greedy_worst_gap=max(dgaps),
                          **dtiming)
    return counts, stats

# --------------------------------------------------------------------------
# ResNet-50 data-parallel training
# --------------------------------------------------------------------------

RESNET_BATCH, RESNET_IMAGE = 128, 224      # bench.py's primary shape
RESNET_WARMUP, RESNET_STEPS = 5, 50
DP_IMAGE, DP_BATCH = 64, 64                # bench_dp_step_overhead's
DP_WARMUP, DP_STEPS = 5, 40
RECIPE_STEPS, RECIPE_LOG_EVERY = 40, 5
# DDP at world size 1 adds no arithmetic to the gradients (a sum over one
# rank, divided by one), so they differ from the plain step's only where
# cuDNN's backward sums in another order from call to call: per tensor,
# ||ddp - plain|| over ||plain||
DDP_GRAD_RTOL = 1e-3
# bf16 products against f32 ones (TF32 off) on the same weights, through
# 53 convs and norms: each bf16 rounding is 2^-9 of a value, and their
# sum over the depth stays near 1e-2 of the logits; a wrong layout, pad or
# norm reads ~1. ||bf16 - f32|| over ||f32||, eval mode.
BF16_LOGITS_RTOL = 5e-2


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _World1:
    """A one-rank NCCL process group on a localhost TCPStore, torn down
    (group and store) on exit."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        import datetime

        import torch.distributed as tdist

        from pytorch_distributed_tpu_torch import init_process_group

        self.store = tdist.TCPStore("localhost", _free_port(), 1, True,
                                    timeout=datetime.timedelta(seconds=60))
        init_process_group("nccl", store=self.store, world_size=1, rank=0,
                           device=self.device)
        return self

    def __exit__(self, *exc):
        from pytorch_distributed_tpu_torch import destroy_process_group

        destroy_process_group()
        del self.store
        return False


def _resnet50_dp(device, seed):
    """bench.py's ``_resnet50_train_setup`` on the port: ResNet-50 under
    ``Policy.train()``, seeded init, SGD(0.1, momentum 0.9), in
    ``DataParallel``, and one placed f32 batch of 128 images of 224^2
    (re-fed every step). Returns (model, ddp, step, state, batch)."""
    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch import (
        DataParallel,
        Policy,
        ResNet50,
        TrainState,
        build_train_step,
        classification_loss_fn,
        optim,
    )

    policy = Policy.train()
    model = ResNet50(device=device, policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    strategy = DataParallel(device)
    ddp = strategy.wrap(model)
    rng = np.random.default_rng(seed)
    shape = (RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3)
    batch = strategy.shard_batch({
        "image": rng.normal(size=shape).astype(np.float32),
        "label": rng.integers(1000, size=RESNET_BATCH).astype(np.int32),
    })
    state = TrainState(ddp, optim.SGD(model, lr=0.1, momentum=0.9),
                       policy=policy)
    step = build_train_step(classification_loss_fn(ddp))
    return model, ddp, step, state, batch


def _grad_agreement(model, ddp, batch):
    """(d) one ResNet-50 backward through DDP and one through a plain
    copy of the module, same (trained: no zero scale left to stop a
    branch) weights and batch: the worst per-tensor gap."""
    import copy

    from pytorch_distributed_tpu_torch import cross_entropy

    plain = copy.deepcopy(model)
    grads = []
    for net, params in ((ddp, model), (plain, plain)):
        net.zero_grad(set_to_none=True)
        cross_entropy(net(batch["image"], train=True),
                      batch["label"]).backward()
        grads.append({n: p.grad.detach().clone()
                      for n, p in params.named_parameters()})
    worst, zero = 0.0, 0
    for name, ref in grads[1].items():
        diff = (grads[0][name] - ref).norm().item()
        norm = ref.norm().item()
        if norm == 0.0:     # the zero-scale last norms stop these
            zero += 1
            if diff != 0.0:
                raise AssertionError(f"{name}: DDP grad {diff} where the "
                                     "plain one is 0")
            continue
        worst = max(worst, diff / norm)
    print(f"(d) DDP vs plain gradients, world 1 (DDP's wrapping only; "
          f"global statistics: scripts/port_dp_scale.py): worst per-tensor "
          f"||ddp - plain|| / ||plain|| {worst:.2e} (<= {DDP_GRAD_RTOL:g}) "
          f"over {len(grads[1])} tensors ({zero} exactly zero in both)")
    if worst > DDP_GRAD_RTOL:
        raise AssertionError("DDP changed the gradients")
    return dict(worst_rel=worst, tensors=len(grads[1]), zero_tensors=zero)


def _bf16_vs_f32_logits(model, batch, device):
    """(d) eval-mode logits of the trained bf16-product model against an
    f32 copy of it, TF32 off for the reference."""
    import torch

    from pytorch_distributed_tpu_torch import Policy, ResNet50

    ref = ResNet50(device=device, policy=Policy.full())
    ref.load_state_dict(model.state_dict())
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = ref(batch["image"], train=False)
            got = model(batch["image"], train=False)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    rel = ((got - want).norm() / want.norm()).item()
    rel_max = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"(d) bf16 vs f32 logits (eval, same weights): ||d|| / ||f32|| "
          f"{rel:.2e} (<= {BF16_LOGITS_RTOL:g}), max|d| / max|f32| "
          f"{rel_max:.2e}, top-1 agreement {agree:.4f}")
    if not rel <= BF16_LOGITS_RTOL:
        raise AssertionError("bf16 and f32 logits disagree")
    del ref
    return dict(rel=rel, rel_max=rel_max, top1_agreement=agree)


# the port's BatchNorm against torch's on one bf16 activation: both
# normalize in f32 and round to bf16 (<= 1 bf16 ulp, 2^-8 of a value,
# apart); the statistics and the weight and bias gradients are f32 sums in
# other orders. ||d|| / ||torch||, or max |d| / max |torch| for statistics
NORM_RTOL = dict(y=1e-2, dx=1e-2, dw=1e-4, db=1e-4, mean=1e-5, var=1e-5,
                 combined_mean=1e-5, combined_var=1e-5)


def _norm_check(device, seed):
    """(d) ``models.resnet.BatchNorm`` in train mode (batch_norm_stats,
    batch_norm_elemt, backward_reduce, backward_elemt) against
    ``F.batch_norm`` on a channels_last bf16 [128, 256, 56, 56]
    activation of ResNet-50's first stage, f32 weights; and the combine
    of four ranks' statistics (batch_norm_gather_stats_with_counts, which
    a world of one skips) against the whole batch's."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_tpu_torch import Policy
    from pytorch_distributed_tpu_torch.models.resnet import (
        BatchNorm,
        _combine,
        _stats,
    )

    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (RESNET_BATCH, 256, 56, 56)
    x = (torch.randn(shape, generator=gen, device=device) * 2 + 0.5).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dy = torch.randn(shape, generator=gen, device=device).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bn = BatchNorm(256, policy=Policy.train(), device=device, momentum=0.0)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.normal_(generator=gen)
    got, want = {}, {}
    for out, fn in ((got, lambda xx: bn(xx, train=True)),
                    (want, lambda xx: F.batch_norm(
                        xx, None, None, bn.weight, bn.bias, True, 0.0,
                        bn.eps))):
        xx = x.detach().requires_grad_()
        bn.zero_grad(set_to_none=True)
        y = fn(xx)
        y.backward(dy)
        out.update(y=y.detach().float(), dx=xx.grad.float(),
                   dw=bn.weight.grad.clone(), db=bn.bias.grad.clone())
    var, mean = torch.var_mean(x.float(), (0, 2, 3), correction=0)
    got.update(mean=bn.running_mean, var=bn.running_var)
    want.update(mean=mean, var=var)
    # the global statistics' combine (world > 1 only): four quarters'
    # statistics combined on the card, against the whole batch's
    parts = [_stats(q, bn.eps) for q in x.chunk(4)]
    counts = torch.full((4,), x.numel() // 4 // 256, dtype=torch.float32,
                        device=device)
    g_mean, g_invstd = _combine(torch.stack([p[0] for p in parts]),
                                torch.stack([p[1] for p in parts]), counts,
                                bn.eps)
    got.update(combined_mean=g_mean, combined_var=g_invstd.pow(-2) - bn.eps)
    want.update(combined_mean=mean, combined_var=var)
    errs = {}
    for k, tol in NORM_RTOL.items():
        d = got[k] - want[k]
        errs[k] = ((d.abs().max() / want[k].abs().max()) if "mean" in k
                   or "var" in k else d.norm() / want[k].norm()).item()
    print("(d) BatchNorm vs F.batch_norm, bf16 [128, 256, 56, 56]: "
          + ", ".join(f"{k} {e:.2e} (<= {NORM_RTOL[k]:g})"
                      for k, e in errs.items()))
    bad = [k for k, e in errs.items() if not e <= NORM_RTOL[k]]
    if bad:
        raise AssertionError(f"the port's BatchNorm disagrees in {bad}")
    # the host's cost of one forward + backward, on a [2, 256, 4, 4]
    # tensor whose device work is negligible
    xs = x[:2, :, :4, :4].detach().contiguous(
        memory_format=torch.channels_last).requires_grad_()
    host_us = {}
    for name, fn in (("port", lambda: bn(xs, train=True)),
                     ("F.batch_norm", lambda: F.batch_norm(
                         xs, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, True, 0.1, bn.eps))):
        for n in (20, 200):       # warm-up, then timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn().sum().backward()
            torch.cuda.synchronize()
        host_us[name] = 1e6 * (time.perf_counter() - t0) / n
    print("(d) host us per BatchNorm forward + backward (and a sum): "
          + ", ".join(f"{k} {v:.1f}" for k, v in host_us.items()))
    return dict(errs, host_us=host_us)


def _timed_steps(step, state, batch, warmup, iters):
    """bench.py's loop: warm-up steps, a value fetch, ``iters`` steps
    ending in a value fetch. Returns (state, seconds, losses)."""
    import torch

    losses = []
    for _ in range(warmup):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    float(metrics["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    float(metrics["loss"])
    dt = time.perf_counter() - t0
    return state, dt, torch.stack(losses).tolist()


def _dp_step_overhead(device, seed):
    """(b) bench_dp_step_overhead on the port: ResNet [2, 2] BasicBlock,
    width 32, CIFAR stem, 100 classes, 64^2, batch 64: the DDP step and
    the plain step on copies of the same weights, in turns (plain, DDP,
    DDP, plain), SGD(0.1, momentum 0.9)."""
    import copy

    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch import (
        DataParallel,
        Policy,
        ResNet,
        TrainState,
        build_train_step,
        classification_loss_fn,
        optim,
    )
    from pytorch_distributed_tpu_torch.models.resnet import BasicBlock

    policy = Policy.train()
    base = ResNet([2, 2], BasicBlock, 100, width=32, stem="cifar",
                  device=device, policy=policy)
    base.init_weights(torch.Generator(device=device).manual_seed(seed))
    rng = np.random.default_rng(seed)
    host = {"image": rng.normal(size=(DP_BATCH, DP_IMAGE, DP_IMAGE, 3))
            .astype(np.float32),
            "label": rng.integers(100, size=DP_BATCH).astype(np.int32)}
    strategy = DataParallel(device)
    batch = strategy.shard_batch(host)
    runs = {}
    for kind in ("plain", "dp"):
        model = copy.deepcopy(base)
        net = strategy.wrap(model) if kind == "dp" else model
        runs[kind] = [build_train_step(classification_loss_fn(net)),
                      TrainState(net, optim.SGD(model, lr=0.1,
                                                momentum=0.9),
                                 policy=policy), []]
    for kind in ("plain", "dp", "dp", "plain"):
        step, state, times = runs[kind]
        runs[kind][1], dt, _ = _timed_steps(step, state, batch, DP_WARMUP,
                                            DP_STEPS)
        times.append(1e3 * dt / DP_STEPS)
    plain_ms = sum(runs["plain"][2]) / 2
    dp_ms = sum(runs["dp"][2]) / 2
    overhead = dp_ms - plain_ms
    print(f"(b) dp_step_overhead_ms {overhead:.3f} (DDP step "
          f"{runs['dp'][2][0]:.3f} / {runs['dp'][2][1]:.3f} ms, plain "
          f"{runs['plain'][2][0]:.3f} / {runs['plain'][2][1]:.3f} ms; "
          f"ResNet [2,2] BasicBlock w32 CIFAR stem, {DP_IMAGE}^2, batch "
          f"{DP_BATCH}, world 1 over NCCL)")
    return dict(dp_step_overhead_ms=overhead, dp_ms=runs["dp"][2],
                plain_ms=runs["plain"][2])


def _recipe_run(seed):
    """(c) ``recipes/resnet50_imagenet.main`` end to end at batch 128:
    uint8 data through the prefetching loader, normalize and flip on the
    card, DDP (its own world of one), SGD, one evaluation pass."""
    import torch

    from pytorch_distributed_tpu_torch.recipes import resnet50_imagenet
    from pytorch_distributed_tpu_torch.runtime import tracing

    with tracing.enabled() as tracer:
        t0 = time.perf_counter()
        trainer = resnet50_imagenet.main([
            "--batch-size", str(RESNET_BATCH), "--epochs", "1",
            "--steps-per-epoch", str(RECIPE_STEPS),
            "--log-every", str(RECIPE_LOG_EVERY), "--seed", str(seed),
            "--lr", "0.05",   # the recipe's linear scaling: 0.1 x 128/256
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    roll = tracer.rollups()
    hist = trainer.history
    dev = next(trainer.state.model.parameters()).device
    if dev.type != "cuda" or trainer.state.step != RECIPE_STEPS:
        raise AssertionError(f"the recipe ran {trainer.state.step} steps "
                             f"on {dev}")
    losses = [r["loss"] for r in hist]
    evals = trainer.last_eval_metrics
    if not all(math.isfinite(x) for x in losses + list(evals.values())):
        raise AssertionError(f"non-finite recipe metrics {losses} {evals}")
    # the rate over the whole training loop, every step counted; the
    # median log window's step time beside it is a per-step statistic
    loop_s = sum(r["step_time_s"] * RECIPE_LOG_EVERY for r in hist)
    ips = RECIPE_STEPS * RESNET_BATCH / loop_s
    steady = sorted(r["step_time_s"] for r in hist)
    step_ms = 1e3 * steady[len(steady) // 2]
    wait_ms = roll["train.data_wait"]["total_ms"]
    share = wait_ms / (1e3 * loop_s)
    print(f"(c) recipe: {RECIPE_STEPS} steps of {RESNET_BATCH} uint8 images "
          f"in {loop_s:.2f} s = {ips:.1f} images/s ({wall:.2f} s with "
          f"set-up and eval); median {RECIPE_LOG_EVERY}-step window "
          f"{step_ms:.2f} ms/step; train.data_wait {wait_ms:.1f} ms = "
          f"{100 * share:.2f}% of the loop; losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + "; eval " + " ".join(f"{k}={v:.4f}" for k, v in evals.items()))
    del trainer
    return dict(images_per_s=ips, median_window_step_ms=step_ms,
                loop_s=loop_s, wall_s=wall,
                data_wait_ms=wait_ms, data_wait_share=share, losses=losses,
                eval=evals, spans={k: roll[k]["mean_ms"] for k in roll})


def resnet_phase(device, seed):
    """bench.py's ResNet-50 phases on the port, (a)-(d); (e), the
    profile, is :func:`resnet_profile`, run last."""
    import gc

    import torch

    torch.backends.cudnn.benchmark = True
    stats = {}
    with _World1(device):
        model, ddp, step, state, batch = _resnet50_dp(device, seed)
        torch.cuda.reset_peak_memory_stats(device)
        state, dt, losses = _timed_steps(step, state, batch, RESNET_WARMUP,
                                         RESNET_STEPS)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        step_ms = 1e3 * dt / RESNET_STEPS
        ips = RESNET_BATCH * RESNET_STEPS / dt
        print(f"(a) resnet50_imagenet_images_per_sec_per_chip {ips:.2f} "
              f"(step {step_ms:.3f} ms, batch {RESNET_BATCH} x "
              f"{RESNET_IMAGE}^2, {RESNET_STEPS} steps after "
              f"{RESNET_WARMUP}, DDP world 1 over NCCL; peak memory "
              f"{peak:.2f} GiB); loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite ResNet-50 loss: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(
                f"the repeated batch's loss did not fall: {losses}")
        stats["bench"] = dict(
            images_per_s=ips, step_ms=step_ms, peak_mem_gib=peak,
            losses=losses, batch=RESNET_BATCH, image=RESNET_IMAGE)
        stats["logits"] = _bf16_vs_f32_logits(model, batch, device)
        stats["grads"] = _grad_agreement(model, ddp, batch)
        stats["norm"] = _norm_check(device, seed)
        del model, ddp, step, state, batch
        gc.collect()
        torch.cuda.empty_cache()
        stats["dp_overhead"] = _dp_step_overhead(device, seed)
    gc.collect()
    torch.cuda.empty_cache()
    stats["recipe"] = _recipe_run(seed)
    gc.collect()
    torch.cuda.empty_cache()
    return stats


# kernel-name families of the ResNet-50 step, for the profile's summary
RESNET_FAMILIES = (
    ("convolutions (cuDNN, cuBLAS)", re.compile(
        r"conv|cudnn|xmma|implicit_gemm|fprop|dgrad|wgrad|gemm|sm90|nvjet",
        re.I)),
    ("batch norm", re.compile(r"batch_norm|batchnorm|bn_|welford", re.I)),
    ("reductions (running statistics, loss, pooling)",
     re.compile(r"reduce", re.I)),
    ("NCCL", re.compile(r"nccl", re.I)),
    ("elementwise, casts and copies", re.compile(
        r"elementwise|vectorized|copy|memcpy|memset|fill|cast", re.I)),
)


def by_family(rows, table=RESNET_FAMILIES):
    """``profile_step``'s rows as device ms a step by kernel family."""
    families = {}
    for key, us, _ in rows:
        name = next((n for n, rx in table if rx.search(key)), "other")
        families[name] = families.get(name, 0.0) + us / 2e3
    return families


def resnet_profile(device, seed, step_ms):
    """(e) torch.profiler over two steps of (a), after its warm-up; the
    idle share is against (a)'s unprofiled ``step_ms``."""
    stats = {}
    with _World1(device):
        _, _, step, state, batch = _resnet50_dp(device, seed)
        state, _, _ = _timed_steps(step, state, batch, RESNET_WARMUP, 0)
        total_us, rows = profile_step(step, state, batch)
    busy_ms = total_us / 2e3
    families = by_family(rows)
    if total_us:
        print(f"(e) profile, 2 steps of (a): device busy {busy_ms:.2f} "
              f"ms/step against (a)'s unprofiled step of {step_ms:.2f} ms "
              f"(idle {100 * (1 - busy_ms / step_ms):.1f}%)")
        for name, ms in sorted(families.items(), key=lambda kv: -kv[1]):
            print(f"  {ms:9.3f} ms/step  {100 * ms / busy_ms:5.1f}%  {name}")
        for key, us, count in rows[:15]:
            print(f"  {us / 2e3:9.3f} ms/step  x{count // 2:<5d} {key[:90]}")
    else:
        print("(e) profiler: no device time recorded (not measured)")
    stats.update(step_ms=step_ms, device_busy_ms=busy_ms,
                 idle_share=(1 - busy_ms / step_ms) if total_us else None,
                 families=families,
                 top=[dict(name=k, ms_per_step=us / 2e3, count=c // 2)
                      for k, us, c in rows[:15]])
    return stats



# -- 7. the JAX recipe's default run: ZeRO-1, remat, chunked loss ---------

ZERO_STEPS = 6          # steps of (a), a checkpoint every ZERO_CKPT_EVERY
ZERO_CKPT_EVERY = 3
ZERO_CHUNK = 8192       # --vocab-chunk
ZERO_LOOP_STEPS = 10    # (a)'s step again in a plain loop, after the run
# (b) steps 4-6 after the restore against the uninterrupted run: every
# kernel on the path is deterministic (flash fwd/dq/dkv, cuBLAS at fixed
# shapes, the chunked loss, AdamW's foreach update, one-rank NCCL), so
# the losses must agree to the bit
RESUME_LOSS_RTOL = 0.0
# (c) the chunked loss against the full-logits one at the head's shapes,
# bf16 products with f32 results on both sides: the loss differs by the
# order of its f32 sums (~1e-7); the gradients by one bf16 rounding of
# dlogits and of the full path's bf16 product outputs (2^-9 relative),
# which ||chunked - full|| / ||full|| reads a few 1e-3 of
CHUNK_LOSS_RTOL = 1e-5
CHUNK_GRAD_RTOL = 2e-2
# (d) one microbatch's gradients with remat against without, dropout on:
# the recompute replays the same kernels on the same inputs and the same
# dropout masks, so the gradients must agree to the bit
REMAT_GRAD_RTOL = 0.0
CORPUS_PARAGRAPHS = 200  # (e): ~20k BPE tokens, ~14 packed rows of 1024


def _corpus(seed, paragraphs):
    """A text corpus from a seeded generator: paragraphs of 40-160 words
    drawn Zipf-like from a lexicon of 400 random lowercase words,
    separated by blank lines."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    lex = np.array(["".join(rng.choice(letters, rng.integers(2, 9)))
                    for _ in range(400)])
    p = 1.0 / np.arange(1, len(lex) + 1)
    p /= p.sum()
    return "\n\n".join(
        " ".join(lex[rng.choice(len(lex), rng.integers(40, 161), p=p)]) + "."
        for _ in range(paragraphs))


def _zero1_trainer(device, seed, ckpt_dir, *, init_seed=None, remat=True):
    """GPT-2-medium under ``Policy.train()`` as the recipe builds it with
    ``--strategy zero1 --remat --vocab-chunk 8192``: ZeRO-1 (DDP, the
    AdamW state sharded), clip(1.0) then adamw(3e-4, decay 1e-4), batch 8
    x 1024 in 2 microbatches, a checkpoint every 3 steps. The data
    follows ``seed``, the weights ``init_seed`` (``seed`` unless given)."""
    import dataclasses as dc

    import torch

    from pytorch_distributed_tpu_torch import (
        DataLoader,
        GPT2Config,
        GPT2LMHead,
        Policy,
        SyntheticTextDataset,
        Trainer,
        TrainerConfig,
        TrainState,
        ZeRO1,
        build_train_step,
        causal_lm_loss_fn,
        optim,
    )

    cfg = dc.replace(GPT2Config.medium(), remat=remat)
    policy = Policy.train()
    model = GPT2LMHead(cfg, device=device, policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(
        seed if init_seed is None else init_seed))
    strategy = ZeRO1(device)
    opt = optim.clip_grad_norm(strategy.optimizer(
        model, optim.AdamW, lr=3e-4, weight_decay=1e-4), 1.0)
    net = strategy.wrap(model)
    ds = SyntheticTextDataset(n=ZERO_STEPS * 8, seq_len=1024,
                              vocab_size=cfg.vocab_size, seed=seed)
    trainer = Trainer(
        TrainState(net, opt, policy=policy),
        build_train_step(causal_lm_loss_fn(net, vocab_chunk_size=ZERO_CHUNK),
                         accum_steps=2),
        DataLoader(ds, 8, seed=seed, sharding=device),
        config=TrainerConfig(log_every=1, max_steps_per_epoch=ZERO_STEPS,
                             ckpt_dir=ckpt_dir,
                             ckpt_every_steps=ZERO_CKPT_EVERY))
    return model, trainer


def _zero1_snapshot(model, trainer):
    """Host copies of the parameters, both moments, the step and the
    cursor the trainer checkpoints now (on the host, so the path's peak
    memory stays the path's; copies, since AdamW's ``step`` tensors
    already live there)."""
    zero = trainer.state.optimizer.optimizer
    return dict(
        params={n: p.detach().to("cpu", copy=True)
                for n, p in model.named_parameters()},
        moments={id_: {k: v.to("cpu", copy=True) for k, v in s.items()}
                 for id_, s in ((n, zero.optim.state[p])
                                for n, p in model.named_parameters()
                                if p in zero.optim.state)},
        step=trainer.state.step,
        cursor=(trainer._cursor_epoch, trainer._cursor_offset))


def _gc_txt(timer):
    return "/".join(f"{ms:.1f} ({n})" for ms, n in zip(timer.ms, timer.count))


def _loop_ms(trainer, iters):
    """The trainer's own step on one placed batch of its loader, in a
    plain loop: ``iters`` steps after 2 of warm-up, ending in one value
    fetch (no per-step fetch, no span, no loader): ms a step."""
    import torch

    device = next(trainer.state.model.parameters()).device
    batches = iter(trainer.train_loader)
    batch = {k: v.to(device) for k, v in next(batches).items()}
    batches.close()   # stops the loader's prefetch thread
    state = trainer.state
    for _ in range(2):
        state, metrics = trainer.train_step(state, batch)
    float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = trainer.train_step(state, batch)
    float(metrics["loss"])
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def _zero1_train_and_restore(device, seed, tmp):
    """(a) and (b)."""
    import gc
    import os
    import shutil

    import torch

    from pytorch_distributed_tpu_torch.runtime import tracing

    run_dir, step3_dir = os.path.join(tmp, "run"), os.path.join(tmp, "at3")
    model, trainer = _zero1_trainer(device, seed, run_dir)
    n_params = sum(p.numel() for p in model.parameters())
    snap = {}
    save = trainer.save_checkpoint

    def save_and_keep_step3(tag="latest"):
        path = save(tag)
        if trainer.host_step == ZERO_CKPT_EVERY and "state" not in snap:
            shutil.copytree(run_dir, step3_dir)
            snap["state"] = _zero1_snapshot(model, trainer)
        return path

    trainer.save_checkpoint = save_and_keep_step3
    # the host's state the step's enqueue runs in: the objects the
    # collector tracks and the time of one full collection
    t0 = time.perf_counter()
    gc.collect()
    heap = dict(gc_objects=len(gc.get_objects()),
                gc_collect_ms=1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernel_counts(reset=True)
    with tracing.enabled() as tracer, GCTimer() as fit_gc:   # the main path
        t0 = time.perf_counter()
        trainer.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    roll = tracer.rollups()
    losses = [r["loss"] for r in trainer.history]
    per = model.config.num_layers * ZERO_STEPS * 2   # layers x microbatches
    want = dict(flash_fwd=2 * per, flash_dq=per, flash_dkv=per)
    launches = {k: counts[k] for k in FLASH}
    # the logged step times leave the saves out; the first step is the
    # warm-up (cuBLAS handles, ZeRO's moments, the allocator's pools)
    step_s = [r["step_time_s"] for r in trainer.history]
    steady = sorted(step_s[1:])
    step_ms = 1e3 * steady[len(steady) // 2]
    # the same step in a plain loop, then again once the host has
    # written the saves' dirty pages out (os.sync)
    with GCTimer() as loop_gc:
        loop_ms = _loop_ms(trainer, ZERO_LOOP_STEPS)
    t0 = time.perf_counter()
    os.sync()
    sync_s = time.perf_counter() - t0
    synced_ms = _loop_ms(trainer, ZERO_LOOP_STEPS)
    ckpt_ms = roll["train.checkpoint"]
    print(f"(a) ZeRO-1 x remat(full) x vocab chunk {ZERO_CHUNK}: "
          f"{ZERO_STEPS} steps of 8 x 1024 in 2 microbatches, {n_params} "
          f"params, {wall:.2f} s incl. {ckpt_ms['count']} checkpoints; "
          f"step ms " + " ".join(f"{1e3 * x:.2f}" for x in step_s)
          + f", median of steps 2-{ZERO_STEPS} {step_ms:.2f} ms = "
          f"{8192 / step_ms * 1e3:.0f} tokens/s (the same step in a plain "
          f"loop on one placed batch, one fetch after {ZERO_LOOP_STEPS}: "
          f"{loop_ms:.2f} ms; after os.sync, {sync_s:.2f} s: "
          f"{synced_ms:.2f} ms; {heap['gc_objects']} objects tracked by "
          f"gc, a full collection {heap['gc_collect_ms']:.1f} ms; gc ms by "
          f"generation over the run {_gc_txt(fit_gc)}, over the first "
          f"loop's {ZERO_LOOP_STEPS + 2} steps {_gc_txt(loop_gc)}), peak "
          f"memory {peak:.2f} GiB; checkpoint save "
          f"{ckpt_ms['mean_ms']:.0f} ms mean; losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; launches {counts} (want {want} and no paged kernel: the "
          "forward runs again in each block's recompute)")
    if len(losses) != ZERO_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"ZeRO-1 losses {losses}")
    if launches != want:
        raise AssertionError(f"flash launches {launches} != {want}")
    off_path(counts, FLASH)
    stats = dict(params=n_params, steps=ZERO_STEPS, losses=losses,
                 step_ms_median=step_ms, step_ms=[1e3 * x for x in step_s],
                 loop_step_ms=loop_ms, sync_s=sync_s,
                 loop_step_ms_after_sync=synced_ms, **heap,
                 gc_ms_run=fit_gc.ms, gc_count_run=fit_gc.count,
                 gc_ms_loop=loop_gc.ms, gc_count_loop=loop_gc.count,
                 tokens_per_s=8192 / step_ms * 1e3, peak_mem_gib=peak,
                 launches=counts, wall_s=wall,
                 ckpt_save_ms=ckpt_ms["mean_ms"],
                 ckpt_saves=ckpt_ms["count"],
                 spans={k: roll[k]["mean_ms"] for k in roll})
    saved = snap["state"]
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()

    # (b) a fresh model (other weights), optimizer and trainer restore
    # step 3, then run steps 4-6 on the same data, saving nothing more
    model, trainer = _zero1_trainer(device, seed, step3_dir,
                                    init_seed=seed + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not trainer.restore_checkpoint():
        raise AssertionError("nothing restored")
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    got = _zero1_snapshot(model, trainer)
    bad = [n for n, p in saved["params"].items()
           if not torch.equal(p, got["params"][n])]
    bad += [f"{n}.{k}" for n, s in saved["moments"].items()
            for k, v in s.items() if not torch.equal(v, got["moments"][n][k])]
    if (bad or got["step"] != saved["step"]
            or got["cursor"] != saved["cursor"]
            or set(got["moments"]) != set(saved["moments"])):
        raise AssertionError(
            f"restored state differs: {bad[:5]} step {got['step']} vs "
            f"{saved['step']} cursor {got['cursor']} vs {saved['cursor']}")
    trainer.config = dataclasses.replace(trainer.config, ckpt_dir=None)
    trainer.fit()
    resumed = [r["loss"] for r in trainer.history]
    diff = max(abs(a - b) / abs(b) for a, b in
               zip(resumed, losses[ZERO_CKPT_EVERY:]))
    print(f"(b) restore of step {ZERO_CKPT_EVERY} in {restore_ms:.0f} ms: "
          f"{len(saved['params'])} parameters and {len(saved['moments'])} "
          f"x 2 moments, step {got['step']} and cursor {got['cursor']} "
          f"equal to the bit; steps 4-6 "
          + " ".join(f"{x:.6f}" for x in resumed) + " against "
          + " ".join(f"{x:.6f}" for x in losses[ZERO_CKPT_EVERY:])
          + f" (max rel {diff:.2e} <= {RESUME_LOSS_RTOL:g})")
    if len(resumed) != ZERO_STEPS - ZERO_CKPT_EVERY or diff > RESUME_LOSS_RTOL:
        raise AssertionError("the resumed run left the uninterrupted one")
    stats.update(restore_ms=restore_ms, resumed_losses=resumed,
                 resume_max_rel=diff)
    del model, trainer, saved, got
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def _chunk_vs_full(device, seed, N=8 * 1023, D=1024, V=50257):
    """(c) the chunked loss against the full-logits one at the head's
    shapes (N = 8 x 1023, D = 1024, V = 50257, tied wte), with each one's
    peak memory above its inputs."""
    import gc

    import torch
    import torch.nn.functional as F

    from pytorch_distributed_tpu_torch.models.gpt2 import tied_logits
    from pytorch_distributed_tpu_torch.ops.lm_loss import (
        chunked_softmax_cross_entropy,
    )

    g = torch.Generator(device=device).manual_seed(seed)
    hidden = torch.randn(N, D, device=device, generator=g).bfloat16()
    wte = torch.randn(V, D, device=device, generator=g) / D ** 0.5
    labels = torch.randint(0, V, (N,), device=device, generator=g)
    out = {}
    for name in ("full", "chunked"):
        h = hidden.clone().requires_grad_()
        w = wte.clone().requires_grad_()
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        if name == "full":
            logits = tied_logits(h[None], w, torch.bfloat16)[0]
            loss = F.cross_entropy(logits, labels)
            del logits
        else:
            loss = chunked_softmax_cross_entropy(h, w, labels,
                                                 chunk_size=ZERO_CHUNK)
        loss.backward()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(device) - base) / 2**30
        out[name] = (loss.item(), h.grad.float(), w.grad.float(), peak)
        del h, w, loss
    (lf, hf, wf, pf), (lc, hc, wc, pc) = out["full"], out["chunked"]
    rel = dict(loss=abs(lc - lf) / abs(lf),
               d_hidden=((hc - hf).norm() / hf.norm()).item(),
               d_wte=((wc - wf).norm() / wf.norm()).item())
    print(f"(c) chunked ({ZERO_CHUNK}) vs full-logits loss at N={N}, D={D}, "
          f"V={V}: loss {lc:.6f} vs {lf:.6f} (rel {rel['loss']:.2e} <= "
          f"{CHUNK_LOSS_RTOL:g}), d(hidden) {rel['d_hidden']:.2e}, d(wte) "
          f"{rel['d_wte']:.2e} (<= {CHUNK_GRAD_RTOL:g}); peak memory above "
          f"the inputs {pc:.3f} GiB chunked vs {pf:.3f} GiB full")
    if (rel["loss"] > CHUNK_LOSS_RTOL or rel["d_hidden"] > CHUNK_GRAD_RTOL
            or rel["d_wte"] > CHUNK_GRAD_RTOL):
        raise AssertionError("the chunked loss disagrees with the full one")
    if not pc < 0.5 * pf:
        raise AssertionError(f"chunked peak {pc:.3f} GiB is not under half "
                             f"the full one's {pf:.3f} GiB")
    del out, hf, wf, hc, wc, hidden, wte
    gc.collect()
    torch.cuda.empty_cache()
    return dict(loss=[lc, lf], rel=rel, peak_gib=dict(chunked=pc, full=pf))


def _remat_grads(device, seed):
    """(d) one microbatch's gradients with remat against without (full,
    dots, dots_no_batch), dropout on, the same model, batch and dropout
    stream, and each policy's flash launches."""
    import dataclasses as dc
    import gc

    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch import (
        GPT2Config,
        GPT2LMHead,
        Policy,
        SyntheticTextDataset,
        causal_lm_loss_fn,
        generator_for,
    )

    model = GPT2LMHead(GPT2Config.medium(), device=device,
                       policy=Policy.train())
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    rows = SyntheticTextDataset(n=4, seq_len=1024,
                                vocab_size=model.config.vocab_size, seed=seed)
    batch = {"input_ids": torch.from_numpy(np.stack(
        [rows[i]["input_ids"] for i in range(4)])).to(device)}
    loss_fn = causal_lm_loss_fn(model, vocab_chunk_size=ZERO_CHUNK)
    grads, ends, counts = {}, {}, {}
    for policy in (None, "full", "dots", "dots_no_batch"):
        model.config = dc.replace(model.config, remat=policy is not None,
                                  remat_policy=policy or "full")
        model.zero_grad(set_to_none=True)
        gen = generator_for(7, 0x64726F70, device)
        kernel_counts(reset=True)
        loss, _ = loss_fn(batch, gen)
        loss.backward()
        counts[policy or "none"] = {
            k: n for k, n in kernel_counts().items() if k in FLASH}
        ends[policy] = gen.get_state()
        grads[policy] = [p.grad.clone() for p in model.parameters()]
    L = model.config.num_layers
    # the flash forward is no matmul: every policy's recompute runs it
    for policy, got in counts.items():
        want = dict(flash_fwd=L if policy == "none" else 2 * L,
                    flash_dq=L, flash_dkv=L)
        if got != want:
            raise AssertionError(f"remat {policy}: launches {got} != {want}")
    ref = grads.pop(None)
    rel = {}
    for policy, gs in grads.items():
        num = sum((a.double() - b.double()).square().sum()
                  for a, b in zip(gs, ref)) ** 0.5
        den = sum(b.double().square().sum() for b in ref) ** 0.5
        rel[policy] = (num / den).item()
    same_end = {p: torch.equal(ends[p], ends[None]) for p in grads}
    print(f"(d) remat vs none, one microbatch of 4 x 1024, dropout 0.1: "
          f"gradient rel {rel} (<= {REMAT_GRAD_RTOL:g}); the dropout "
          f"generator ends where it does without remat: {same_end}; flash "
          f"launches per microbatch by policy {counts}")
    if max(rel.values()) > REMAT_GRAD_RTOL or not all(same_end.values()):
        raise AssertionError("remat changed the gradients")
    del model, grads, ref
    gc.collect()
    torch.cuda.empty_cache()
    return dict(grad_rel=rel, launches_per_microbatch=counts)


def _text_run(seed, tmp):
    """(e) ``--text-file --pack`` at GPT-2-medium width on a corpus written
    here from a seeded generator: the recipe's 3 packed steps give finite
    losses, and the tokenizer it trained round-trips the corpus."""
    import os

    import torch

    from pytorch_distributed_tpu_torch.recipes import gpt2 as recipe

    corpus = _corpus(seed, CORPUS_PARAGRAPHS)
    path = os.path.join(tmp, "corpus.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write(corpus)
    trainer = recipe.main([
        "--size", "medium", "--text-file", path, "--pack", "--batch-size",
        "4", "--accum-steps", "2", "--seq-len", "1024", "--steps-per-epoch",
        "3", "--log-every", "1", "--remat", "--vocab-chunk",
        str(ZERO_CHUNK), "--seed", str(seed)])
    losses = [r["loss"] for r in trainer.history]
    dev = next(trainer.state.model.parameters()).device
    tok = trainer.tokenizer
    t0 = time.perf_counter()
    ids = tok.encode(corpus)
    encode_s = time.perf_counter() - t0
    if tok.decode(ids) != corpus:
        raise AssertionError("the tokenizer does not round-trip the corpus")
    print(f"(e) corpus of {len(corpus)} bytes, {CORPUS_PARAGRAPHS} "
          f"paragraphs: the recipe's BPE vocab {tok.vocab_size}, "
          f"{len(ids)} tokens, round trip exact ({encode_s:.2f} s to "
          f"encode); --text-file --pack on {dev}: losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f", eval {trainer.last_eval_metrics}")
    if (dev.type != "cuda" or len(losses) != 3
            or not all(map(math.isfinite, losses))):
        raise AssertionError(f"the packed text run gave {losses} on {dev}")
    del trainer
    torch.cuda.empty_cache()
    return dict(bytes=len(corpus), vocab=tok.vocab_size, tokens=len(ids),
                encode_s=encode_s, losses=losses)


def zero1_phase(device, seed):
    """Phase 7: the JAX recipe's default run (``--strategy zero1``) on
    the port, (a)-(e)."""
    import gc
    import tempfile

    import torch

    stats = {}
    with tempfile.TemporaryDirectory(prefix="ptd_zero1_") as tmp:
        with _World1(device):
            stats["train"] = _zero1_train_and_restore(device, seed, tmp)
        stats["chunk"] = _chunk_vs_full(device, seed)
        stats["remat"] = _remat_grads(device, seed)
        stats["text"] = _text_run(seed, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    return stats


# -- 8. the JAX recipe's Llama-3-8B run: FSDP full-shard -------------------

LLAMA_LAYERS = 4        # of 32: the 8B AdamW state (128.5 GB) exceeds a card
LLAMA_STEPS = 6         # steps of (a), a checkpoint after LLAMA_CKPT_AT
LLAMA_CKPT_AT = 3
LLAMA_BATCH, LLAMA_SEQ, LLAMA_CHUNK = 8, 2048, 8192
LLAMA_FAMILIES = (
    ("flash kernels (B1-B3)", re.compile(r"flash_(fwd|dq|dkv)", re.I)),
    ("AdamW and the clip (foreach)", re.compile(r"multi_tensor|foreach",
                                                re.I)),
    ("matmuls (cuBLAS)", re.compile(r"gemm|sm90|nvjet|cutlass|xmma", re.I)),
    ("NCCL (FSDP's gather and reduce-scatter)", re.compile(r"nccl", re.I)),
    ("copies (FSDP's gather buffers, casts)", re.compile(
        r"copy|memcpy|memset|chunk_cat|split_with_sizes|cast", re.I)),
    ("elementwise and reductions", re.compile(
        r"elementwise|vectorized|reduce|fill|softmax|norm", re.I)),
)


def _llama_trainer(device, seed, ckpt_dir, *, init_seed=None):
    """Llama-3-8B at full width and ``LLAMA_LAYERS`` layers as the recipe
    builds it with ``--strategy fsdp --remat --vocab-chunk 8192``:
    ``Policy.train()``, FSDP full-shard at world 1 (made on the meta
    device, each rank drawing its own rows), clip(1.0) then adamw(1e-4,
    decay 1e-4), batch 8 x 2048 in one microbatch, checkpoints every
    ``LLAMA_CKPT_AT`` steps into ``ckpt_dir``. The data follows ``seed``,
    the weights ``init_seed`` (``seed`` unless given)."""
    import dataclasses as dc

    from pytorch_distributed_tpu_torch import (
        FSDP,
        DataLoader,
        LlamaConfig,
        MeshSpec,
        Policy,
        SyntheticTextDataset,
        Trainer,
        TrainerConfig,
        TrainState,
        build_train_step,
        causal_lm_loss_fn,
        optim,
    )
    from pytorch_distributed_tpu_torch.recipes.llama_fsdp import (
        ADAMW_WEIGHT_DECAY,
        build_model,
    )

    cfg = dc.replace(LlamaConfig.llama3_8b(), num_layers=LLAMA_LAYERS,
                     remat=True)
    policy = Policy.train()
    strategy = FSDP(device, MeshSpec(dp=1, fsdp=-1))
    model, net = build_model(cfg, strategy, device,
                             seed if init_seed is None else init_seed, policy)
    opt = optim.clip_grad_norm(strategy.optimizer(
        model, optim.AdamW, lr=1e-4, weight_decay=ADAMW_WEIGHT_DECAY), 1.0)
    ds = SyntheticTextDataset(n=LLAMA_STEPS * LLAMA_BATCH, seq_len=LLAMA_SEQ,
                              vocab_size=cfg.vocab_size, seed=seed)
    trainer = Trainer(
        TrainState(net, opt, policy=policy),
        build_train_step(causal_lm_loss_fn(net,
                                           vocab_chunk_size=LLAMA_CHUNK)),
        DataLoader(ds, LLAMA_BATCH, seed=seed,
                   sharding=strategy.batch_sharding()),
        config=TrainerConfig(log_every=1, max_steps_per_epoch=LLAMA_STEPS,
                             ckpt_dir=ckpt_dir,
                             ckpt_every_steps=LLAMA_CKPT_AT))
    return model, trainer


def _llama_snapshot(model, trainer):
    """Host copies of this rank's rows of every parameter and both
    moments, the step and the cursor."""
    from pytorch_distributed_tpu_torch.interop import unwrap_optimizer

    _, adam, _ = unwrap_optimizer(trainer.state.optimizer)
    out = {}
    for n, p in model.named_parameters():
        out[n] = p.to_local().detach().to("cpu", copy=True)
        for k, v in adam.state.get(p, {}).items():
            if k != "step":
                out[f"{n}.{k}"] = v.to_local().to("cpu", copy=True)
    return dict(tensors=out, step=trainer.state.step,
                cursor=(trainer._cursor_epoch, trainer._cursor_offset))


def llama_phase(device, seed):
    """Phase 8a: the recipe's path on one card (run, checkpoint, restore,
    resume), then torch.profiler over two steps."""
    import gc
    import shutil
    import tempfile

    import torch

    stats = {}
    with tempfile.TemporaryDirectory(prefix="ptd_llama_") as tmp, \
            _World1(device):
        print(f"(8a) checkpoint directory {tmp}: "
              f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB free")
        model, trainer = _llama_trainer(device, seed, tmp)
        n_params = sum(p.numel() for p in model.parameters())
        snap = {}
        save = trainer.save_checkpoint

        def save_at_ckpt_step(tag="latest"):
            # the state is 23 GB of files: one save, at LLAMA_CKPT_AT,
            # and a host copy of the state it wrote
            if trainer.host_step != LLAMA_CKPT_AT:
                return None
            path = save(tag)
            snap["state"] = _llama_snapshot(model, trainer)
            return path

        trainer.save_checkpoint = save_at_ckpt_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        kernel_counts(reset=True)
        from pytorch_distributed_tpu_torch.runtime import tracing

        with tracing.enabled() as tracer:   # the main path
            t0 = time.perf_counter()
            trainer.fit()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        roll = tracer.rollups()
        losses = [r["loss"] for r in trainer.history]
        step_s = [r["step_time_s"] for r in trainer.history]
        steady = sorted(step_s[1:])
        step_ms = 1e3 * steady[len(steady) // 2]
        tokens = LLAMA_BATCH * LLAMA_SEQ
        L = LLAMA_LAYERS * LLAMA_STEPS
        want = dict(flash_fwd=2 * L, flash_dq=L, flash_dkv=L)
        launches = {k: counts[k] for k in FLASH}
        ckpt = roll.get("train.checkpoint", {})
        print(f"(8a) Llama-3-8B width, {LLAMA_LAYERS} of 32 layers, {n_params}"
              f" params, FSDP full-shard at world 1, remat(full), vocab chunk"
              f" {LLAMA_CHUNK}, batch {LLAMA_BATCH} x {LLAMA_SEQ}: "
              f"{LLAMA_STEPS} steps in {wall:.2f} s incl. "
              f"{ckpt.get('count', 0)} checkpoint(s) of "
              f"{ckpt.get('mean_ms', 0.0):.0f} ms; step ms "
              + " ".join(f"{1e3 * x:.2f}" for x in step_s)
              + f", median of steps 2-{LLAMA_STEPS} {step_ms:.2f} ms = "
              f"{tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
              f"{peak:.2f} GiB; losses " + " ".join(f"{x:.4f}" for x in losses)
              + f"; launches {counts} (want {want} and no paged kernel)")
        if len(losses) != LLAMA_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"Llama losses {losses}")
        if launches != want:
            raise AssertionError(f"flash launches {launches} != {want}")
        off_path(counts, FLASH)
        stats.update(params=n_params, layers=LLAMA_LAYERS, losses=losses,
                     step_ms=[1e3 * x for x in step_s], step_ms_median=step_ms,
                     tokens_per_s=tokens / step_ms * 1e3, peak_mem_gib=peak,
                     launches=counts, wall_s=wall,
                     ckpt_save_ms=ckpt.get("mean_ms"),
                     spans={k: roll[k]["mean_ms"] for k in roll})
        saved = snap["state"]
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()

        # a fresh model (other weights) restores step 3 and runs 4-6
        model, trainer = _llama_trainer(device, seed, tmp,
                                        init_seed=seed + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not trainer.restore_checkpoint():
            raise AssertionError("nothing restored")
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        got = _llama_snapshot(model, trainer)
        bad = [k for k, v in saved["tensors"].items()
               if k not in got["tensors"] or not torch.equal(
                   v, got["tensors"][k])]
        if (bad or set(got["tensors"]) != set(saved["tensors"])
                or got["step"] != saved["step"]
                or got["cursor"] != saved["cursor"]):
            raise AssertionError(
                f"restored state differs: {bad[:5]} step {got['step']} vs "
                f"{saved['step']} cursor {got['cursor']} vs "
                f"{saved['cursor']}")
        del saved, got
        trainer.config = dataclasses.replace(trainer.config, ckpt_dir=None)
        trainer.fit()
        resumed = [r["loss"] for r in trainer.history]
        print(f"(8a) restore of step {LLAMA_CKPT_AT} in {restore_ms:.0f} ms: "
              f"parameters, both moments, step and cursor equal to the bit;"
              f" steps 4-6 " + " ".join(f"{x:.6f}" for x in resumed)
              + " against " + " ".join(f"{x:.6f}"
                                       for x in losses[LLAMA_CKPT_AT:]))
        if resumed != losses[LLAMA_CKPT_AT:]:
            raise AssertionError("the resumed run left the uninterrupted one")
        stats.update(restore_ms=restore_ms, resumed_losses=resumed)

        # torch.profiler over two steps on one placed batch, last
        batches = iter(trainer.train_loader)
        batch = {k: v.to(device) for k, v in next(batches).items()}
        batches.close()
        state = trainer.state
        for _ in range(2):
            state, metrics = trainer.train_step(state, batch)
        float(metrics["loss"])
        total_us, rows = profile_step(trainer.train_step, state, batch)
        busy_ms = total_us / 2e3
        families = by_family(rows, LLAMA_FAMILIES)
        if total_us:
            print(f"(8a) profile, 2 steps: device busy {busy_ms:.2f} ms/step "
                  f"against the unprofiled step of {step_ms:.2f} ms (idle "
                  f"{100 * (1 - busy_ms / step_ms):.1f}%)")
            for name, ms in sorted(families.items(), key=lambda kv: -kv[1]):
                print(f"  {ms:9.3f} ms/step  {100 * ms / busy_ms:5.1f}%  "
                      f"{name}")
            for key, us, count in rows[:15]:
                print(f"  {us / 2e3:9.3f} ms/step  x{count // 2:<5d} "
                      f"{key[:90]}")
        else:
            print("(8a) profiler: no device time recorded (not measured)")
        stats["profile"] = dict(
            device_busy_ms=busy_ms, families=families,
            idle_share=(1 - busy_ms / step_ms) if total_us else None,
            top=[dict(name=k, ms_per_step=us / 2e3, count=c // 2)
                 for k, us, c in rows[:15]])
        del model, trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return stats


# -- 9. the JAX recipe's BERT-base fine-tune: DDP, bf16 and fp16 -----------

BERT_BATCH, BERT_SEQ = 32, 128   # the recipe's --batch-size, --seq-len
BERT_STEPS = 20          # (9a) and (9b)'s timed run: steps through fit()
BERT_FP16_STEPS = 40     # (9b) checked fp16 steps, from an overflowing scale
BERT_FP16_INIT = 2.0 ** 40   # the first steps' gradients overflow fp16
BERT_GROWTH = 3          # (9b) the scaler's growth interval
BERT_RESUME = 3          # (9c) steps after the checkpoint
BERT_MLM_STEPS = 8       # (9d)
# (9d): the recipe's 2e-5 moves the MLM loss by less than the noise of
# its fresh masking within 8 steps
BERT_MLM_LR = 1e-4
BERT_MASK_TOL = 0.02     # (9d) |mask_frac - 0.15 x the unpadded share|
BERT_FAMILIES = (
    ("flash kernels (B1-B3)", re.compile(r"flash_(fwd|dq|dkv)", re.I)),
    ("AdamW (foreach)", re.compile(r"multi_tensor|foreach", re.I)),
    ("matmuls (cuBLAS)", re.compile(r"gemm|sm90|nvjet|cutlass|xmma", re.I)),
    ("NCCL (DDP's all-reduce)", re.compile(r"nccl", re.I)),
    ("copies and casts", re.compile(r"copy|memcpy|memset|cast", re.I)),
    ("elementwise and reductions", re.compile(
        r"elementwise|vectorized|reduce|fill|softmax|norm", re.I)),
)


def _bert_rows(seed, vocab, steps):
    """The recipe's synthetic rows (ids and labels), one batch of them,
    padded as GLUE sentences are: seeded lengths 16-128, id 0 and
    ``attention_mask`` False past each; tiled ``steps`` times, so the
    loader cycles over the same 32 rows (a loss that must fall)."""
    import numpy as np

    from pytorch_distributed_tpu_torch import (
        ArrayDataset,
        SyntheticTextDataset,
    )

    ds = SyntheticTextDataset(n=BERT_BATCH, seq_len=BERT_SEQ,
                              vocab_size=vocab, num_classes=2, seed=seed)
    ids = np.stack([ds[i]["input_ids"] for i in range(BERT_BATCH)])
    labels = np.stack([ds[i]["label"] for i in range(BERT_BATCH)])
    lengths = np.random.default_rng(seed + 9).integers(
        16, BERT_SEQ + 1, BERT_BATCH)
    mask = np.arange(BERT_SEQ)[None] < lengths[:, None]
    rows = dict(input_ids=np.where(mask, ids, 0).astype(np.int32),
                attention_mask=mask, label=labels)
    return ArrayDataset(**{k: np.tile(v, (steps,) + (1,) * (v.ndim - 1))
                           for k, v in rows.items()}), float(mask.mean())


def _bert_build(device, seed, steps, *flags, scaler=None, init_seed=None):
    """The recipe's ``build_trainer`` at BERT-base with its batch 32 x
    128 over ``_bert_rows`` (``steps`` batches an epoch): (model, trainer,
    the rows, their unpadded share)."""
    from pytorch_distributed_tpu_torch.models.bert import BertConfig
    from pytorch_distributed_tpu_torch.recipes import bert_finetune

    args = bert_finetune.parse_args(
        ["--batch-size", str(BERT_BATCH), "--seq-len", str(BERT_SEQ),
         "--steps-per-epoch", str(steps), "--log-every", "1",
         "--seed", str(seed), *flags])
    ds, unpadded = _bert_rows(seed, BertConfig.base().vocab_size, steps)
    model, trainer = bert_finetune.build_trainer(
        args, device, dataset=ds, scaler=scaler, init_seed=init_seed)
    return model, trainer, ds, unpadded


def _bert_eval_loss(model, ds, device, mlm=False):
    """The loss on the 32 distinct rows with dropout off (an MLM's under
    one masking drawn from a fixed seed), through the einsum attention
    (so the flash counts stay the training steps'): the trend a run on
    these rows must move down, free of dropout's and masking's noise."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_tpu_torch.models.bert import mask_tokens

    b = {k: torch.from_numpy(v[:BERT_BATCH]).to(device)
         for k, v in ds.arrays.items()}
    with torch.no_grad():
        if not mlm:
            logits = model(b["input_ids"], b["attention_mask"],
                           attn_impl="xla")
            return F.cross_entropy(logits.float(), b["label"].long()).item()
        V = model.config.vocab_size
        ids, labels = mask_tokens(
            torch.Generator(device=device).manual_seed(0), b["input_ids"],
            mask_token_id=103, vocab_size=V, mask_prob=0.15,
            special_mask=~b["attention_mask"])
        logits = model(ids, b["attention_mask"], attn_impl="xla")
        return F.cross_entropy(logits.float().reshape(-1, V),
                               labels.long().reshape(-1),
                               ignore_index=-100).item()


def _bert_fit(device, seed, steps, what, *flags, profile=True):
    """fit() over ``steps`` steps of the recipe's step: losses, step ms
    (median of steps 2..), samples/s, this run's own peak memory, then
    torch.profiler over two more steps. Returns (stats, steps run)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    model, trainer, ds, unpadded = _bert_build(device, seed, steps, *flags)
    n_params = sum(p.numel() for p in model.parameters())
    mlm = "--mlm" in flags
    eval_before = _bert_eval_loss(model, ds, device, mlm)
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eval_after = _bert_eval_loss(model, ds, device, mlm)
    peak = (torch.cuda.max_memory_allocated(device) - left) / 2**30
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    step_s = [r["step_time_s"] for r in hist]
    steady = sorted(step_s[1:])
    step_ms = 1e3 * steady[len(steady) // 2]
    stats = dict(params=n_params, losses=losses,
                 eval_loss=(eval_before, eval_after),
                 step_ms=[1e3 * x for x in step_s], step_ms_median=step_ms,
                 samples_per_s=BERT_BATCH / step_ms * 1e3,
                 peak_mem_gib=peak, wall_s=wall, unpadded=unpadded,
                 metrics={k: [r[k] for r in hist] for k in hist[0]
                          if k not in ("step", "epoch")})
    print(f"({what}) BERT-base {n_params} params, {' '.join(flags) or 'bf16'}"
          f", DDP at world 1, batch {BERT_BATCH} x {BERT_SEQ} padded "
          f"({100 * unpadded:.1f}% of positions unpadded): {steps} steps in "
          f"{wall:.2f} s, step ms " + " ".join(f"{1e3 * x:.2f}"
                                               for x in step_s)
          + f", median of steps 2-{steps} {step_ms:.2f} ms = "
          f"{stats['samples_per_s']:.1f} samples/s, peak memory {peak:.2f} "
          f"GiB; losses " + " ".join(f"{x:.4f}" for x in losses)
          + f"; the rows' loss, dropout off, {eval_before:.4f} -> "
          f"{eval_after:.4f}")
    if (len(losses) != steps or not all(map(math.isfinite, losses))
            or not eval_after < eval_before):
        raise AssertionError(f"({what}) losses {losses}, the rows' loss "
                             f"{eval_before} -> {eval_after}")
    run = steps
    if profile:
        batches = iter(trainer.train_loader)
        batch = {k: v.to(device) for k, v in next(batches).items()}
        batches.close()
        state = trainer.state
        for _ in range(2):
            state, metrics = trainer.train_step(state, batch)
        float(metrics["loss"])
        total_us, rows = profile_step(trainer.train_step, state, batch)
        run += 4
        busy_ms = total_us / 2e3
        families = by_family(rows, BERT_FAMILIES)
        if total_us:
            print(f"({what}) profile, 2 steps: device busy {busy_ms:.2f} "
                  f"ms/step against the unprofiled step of {step_ms:.2f} ms "
                  f"(idle {100 * (1 - busy_ms / step_ms):.1f}%)")
            for name, ms in sorted(families.items(), key=lambda kv: -kv[1]):
                print(f"  {ms:9.3f} ms/step  {100 * ms / busy_ms:5.1f}%  "
                      f"{name}")
            for key, us, count in rows[:12]:
                print(f"  {us / 2e3:9.3f} ms/step  x{count // 2:<5d} "
                      f"{key[:90]}")
        else:
            print(f"({what}) profiler: no device time recorded (not "
                  "measured)")
        stats["profile"] = dict(
            device_busy_ms=busy_ms, families=families,
            idle_share=(1 - busy_ms / step_ms) if total_us else None,
            top=[dict(name=k, ms_per_step=us / 2e3, count=c // 2)
                 for k, us, c in rows[:12]])
        del state, batch
    del model, trainer
    return stats, run


def _bert_snapshot(model, trainer):
    """Host copies of every parameter and AdamW tensor (moments and
    torch's ``step``), the scaler state, the step and the cursor."""
    opt = trainer.state.optimizer
    names = {id(p): n for n, p in model.named_parameters()}
    out = {n: p.detach().to("cpu", copy=True)
           for n, p in model.named_parameters()}
    for p, st in opt.state.items():
        for k, v in st.items():
            out[f"{names[id(p)]}.{k}"] = v.to("cpu", copy=True)
    ss = trainer.state.scaler_state
    out["scaler.scale"] = ss.scale.to("cpu", copy=True)
    out["scaler.growth_tracker"] = ss.growth_tracker.to("cpu", copy=True)
    return dict(tensors=out, step=trainer.state.step,
                cursor=(trainer._cursor_epoch, trainer._cursor_offset))


def _bert_fp16_checks(device, seed, tmp):
    """(9b) fp16 steps through fit() from a scale that overflows, each
    checked against the scaler's rule; (9c) the checkpoint fit() writes
    after them, restored into a fresh model to the bit, and the next
    steps repeated to the bit. Returns (stats, steps run)."""
    import torch

    from pytorch_distributed_tpu_torch import GradScaler

    def scaler():
        return GradScaler(init_scale=BERT_FP16_INIT,
                          growth_interval=BERT_GROWTH, dtype=torch.float16)

    model, trainer, ds, _ = _bert_build(
        device, seed, BERT_FP16_STEPS, "--fp16", "--ckpt-dir", tmp,
        scaler=scaler())
    opt = trainer.state.optimizer
    inner = trainer.train_step
    rule = dict(scale=BERT_FP16_INIT, tracker=0, grew=0, skipped=0)
    losses, finite, scales, bad = [], [], [], []

    def checked(state, batch):
        i = len(losses)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        moments = {id(p): {k: v.clone() for k, v in st.items()}
                   for p, st in opt.state.items()}
        state, m = inner(state, batch)
        ok = float(m["grads_finite"]) == 1.0
        losses.append(float(m["loss"]))
        finite.append(ok)
        # the JAX update rule, on the host
        if ok:
            rule["tracker"] += 1
            if rule["tracker"] >= BERT_GROWTH:
                rule.update(scale=rule["scale"] * 2, tracker=0,
                            grew=rule["grew"] + 1)
        else:
            rule.update(scale=rule["scale"] / 2, tracker=0,
                        skipped=rule["skipped"] + 1)
            if any(not torch.equal(p, before[n])
                   for n, p in model.named_parameters()):
                bad.append(f"step {i}: a parameter moved on a skipped step")
            if {id(p) for p in opt.state} != set(moments) or any(
                    not torch.equal(v, moments[id(p)][k])
                    for p, st in opt.state.items() for k, v in st.items()):
                bad.append(f"step {i}: AdamW's state moved on a skip")
        ss = state.scaler_state
        scales.append(float(ss.scale))
        if (float(ss.scale), int(ss.growth_tracker)) != (rule["scale"],
                                                         rule["tracker"]):
            bad.append(f"step {i}: scale {float(ss.scale)} tracker "
                       f"{int(ss.growth_tracker)}, want {rule['scale']} "
                       f"{rule['tracker']}")
        return state, m

    eval_before = _bert_eval_loss(model, ds, device)
    trainer.train_step = checked
    trainer.fit()   # checkpoints after its epoch: (9c)'s
    trainer.train_step = inner
    eval_after = _bert_eval_loss(model, ds, device)
    skipped, grew = rule["skipped"], rule["grew"]
    counts = {int(st["step"]) for st in opt.state.values()}
    if counts != {trainer.state.step - skipped}:
        bad.append(f"optimizer count {counts} != step "
                   f"{trainer.state.step} - {skipped} skips")
    done = [x for x, ok in zip(losses, finite) if ok]
    print(f"(9b) fp16, GradScaler(init_scale=2^40, growth_interval="
          f"{BERT_GROWTH}): {len(losses)} steps, {skipped} skipped "
          f"(parameters and AdamW state bitwise unchanged on each), "
          f"{grew} growth(s); optimizer count {sorted(counts)} at step "
          f"{trainer.state.step}; scales " + " ".join(
              f"2^{math.log2(x):g}" for x in scales)
          + "; losses of the applied steps " + " ".join(
              f"{x:.4f}" for x in done)
          + f"; the rows' loss, dropout off, {eval_before:.4f} -> "
          f"{eval_after:.4f}")
    falls = eval_after < eval_before
    if (bad or not skipped or not grew or not falls
            or len(losses) != BERT_FP16_STEPS
            or not all(map(math.isfinite, losses))):
        raise AssertionError(f"(9b) fp16 scaling: {bad[:5]}, {skipped} "
                             f"skips, {grew} growths, falls {falls}")
    stats = dict(steps=len(losses), skipped=skipped, growths=grew,
                 scales=scales, finite=finite, losses=losses,
                 optimizer_count=sorted(counts), step=trainer.state.step,
                 eval_loss=(eval_before, eval_after))

    # (9c) the checkpoint fit() wrote, the next steps on the same rows,
    # then a fresh model (other weights) restores it and repeats them
    saved = _bert_snapshot(model, trainer)
    resume = [{k: torch.from_numpy(v[:BERT_BATCH]).to(device)
               for k, v in ds.arrays.items()} for _ in range(BERT_RESUME)]
    after = []
    for batch in resume:
        trainer.state, m = trainer.train_step(trainer.state, batch)
        after.append(float(m["loss"]))
    final = _bert_snapshot(model, trainer)
    del model, trainer, opt
    model, trainer, _, _ = _bert_build(
        device, seed, BERT_FP16_STEPS, "--fp16", "--ckpt-dir", tmp,
        scaler=scaler(), init_seed=seed + 1)
    t0 = time.perf_counter()
    if not trainer.restore_checkpoint():
        raise AssertionError("(9c) nothing restored")
    restore_ms = 1e3 * (time.perf_counter() - t0)
    got = _bert_snapshot(model, trainer)
    bad = [k for k, v in saved["tensors"].items()
           if k not in got["tensors"] or not torch.equal(v, got["tensors"][k])]
    if (bad or set(got["tensors"]) != set(saved["tensors"])
            or got["step"] != saved["step"]
            or got["cursor"] != saved["cursor"]):
        raise AssertionError(
            f"(9c) restored state differs: {bad[:5]} step {got['step']} vs "
            f"{saved['step']} cursor {got['cursor']} vs {saved['cursor']}")
    again = []
    for batch in resume:
        trainer.state, m = trainer.train_step(trainer.state, batch)
        again.append(float(m["loss"]))
    end = _bert_snapshot(model, trainer)
    differ = [k for k, v in final["tensors"].items()
              if not torch.equal(v, end["tensors"][k])]
    print(f"(9c) checkpoint at step {saved['step']} (scale "
          f"{float(saved['tensors']['scaler.scale']):g}, tracker "
          f"{int(saved['tensors']['scaler.growth_tracker'])}), restored "
          f"into other weights in {restore_ms:.0f} ms: parameters, AdamW "
          f"state, scaler state, step and cursor equal to the bit; the next "
          f"{BERT_RESUME} steps " + " ".join(f"{x:.6f}" for x in again)
          + " against " + " ".join(f"{x:.6f}" for x in after)
          + f", {len(differ)} tensors differ after them")
    if again != after or differ:
        raise AssertionError(f"(9c) the resumed steps differ: {differ[:5]}")
    stats.update(restore_ms=restore_ms, resumed_losses=again)
    del model, trainer, saved, got, final, end, resume
    return stats, BERT_FP16_STEPS + 2 * BERT_RESUME


def bert_phase(device, seed):
    """Phase 9: the recipe's BERT-base fine-tune on one card, in a DDP
    world of one over NCCL: (9a) bf16 and (9b) fp16 through fit() with
    their profiles, (9b) the fp16 scaler's skips and growths checked
    step by step, (9c) a checkpoint with the scaler's state restored to
    the bit, (9d) a short MLM run. The four kernels' counts are set to 0
    before it and read after: 12 launches of each flash kernel a step."""
    import gc
    import tempfile

    import torch

    stats = {}
    with tempfile.TemporaryDirectory(prefix="ptd_bert_") as tmp, \
            _World1(device):
        kernel_counts(reset=True)
        stats["bf16"], run = _bert_fit(device, seed, BERT_STEPS, "9a")
        stats["fp16"], n = _bert_fit(device, seed, BERT_STEPS, "9b", "--fp16")
        run += n
        fp16 = stats["fp16"]["metrics"]
        print(f"(9b) timed run at the recipe's scaler (2^15): loss scale "
              f"{fp16['loss_scale'][0]:g} -> {fp16['loss_scale'][-1]:g}, "
              f"{int(sum(1 - x for x in fp16['grads_finite']))} skipped")
        checks, n = _bert_fp16_checks(device, seed, tmp)
        stats["fp16_scaler"] = checks
        run += n
        stats["mlm"], n = _bert_fit(
            device, seed, BERT_MLM_STEPS, "9d", "--mlm", "--lr",
            str(BERT_MLM_LR), profile=False)
        run += n
        counts = kernel_counts()
        mlm = stats["mlm"]
        frac = mlm["metrics"]["mask_frac"]
        want_frac = 0.15 * mlm["unpadded"]
        print(f"(9d) --mlm mask_frac " + " ".join(f"{x:.4f}" for x in frac)
              + f" against 0.15 x {mlm['unpadded']:.4f} unpadded = "
              f"{want_frac:.4f} (+- {BERT_MASK_TOL})")
        if any(abs(x - want_frac) > BERT_MASK_TOL for x in frac):
            raise AssertionError(f"(9d) MLM mask_frac {frac} against "
                                 f"{want_frac} +- {BERT_MASK_TOL}")
        layers = 12
        want = {k: layers * run for k in FLASH}
        print(f"BERT path: {run} steps, launches {counts} (want {want} and "
              "no paged kernel)")
        if {k: counts[k] for k in FLASH} != want:
            raise AssertionError(f"BERT flash launches {counts} != {want}")
        off_path(counts, FLASH)
        stats.update(launches=counts, steps_run=run)
    gc.collect()
    torch.cuda.empty_cache()
    return stats


# --------------------------------------------------------------------------
# Phase 10: generation, quantization and LoRA
# --------------------------------------------------------------------------

GEN_B, GEN_NEW = 8, 64                # (10a) rows and new tokens
GEN_PROMPT = (64, 256)                # (10a) ragged prompt lengths
GEN_RECIPE = ["--size", "medium", "--batch-size", "8", "--accum-steps",
              "1", "--seq-len", "512", "--steps-per-epoch", "2",
              "--sample", "32", "--log-every", "1"]
# greedy tokens vs the teacher-forced, cache-free forward of the same
# rows: the decode reads its K/V from the cache in bf16 through the
# einsum path, the reference recomputes them at another width, so the
# f32 logits (magnitude ~1-5 after two steps; bf16 products) move by a
# few bf16 ulps of the hidden state. phase 4's margin for Llama-3-8B is
# 0.25; GPT-2-medium's logits sit in the same range.
GEN_MARGIN = 0.25
BEAM_K, BEAM_NEW = 4, 16
# a beam's score against the teacher-forced sum of its log-probs over
# len**length_penalty: each of the 16 log-probs carries the GEN_MARGIN
# kind of noise (about 1e-2 measured per token, bf16), averaged by len
BEAM_MARGIN = 0.05
SPEC_K = 4
SPEC_SELF_ACCEPT = 0.95
# (10d) Llama-3-8B at full width; depth cut to fit the phase's time (the
# three variants each build, quantize and decode the model)
QUANT_LAYERS = 8
QUANT_B, QUANT_P, QUANT_NEW = 4, 128, 16
# quantized prefill logits vs the same model with the dequantized weights
# loaded as plain bf16: the same products on the same bf16 weights, so
# equal up to the order of cuBLAS's sums (0 expected); a wrong geometry
# reads ~1
QUANT_LOGIT_TOL = 1e-2
# (10e) the int8 cache is lossy (each K/V value within amax/254 of
# itself, on every value), so a greedy row may leave the exact cache's
# tokens at a near tie and continue elsewhere: agreement is printed, and
# each token is held to the exact model's teacher-forced forward of the
# int8 run's own rows, at twice GEN_MARGIN; a cache read with wrong
# scales or layout sits units away
KV8_MARGIN = 0.5
LORA_RANK, LORA_STEPS, QLORA_STEPS = 8, 20, 5


def _ragged_prompts(seed, vocab, device):
    """``GEN_B`` left-padded prompts of seeded lengths in ``GEN_PROMPT``:
    (ids [B, P], mask [B, P])."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 10)
    lens = rng.integers(GEN_PROMPT[0], GEN_PROMPT[1] + 1, GEN_B)
    lens[0] = GEN_PROMPT[1]
    P = GEN_PROMPT[1]
    ids = rng.integers(1, vocab, size=(GEN_B, P))
    mask = np.arange(P)[None] >= (P - lens)[:, None]
    ids = np.where(mask, ids, 0)
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(mask).to(device))


def _row_seqs(out, mask):
    """Each row's real tokens: its unpadded prompt, then what came out."""
    import torch

    P = mask.shape[1]
    return [torch.cat([out[b, :P][mask[b]], out[b, P:]])
            for b in range(out.shape[0])]


def _forced_gaps(model, out, mask):
    """For every generated token: the cache-free, teacher-forced forward's
    max logit minus the logit of the token chosen (einsum attention)."""
    import torch

    gaps, exact = [], 0
    new = out.shape[1] - mask.shape[1]
    with torch.no_grad():
        for seq in _row_seqs(out, mask):
            logits = model(seq[None], attn_impl="xla")[0, -new - 1:-1]
            if not torch.isfinite(logits).all():
                raise AssertionError("non-finite teacher-forced logits")
            toks = seq[-new:]
            mine = logits.gather(1, toks[:, None])[:, 0]
            gaps.extend((logits.max(-1).values - mine).tolist())
            exact += int((logits.argmax(-1) == toks).sum())
    return exact, gaps


def _cuda_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _decode_times(model, prompt, mask, new, **kw):
    """(out, prefill ms, decode ms a token, tokens/s): one prefill alone
    (``max_new_tokens=1``), then the whole call."""
    from pytorch_distributed_tpu_torch import generate

    kw.setdefault("device", prompt.device)
    _, pre_ms = _cuda_ms(lambda: generate(model, prompt, max_new_tokens=1,
                                          prompt_mask=mask, **kw))
    out, ms = _cuda_ms(lambda: generate(model, prompt, max_new_tokens=new,
                                        prompt_mask=mask, **kw))
    dec = (ms - pre_ms) / (new - 1)
    return out, pre_ms, dec, prompt.shape[0] * new / ms * 1e3


def _gpt2_sample(device, seed):
    """(10a) the recipe at --size medium, 2 steps then --sample 32."""
    from pytorch_distributed_tpu_torch.recipes import gpt2 as recipe

    kernel_counts(reset=True)
    t0 = time.perf_counter()
    trainer = recipe.main(GEN_RECIPE + ["--seed", str(seed)])
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    sample = trainer.sample
    if tuple(sample.shape) != (2, 8 + 32) or trainer.state.step != 2:
        raise AssertionError(f"(10a) --sample gave {tuple(sample.shape)} "
                             f"after {trainer.state.step} steps")
    losses = [r["loss"] for r in trainer.history]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"(10a) losses {losses}")
    print(f"(10a) recipes/gpt2.py {' '.join(GEN_RECIPE)}: 2 steps (losses "
          + " ".join(f"{x:.4f}" for x in losses) + f"), sample of 2 x 32 "
          f"new ids: {sample[0, 8:].tolist()}; {wall:.1f} s; launches "
          f"{counts}")
    off_path(counts, FLASH)
    model = getattr(trainer.state.model, "module", trainer.state.model)
    return model, counts, dict(losses=losses, sample=sample.tolist(),
                               wall_s=wall, launches=counts)


def _generation_checks(model, device, seed):
    """(10a) greedy ragged decode vs the teacher-forced forward, sampled
    repeat; (10b) penalties and beams; (10c) speculative decoding;
    (10e) the int8 KV cache."""
    import torch

    from pytorch_distributed_tpu_torch import (
        GPT2Config,
        GPT2LMHead,
        Policy,
        generate,
        generate_beam,
        generate_speculative,
    )
    from pytorch_distributed_tpu_torch.ops.attention import cache_bytes

    stats = {}
    cfg = model.config
    prompt, mask = _ragged_prompts(seed, cfg.vocab_size, device)
    generate(model, prompt[:, -8:], max_new_tokens=2, device=device)  # warm
    out, pre_ms, dec_ms, tps = _decode_times(model, prompt, mask, GEN_NEW)
    exact, gaps = _forced_gaps(model, out, mask)
    worst = max(gaps)
    print(f"(10a) greedy generate, B={GEN_B}, prompts "
          f"{mask.sum(1).tolist()} (left-padded to {mask.shape[1]}), "
          f"{GEN_NEW} new: prefill {pre_ms:.2f} ms, decode {dec_ms:.3f} "
          f"ms/token, {tps:.1f} tokens/s; {exact}/{len(gaps)} exact argmax "
          f"of the teacher-forced forward, worst gap {worst:.4f} (margin "
          f"{GEN_MARGIN})")
    if worst > GEN_MARGIN:
        raise AssertionError(f"(10a) greedy gap {worst} > {GEN_MARGIN}")
    kw = dict(max_new_tokens=GEN_NEW, prompt_mask=mask, temperature=0.8,
              top_k=40, device=device)
    runs = [generate(model, prompt, generator=torch.Generator(
        device=device).manual_seed(seed), **kw) for _ in range(2)]
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError("(10a) a sampled call repeated with the same "
                             "generator gave other ids")
    stats["greedy"] = dict(prefill_ms=pre_ms, decode_ms_per_token=dec_ms,
                           tokens_per_s=tps, exact=exact, tokens=len(gaps),
                           worst_gap=worst, margin=GEN_MARGIN)

    # (10b) penalties: no 3-gram may repeat in any row
    pen = generate(model, prompt, max_new_tokens=GEN_NEW, prompt_mask=mask,
                   repetition_penalty=1.3, no_repeat_ngram_size=3,
                   device=device)
    repeats = 0
    for seq in _row_seqs(pen, mask):
        s = seq.tolist()
        grams = [tuple(s[i:i + 3]) for i in range(len(s) - 2)]
        # a gram ending at a generated token may not appear earlier
        first = len(s) - GEN_NEW - 2
        seen = set(grams[:max(first, 0)])
        for g in grams[max(first, 0):]:
            repeats += g in seen
            seen.add(g)
    print(f"(10b) repetition_penalty=1.3, no_repeat_ngram_size=3: "
          f"{repeats} banned 3-grams in {GEN_B} rows")
    if repeats:
        raise AssertionError(f"(10b) {repeats} repeated 3-grams")
    bp = prompt[:2, -64:]
    (beams, scores), beam_ms = _cuda_ms(lambda: generate_beam(
        model, bp, max_new_tokens=BEAM_NEW, num_beams=BEAM_K,
        return_scores=True, device=device))
    with torch.no_grad():
        lp = torch.log_softmax(model(beams, attn_impl="xla").float(), -1)
    P = bp.shape[1]
    toks = beams[:, P:]
    forced = lp[:, P - 1:-1].gather(2, toks[..., None])[..., 0].sum(1)
    forced = forced / BEAM_NEW ** 1.0
    beam_err = (forced - scores).abs().max().item()
    print(f"(10b) generate_beam num_beams={BEAM_K}, {BEAM_NEW} new, "
          f"{beam_ms:.1f} ms: scores {scores.tolist()} against the "
          f"teacher-forced {forced.tolist()}, max diff {beam_err:.4f} "
          f"(margin {BEAM_MARGIN})")
    if not beam_err <= BEAM_MARGIN:
        raise AssertionError(f"(10b) beam scores off by {beam_err}")
    stats["penalties"] = dict(banned_repeats=repeats)
    stats["beam"] = dict(ms=beam_ms, scores=scores.tolist(),
                         forced=forced.tolist(), max_diff=beam_err,
                         margin=BEAM_MARGIN)

    # (10c) speculative decoding, target = this model
    draft = GPT2LMHead(GPT2Config.small(), device=device,
                       policy=Policy.train())
    draft.init_weights(torch.Generator(device=device).manual_seed(seed + 3))
    spec = {}
    for name, d in (("small", draft), ("self", model)):
        (sout, st), ms = _cuda_ms(lambda: generate_speculative(
            model, d, prompt, max_new_tokens=GEN_NEW, num_draft_tokens=SPEC_K,
            prompt_mask=mask, return_stats=True, device=device))
        sx, sg = _forced_gaps(model, sout, mask)
        agree = (sout[:, -GEN_NEW:] == out[:, -GEN_NEW:]).float().mean()
        rate = st["accepted"] / max(st["drafted"], 1)
        spec[name] = dict(ms=ms, tokens_per_s=GEN_B * GEN_NEW / ms * 1e3,
                          acceptance=rate, rounds=st["rounds"],
                          agree_with_generate=agree.item(), worst_gap=max(sg),
                          exact=sx)
        print(f"(10c) speculative, draft {name}, k={SPEC_K}, greedy: "
              f"{ms:.1f} ms = {spec[name]['tokens_per_s']:.1f} tokens/s "
              f"(generate {tps:.1f}), acceptance {rate:.3f} over "
              f"{st['rounds']} rounds, tokens equal to generate's "
              f"{100 * agree.item():.1f}%, worst teacher-forced gap "
              f"{max(sg):.4f} (margin {GEN_MARGIN})")
        if max(sg) > GEN_MARGIN:
            raise AssertionError(f"(10c) {name}: gap {max(sg)}")
    if spec["self"]["acceptance"] < SPEC_SELF_ACCEPT:
        raise AssertionError(f"(10c) self-draft acceptance "
                             f"{spec['self']['acceptance']}")
    (_, st), ms = _cuda_ms(lambda: generate_speculative(
        model, draft, prompt, max_new_tokens=GEN_NEW,
        num_draft_tokens=SPEC_K, prompt_mask=mask, temperature=0.8,
        top_k=40, return_stats=True, device=device,
        generator=torch.Generator(device=device).manual_seed(seed)))
    spec["sampled_small_acceptance"] = st["accepted"] / max(st["drafted"], 1)
    print(f"(10c) sampled (T 0.8, top-k 40), draft small: acceptance "
          f"{spec['sampled_small_acceptance']:.3f}, {ms:.1f} ms")
    stats["speculative"] = spec
    del draft

    # (10e) the int8 KV cache on the same weights
    q8 = GPT2LMHead(dataclasses.replace(cfg, kv_cache_quantize="int8"),
                    device=device, policy=model.policy)
    q8.load_state_dict(model.state_dict())
    out8, pre8, dec8, tps8 = _decode_times(q8, prompt, mask, GEN_NEW)
    agree = (out8[:, -GEN_NEW:] == out[:, -GEN_NEW:]).float().mean().item()
    x8, g8 = _forced_gaps(model, out8, mask)
    L = mask.shape[1] + GEN_NEW
    ratio = cache_bytes(q8.init_cache(GEN_B, L)) / cache_bytes(
        model.init_cache(GEN_B, L))
    print(f"(10e) kv_cache_quantize='int8': tokens equal to the exact "
          f"cache's {100 * agree:.1f}%, {x8}/{len(g8)} the exact model's "
          f"teacher-forced argmax, worst gap {max(g8):.4f} (margin "
          f"{KV8_MARGIN}); decode {dec8:.3f} ms/token (exact "
          f"{dec_ms:.3f}), cache bytes {ratio:.4f} x bf16 (0.5 + "
          f"2/head_dim = {0.5 + 2 / cfg.head_dim:.4f})")
    if max(g8) > KV8_MARGIN or abs(ratio - (0.5 + 2 / cfg.head_dim)) > 1e-9:
        raise AssertionError(f"(10e) gap {max(g8)}, bytes {ratio}")
    stats["kv_int8"] = dict(agreement=agree, exact=x8, worst_gap=max(g8),
                            margin=KV8_MARGIN, decode_ms_per_token=dec8,
                            prefill_ms=pre8, bytes_ratio=ratio)
    del q8
    return stats


def _llama_quant(device, seed):
    """(10d) Llama-3-8B at full width and ``QUANT_LAYERS`` layers, seeded
    bf16 weights: bf16, then int8 and int4 trees
    (``quantize_for_scan_dequant``) in ``QuantizedModel``."""
    import gc

    import torch

    from pytorch_distributed_tpu_torch import LlamaConfig, LlamaForCausalLM
    from pytorch_distributed_tpu_torch.ops import (
        QuantizedModel,
        dequantize_tree,
        quantize_for_scan_dequant,
        quantized_bytes,
    )
    from pytorch_distributed_tpu_torch.ops.attention import cache_bytes
    from pytorch_distributed_tpu_torch.ops.quant import (
        _is_qleaf,
        dequantize_leaf,
    )

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_layers=QUANT_LAYERS)

    def build():
        m = LlamaForCausalLM(cfg, device=device)
        m.init_weights(torch.Generator(device=device).manual_seed(seed))
        return m.requires_grad_(False)

    ids = torch.randint(1, cfg.vocab_size, (QUANT_B, QUANT_P),
                        generator=torch.Generator(device=device)
                        .manual_seed(seed + 5), device=device)
    mask = torch.ones_like(ids, dtype=torch.bool)
    model = build()
    with torch.no_grad():
        model(ids[:, :8])
    _, pre, dec, _ = _decode_times(model, ids, mask, QUANT_NEW)
    stats = dict(layers=QUANT_LAYERS, bf16=dict(prefill_ms=pre,
                                                decode_ms_per_token=dec))
    trees = {k: quantize_for_scan_dequant(model, k) for k in ("int8",
                                                              "int4")}
    sd = dict(model.named_parameters())
    for kind, tree in trees.items():
        worst = 0.0
        for name, leaf in tree.items():
            if not _is_qleaf(leaf):
                continue
            g = tree.geometry[name]
            f = g.to_jax(sd[name]).float()
            err = (dequantize_leaf(leaf) - f).abs()
            scale = leaf["scale"]
            if kind == "int4":
                shape = (*err.shape[:-2], scale.shape[-3], -1, err.shape[-1])
                err, f = err.reshape(shape), f.reshape(shape)
            slack = 4 * torch.finfo(torch.float32).eps * f.abs()
            worst = max(worst, float(((err - slack) / scale).max()))
        print(f"(10d) {kind}: every quantized leaf within "
              f"{worst:.4f} x scale of its source (<= 0.5)")
        if worst > 0.5:
            raise AssertionError(f"(10d) {kind} dequantizes {worst} x scale "
                                 "from its source")
        stats[kind] = dict(worst_err_over_scale=worst)
    layer_bf16 = sum(p.numel() * 2 for p in model.layers[0].parameters())
    del model, sd
    gc.collect()
    torch.cuda.empty_cache()
    for kind, tree in trees.items():
        m = build()
        m.load_state_dict(dequantize_tree(tree, torch.bfloat16))
        with torch.no_grad():
            ref = m(ids)
        qm = QuantizedModel(m, tree, dtype=torch.bfloat16)
        gc.collect()
        torch.cuda.empty_cache()
        with torch.no_grad():
            got = qm(ids)
        diff = (got - ref).abs().max().item()
        resident = sum(t.numel() * t.element_size() for t in
                       list(qm.parameters()) + list(qm.buffers()))
        want = quantized_bytes(tree)
        cache = cache_bytes(m.init_cache(QUANT_B, QUANT_P + QUANT_NEW))
        margin = 3 * QUANT_B * QUANT_P * cfg.vocab_size * 4 + 2**28
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        _, pre, dec, _ = _decode_times(qm, ids, mask, QUANT_NEW)
        peak = torch.cuda.max_memory_allocated(device) - base
        limit = layer_bf16 + cache + margin
        print(f"(10d) {kind}: prefill logits vs the dequantized bf16 model "
              f"max |diff| {diff:.3g} (tol {QUANT_LOGIT_TOL}); resident "
              f"weights {resident / 2**30:.3f} GiB = quantized_bytes "
              f"{want / 2**30:.3f} GiB; decode peak above them "
              f"{peak / 2**30:.3f} GiB <= one layer's bf16 "
              f"{layer_bf16 / 2**30:.3f} + cache {cache / 2**30:.3f} + "
              f"activations {margin / 2**30:.3f} GiB; prefill {pre:.1f} ms,"
              f" decode {dec:.2f} ms/token (bf16 "
              f"{stats['bf16']['decode_ms_per_token']:.2f})")
        if diff > QUANT_LOGIT_TOL or resident != want or peak > limit:
            raise AssertionError(f"(10d) {kind}: diff {diff}, resident "
                                 f"{resident} vs {want}, peak {peak} > "
                                 f"{limit}")
        stats[kind].update(logit_diff=diff, resident_bytes=resident,
                           quantized_bytes=want, decode_peak_bytes=peak,
                           peak_limit_bytes=limit, prefill_ms=pre,
                           decode_ms_per_token=dec)
        del m, qm, ref, got
        gc.collect()
        torch.cuda.empty_cache()
    return stats


def _lora_snapshot(lm, trainer):
    """Host copies of the adapters, their AdamW state, the step and the
    cursor."""
    opt = trainer.state.optimizer
    names = {id(p): n for n, p in lm.named_parameters()}
    out = {n: p.detach().to("cpu", copy=True)
           for n, p in lm.named_parameters() if p.requires_grad}
    for p, st in opt.state.items():
        for k, v in st.items():
            out[f"{names[id(p)]}.{k}"] = v.to("cpu", copy=True)
    return dict(tensors=out, step=trainer.state.step,
                cursor=(trainer._cursor_epoch, trainer._cursor_offset))


def _bert_lora(device, seed, tmp):
    """(10f) the recipe's --lora 8 at BERT-base through build_trainer."""
    import gc

    import torch

    from pytorch_distributed_tpu_torch import lora_param_count

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    flags = ("--lora", str(LORA_RANK), "--ckpt-dir", tmp)
    lm, trainer, ds, _ = _bert_build(device, seed, LORA_STEPS, *flags)
    base = {n: t.detach().clone() for n, t in lm.model.state_dict().items()
            if not n.endswith((".a", ".b"))}
    trainable = [p for p in lm.parameters() if p.requires_grad]
    n_train = sum(p.numel() for p in trainable)
    if n_train != lora_param_count(lm.adapters()):
        raise AssertionError(f"(10f) {n_train} trainable != "
                             f"{lora_param_count(lm.adapters())}")
    before = _bert_eval_loss(lm, ds, device)
    kernel_counts(reset=True)
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    after = _bert_eval_loss(lm, ds, device)
    peak = (torch.cuda.max_memory_allocated(device) - left) / 2**30
    moved = [n for n, t in lm.model.state_dict().items()
             if n in base and not torch.equal(t, base[n])]
    opt = trainer.state.optimizer
    ids = {id(p) for p in trainable}
    opt_bytes = sum(v.numel() * v.element_size() for st in opt.state.values()
                    for v in st.values())
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    steady = sorted(r["step_time_s"] for r in hist[1:])
    step_ms = 1e3 * steady[len(steady) // 2]
    want = {k: 12 * LORA_STEPS for k in FLASH}
    print(f"(10f) BERT-base --lora {LORA_RANK}, bf16, batch {BERT_BATCH} x "
          f"{BERT_SEQ}, {LORA_STEPS} steps in {wall:.2f} s: {n_train} "
          f"trainable = lora_param_count, median step {step_ms:.2f} ms = "
          f"{BERT_BATCH / step_ms * 1e3:.1f} samples/s, peak "
          f"{peak:.2f} GiB, optimizer state {opt_bytes / 2**20:.2f} MiB; "
          f"losses "
          + " ".join(f"{x:.4f}" for x in losses) + f"; the rows' loss, "
          f"dropout off, {before:.4f} -> {after:.4f}; base tensors moved "
          f"{len(moved)}; launches {counts} (want {want})")
    if (moved or set(map(id, opt.state)) != ids
            or not all(map(math.isfinite, losses)) or not after < before
            or {k: counts[k] for k in FLASH} != want):
        raise AssertionError(f"(10f) moved {moved[:3]}, optimizer state "
                             f"{len(opt.state)} vs {len(ids)}, losses "
                             f"{losses}, {before} -> {after}, {counts}")
    off_path(counts, FLASH)
    stats = dict(trainable=n_train, steps=LORA_STEPS, losses=losses,
                 eval_loss=(before, after), step_ms_median=step_ms,
                 samples_per_s=BERT_BATCH / step_ms * 1e3, peak_mem_gib=peak,
                 optimizer_state_bytes=opt_bytes, launches=counts)

    # the checkpoint fit() wrote, into a fresh trainer (fresh adapters)
    saved = _lora_snapshot(lm, trainer)
    del lm, trainer, opt
    lm, trainer, _, _ = _bert_build(device, seed, LORA_STEPS, *flags)
    if not trainer.restore_checkpoint():
        raise AssertionError("(10f) nothing restored")
    got = _lora_snapshot(lm, trainer)
    bad = [k for k, v in saved["tensors"].items()
           if k not in got["tensors"] or not torch.equal(v, got["tensors"][k])]
    if (bad or set(got["tensors"]) != set(saved["tensors"])
            or (got["step"], got["cursor"]) != (saved["step"],
                                                saved["cursor"])):
        raise AssertionError(f"(10f) restored LoRA state differs: {bad[:5]}")
    print(f"(10f) the LoRA checkpoint at step {saved['step']} restored to "
          f"the bit: {len(saved['tensors'])} adapter tensors and moments, "
          f"step and cursor")
    del lm, trainer

    # QLoRA: an int8 base
    args_flags = ("--lora", str(LORA_RANK))
    from pytorch_distributed_tpu_torch.models.bert import BertConfig
    from pytorch_distributed_tpu_torch.recipes import bert_finetune

    args = bert_finetune.parse_args(
        ["--batch-size", str(BERT_BATCH), "--seq-len", str(BERT_SEQ),
         "--steps-per-epoch", str(QLORA_STEPS), "--log-every", "1",
         "--seed", str(seed), *args_flags])
    qds, _ = _bert_rows(seed, BertConfig.base().vocab_size, QLORA_STEPS)
    kernel_counts(reset=True)
    qlm, qtrainer = bert_finetune.build_trainer(args, device, dataset=qds,
                                                quantize="int8")
    qtrainer.fit()
    qcounts = kernel_counts()
    qlosses = [r["loss"] for r in qtrainer.history]
    print(f"(10f) QLoRA, int8 base: {QLORA_STEPS} steps, losses "
          + " ".join(f"{x:.4f}" for x in qlosses) + f"; launches {qcounts}")
    if len(qlosses) != QLORA_STEPS or not all(map(math.isfinite, qlosses)):
        raise AssertionError(f"(10f) QLoRA losses {qlosses}")
    stats["qlora"] = dict(losses=qlosses, launches=qcounts)
    launches = {k: counts[k] + qcounts[k] for k in counts}
    del qlm, qtrainer
    gc.collect()
    torch.cuda.empty_cache()
    return stats, launches


def generation_phase(device, seed):
    """Phase 10: (10a) the GPT-2 recipe's --sample and greedy ragged
    decode, (10b) penalties and beams, (10c) speculative decoding, (10e)
    the int8 KV cache, all on the recipe's GPT-2-medium; (10d) int8 and
    int4 Llama-3-8B; (10f) BERT-base --lora 8 and QLoRA. Returns (stats,
    launches by path)."""
    import gc
    import tempfile

    import torch

    from pytorch_distributed_tpu_torch.runtime.device import device_info

    print(f"phase 10 on {device_info()}")
    stats, by_path = {}, {}
    # the one cut of size in this phase, named in the details line
    stats["cuts"] = {"10d": f"Llama-3-8B at {QUANT_LAYERS} of 32 layers, "
                            "full width"}
    t0 = time.perf_counter()
    with _World1(device):
        model, by_path["gpt2_sample"], stats["recipe"] = _gpt2_sample(
            device, seed)
        kernel_counts(reset=True)
        stats.update(_generation_checks(model, device, seed))
        by_path["generation"] = kernel_counts()
        off_path(by_path["generation"], ())
        del model
        gc.collect()
        torch.cuda.empty_cache()
        kernel_counts(reset=True)
        stats["quant"] = _llama_quant(device, seed)
        by_path["quant"] = kernel_counts()
        # the prefill-logit checks run the model's plain forward: flash
        off_path(by_path["quant"], ("flash_fwd",))
        with tempfile.TemporaryDirectory(prefix="ptd_lora_") as tmp:
            stats["lora"], by_path["lora"] = _bert_lora(device, seed, tmp)
    stats["wall_s"] = time.perf_counter() - t0
    stats["launches"] = by_path
    print(f"phase 10: {stats['wall_s']:.1f} s; launches by path {by_path}")
    return stats, by_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from pytorch_distributed_tpu_torch.ops import kernel_build
        from pytorch_distributed_tpu_torch.runtime.device import device_info
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = kernel_build.build(["paged_attention", "flash_attention"])
    print(f"build: {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s")
    build_report = kernel_report(libs)

    record, kdetails = kernel_phase(device, args.seed)
    flash_records, fdetails = flash_phase(device, args.seed)
    fdetails["build"] = build_report
    # serve, ResNet and ZeRO-1 before train: the train phase ends with
    # torch.profiler, whose tracing of the host would slow the host-bound
    # paths after it (the Llama step after it is device-bound: the card's
    # time, not the host's, sets its pace).
    # Each path reads all four kernel counts around its run (serve, 7a,
    # train and 8a inside their phases).
    serve_counts, stats = serve_phase(device, args.seed)
    torch.cuda.empty_cache()
    kernel_counts(reset=True)
    rstats = resnet_phase(device, args.seed)
    # the ResNet path runs none of the four kernels
    rstats["kernel_launches"] = kernel_counts()
    print(f"ResNet path: launches of the four kernels "
          f"{rstats['kernel_launches']} (none on this path)")
    off_path(rstats["kernel_launches"], ())
    zstats = zero1_phase(device, args.seed)
    gstats, gen_paths = generation_phase(device, args.seed)
    train_counts, tstats = train_phase(device, args.seed, flash_records)
    lstats = llama_phase(device, args.seed)
    bstats = bert_phase(device, args.seed)
    zt = zstats["train"]
    print(f"GPT-2-medium, batch 8 x 1024: ZeRO-1 + remat + chunked loss "
          f"{zt['step_ms_median']:.2f} ms/step ({zt['loop_step_ms']:.2f} in "
          f"a plain loop), {zt['tokens_per_s']:.0f} tokens/s, peak "
          f"{zt['peak_mem_gib']:.2f} GiB; train phase (no "
          f"remat, full logits, no ZeRO) {tstats['step_ms_median']:.2f} "
          f"ms/step, {tstats['tokens_per_s']:.0f} tokens/s, peak "
          f"{tstats['peak_mem_gib']:.2f} GiB")
    print(f"Llama-3-8B width, {LLAMA_LAYERS} layers, FSDP + remat + chunked "
          f"loss, batch {LLAMA_BATCH} x {LLAMA_SEQ}: "
          f"{lstats['step_ms_median']:.2f} ms/step, "
          f"{lstats['tokens_per_s']:.0f} tokens/s, peak "
          f"{lstats['peak_mem_gib']:.2f} GiB, device busy "
          f"{lstats['profile']['device_busy_ms']:.2f} ms/step")
    for name in ("bf16", "fp16"):
        b = bstats[name]
        print(f"BERT-base fine-tune {name}, batch {BERT_BATCH} x {BERT_SEQ}:"
              f" {b['step_ms_median']:.2f} ms/step, "
              f"{b['samples_per_s']:.1f} samples/s, peak "
              f"{b['peak_mem_gib']:.2f} GiB, device busy "
              f"{b['profile']['device_busy_ms']:.2f} ms/step")
    lo = gstats["lora"]
    print(f"BERT-base --lora {LORA_RANK}, bf16: {lo['step_ms_median']:.2f} "
          f"ms/step, {lo['samples_per_s']:.1f} samples/s, peak "
          f"{lo['peak_mem_gib']:.2f} GiB (the full fine-tune above: "
          f"{bstats['bf16']['peak_mem_gib']:.2f}), optimizer state "
          f"{lo['optimizer_state_bytes'] / 2**20:.2f} MiB")
    by_path = dict(serve=serve_counts, resnet=rstats["kernel_launches"],
                   zero1=zt["launches"], train=train_counts,
                   llama=lstats["launches"], bert=bstats["launches"],
                   **gen_paths)
    print(f"launches by path, each read around its run: {by_path}")
    for rec in [record] + flash_records:
        rec["launches_by_path"] = {path: counts[rec["name"]]
                                   for path, counts in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
    rstats["profile"] = resnet_profile(device, args.seed,
                                       rstats["bench"]["step_ms"])

    card = device_info()
    print(json.dumps({"details": dict(kernel=kdetails, flash=fdetails,
                                      train=tstats, serve=stats,
                                      resnet=rstats, zero1=zstats,
                                      llama=lstats, bert=bstats,
                                      generation=gstats)}))
    print(json.dumps({"kernels": [record] + flash_records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
