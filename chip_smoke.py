#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: build its kernels, hold
each against its plain PyTorch version, serve Llama-3-8B, train
ResNet-50 data-parallel, run the JAX recipe's GPT-2-medium ZeRO-1
configuration with checkpoints, train GPT-2-medium, run the JAX
recipe's Llama-3-8B FSDP full-shard configuration at full width, and
run the JAX recipe's BERT-base fine-tune in bf16 and fp16, run
generation (GPT-2 decode, beams, speculative decoding, the int8 KV
cache), int8/int4 Llama-3-8B and BERT-base LoRA, serve GPT-2-small
through the rest of the serving stack (int8 pools, speculative ticks, a
prefill/decode fleet behind the router), run the ResNet-18/CIFAR-10
recipe and the rest of image training (the native pipeline's staging
ring, EMA and the writers, image folders, ZeRO-1 for ResNet, the q8
wire form), run the trainer's lifecycle (Adafactor on the Llama
recipe, async/pruned/best checkpoints, MFU, goodput, the profiler
window, the watchdog), and run the model families (Gemma, Mistral,
Qwen2, Qwen3, Phi-3, tied Llama-3.2 through the paged engine, Pythia-1B
through generate, Gemma-2B width through the Trainer, HF weights loaded
and exported) with the kernels at head_dim 96 and 256, and the flash
kernels at the per-rank shapes of tensor and sequence parallelism with
the recipe's sequence-parallel path, and T5-base (training, its
cross-attention's kernels, ``generate_encdec``, the seq2seq recipe, the
HF layout), and pipeline parallelism (the host 1F1B executor over two
stage processes on the card, the GPipe form at one stage).

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
   the same K/V gathered dense. Then the same at GPT-2-small's shape (12
   heads of 64, one query head per kv head, 32 pages of 32): decode W=1,
   verify W=5, a 1-page bucket and W=5 rows at a split boundary, timed
   at W=1 and W=5.
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
   GPT-2-medium at full width and ``ZERO_LAYERS`` (12) of its 24 layers
   (cut for phase 18's time) under ``Policy.train()``,
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
   (a) Llama-3-8B at full width and 2 of its 32 layers (1.49 B
   parameters: one card cannot hold the 8B AdamW state) under
   ``Policy.train()``, FSDP full-shard at world 1 over NCCL (made on the
   meta device, each rank drawing its rows of the seeded weights), full
   remat, vocab chunk 8192, batch 8 x 2048, clip(1.0) then adamw(1e-4,
   decay 1e-4), 6 steps: finite losses, flash launches 4 forward, 2 dq,
   2 dkv a step and no paged launch, the median of steps 2-6, tokens/s
   and peak memory; then ``torch.profiler`` over two steps: device busy
   ms, idle share, time by kernel family. (Its 17.9 GB checkpoint round
   trip was cut for the smoke's time when phase 17 came: the FSDP round
   trip is ``scripts/port_fsdp_scale.py``'s on four cards and
   ``tests/test_torch_fsdp_ckpt.py``'s on the CPU.) (b) is phase 3's
   Llama-shape case and timing.

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

11. serving GPT-2-small (after 4), at full width and depth, seeded bf16
   weights, bench_serving's shape (8 slots, 32 requests of 64-token
   prompts, 64 new): (11a) the paged solo engine (launches = ticks x 12,
   every greedy token within ``GREEDY_MARGIN`` of a teacher-forced
   forward) and the dense tick; (11b) int8 pools (no launch, the pool
   at most ``KV8_POOL_RATIO`` of the f32 pool's bytes, tokens against
   the int8 model's own teacher-forced forward); (11c) ``SpecConfig``
   k=4, the target as its own draft (launches = verify ticks x 12, the
   acceptance; streams part from 11a's only at near-ties); (11d) 32
   requests sharing a 64-token prompt: a solo engine, then a 2 + 2
   prefill/decode fleet behind the router with a prefix store, clean and
   with one decode engine lost (``serve.engine_loss``): every stream
   equal to the solo engine's, store puts = the prefix's pages, payload
   bytes = frames x pages x ``frame_nbytes``. Paths ``serve_gpt2``,
   ``serve_gpt2_dense``, ``serve_gpt2_int8``, ``serve_gpt2_spec``,
   ``serve_gpt2_solo_ref``, ``serve_gpt2_fleet``,
   ``serve_gpt2_fleet_loss``.

12. image-classification training, complete (after 6, before 7; its
   profile last): (12a) ``recipes/resnet18_cifar10.main`` at its
   defaults (batch 128, ``ResNet18(stem="cifar")``, no cut) on
   full-size CIFAR-10 pickles written from the seed (50,000 + 10,000
   images, ~184 MB), ``--steps-per-epoch 50``, one epoch and its eval,
   traced: step ms, images/s, ``ingest.fetch`` ms, the
   ``train.data_wait`` share; its train feed through the staging ring
   (pinned buffers reused behind each copy's CUDA event, each copy
   queued behind a long matmul) bitwise equal to fresh allocations, the
   ring reused; at the end ``torch.profiler`` over two of its steps
   (device busy ms, idle share). (12b) ``recipes/resnet50_imagenet.main
   --ema-decay 0.999 --tensorboard-dir --metrics-path`` (batch 64,
   224^2, 10 steps): the JSONL and the event file read back, every CRC
   checks, the evaluation on the shadow; where PIL imports, ``--data-dir``
   on 640 PIL-written JPEGs in 10 classes, two of them damaged: images/s
   beside the synthetic feed's, both damaged files quarantined (where PIL
   does not import, a line says the folder path did not run). (12c)
   ``--strategy zero1`` against ``dp`` at world 1, 5 steps, cuDNN
   deterministic: losses within ``ZERO1_LOSS_RTOL``. (12d) the q8 round
   trip on the card bitwise the CPU's; the compressed all-reduce the
   identity in a world of one. Paths ``resnet18_cifar10``,
   ``resnet50_ema``, ``resnet50_folders``, ``resnet50_dp_det``,
   ``resnet50_zero1_det``: none of the four kernels runs on them.

13. the trainer's lifecycle and the optimizer library, after 9 (13c
   last of all, after the profiles): (13a) the Llama recipe's
   ``--optimizer adafactor`` at 8a's cut (2 of 32 layers, 8 x 2048,
   Adafactor(1e-2) alone on one repeated batch, ``log_mfu``): step ms,
   tokens/s, peak memory and the optimizer state's exact bytes beside
   8a's AdamW, the loss falling, MFU over ``peak_flops()`` with the
   flash kernels' FLOPs in it, a checkpoint at 3 restored into another
   model to the bit (Adafactor's state included) and steps 4-6 equal;
   launches 24/12/12. (13b) the GPT-2 recipe's ZeRO-1 trainer at
   GPT-2-medium's width and ``LIFE_LAYERS`` layers, 2 epochs of 3 steps,
   a step tag every 2 steps with 2 kept, ``best`` on the eval loss
   (min), early stopping: once with async saves (the main path), once
   with sync ones; each leaves tags ``[4, 6]`` and ``best`` at the best
   eval's step, goodput buckets summing to wall; the two runs' losses
   equal; the async run's last 'latest' CRCs equal to a sync save of
   the same state; the ``train.checkpoint`` span and the median step
   with each. (13c) ``recipes/resnet50_imagenet.py`` through its
   ``RecipeConfig`` at batch 64 with ``--log-mfu --profile-dir
   --keep-checkpoints 2 --async-checkpoint --keep-best accuracy``: MFU
   beside the card's name and peak, the profiler's Chrome trace parsed
   (device kernels in it), goodput summing to wall. (13d) one 1.8 s
   stall in a batch fetch against ``stall_timeout_s`` 1.0: the
   watchdog fires once and goodput's ``stalled`` holds it. Paths
   ``llama_adafactor``, ``gpt2_lifecycle``, ``gpt2_lifecycle_sync``
   (B1-B3), ``resnet50_recipe_config``, ``watchdog`` (none).
14. the model families, after 13a/b/d and before the profiles, seeded
   bf16 weights at published widths: (14a) ``ServeEngine`` (8 slots,
   32-token pages, phase 4's request mix) on Gemma-2B at full depth
   (head_dim 256, 8 query heads over 1 kv head, the tied 256k head),
   Qwen2-7B (groups of 7, q/k/v biases), Qwen3-8B (QK norms), Phi-3-mini
   (head_dim 96) and Mistral-7B at ``FAMILY_LAYERS`` of their layers,
   Llama-3.2-1B (tied) at full depth, and Mistral again with its window
   cut to ``MISTRAL_CUT_WINDOW`` so that the band masks inside the
   prompts: every request completes, the paged kernel launches ticks x
   layers, greedy tokens within ``GREEDY_MARGIN`` of the teacher-forced
   einsum forward; then the paged kernel at those decode ticks against
   ``stream`` and ``gather`` (and Mistral's window), timed beside its
   bound, plain version and SDPA. (14b) Pythia-1B (NeoX, head_dim 256)
   at full depth through ``generate`` on its dense cache, 8 x 256 + 64
   greedy tokens within the margin of an uncached forward, which runs
   the flash forward once a layer. (14c) the flash kernels at Phi-3-mini's
   (4 x 2048, 32 heads of 96), Gemma-2B's (8 over 1 of 256) and
   Pythia-1B's (8 of 256) causal training shapes against their plain
   versions, timed beside SDPA and the bound in bf16 and fp16; then 6
   Trainer steps of Gemma-2B width at ``FAMILY_LAYERS`` layers (remat,
   the chunked loss through the tied head, 8 x 1024 packed rows): the
   loss falls, B1-B3 launch 48/24/24. (14d) a seeded HF-named dict of
   Qwen2 at 7B width and of Phi-3-mini (fused projections), 2 layers
   each, loaded on the CPU and on the card in f32: logits within 1e-5
   of their largest magnitude, the export bitwise equal to the input.
   Paths ``family_<model>`` (the paged kernel), ``family_pythia_1b``
   (the flash forward), ``family_gemma_2b_train`` (B1-B3).
15. tensor and sequence parallelism, after phase 14: (15a) B1-B3 in bf16
   at the per-rank shapes of Llama-3-8B's parallel runs, causal: Ulysses
   at sp 4 (4 x 8192, 8 query over 2 kv heads of 128, the whole sequence
   on each rank after the all-to-all) and TP at tp 2 (8 x 2048, 16 over
   4 heads), against their plain versions at phase 3's limits, timed from
   CUDA graphs beside SDPA's forward and backward and the bound. (15b)
   the Llama recipe's ``main`` at Llama-3-8B width cut to ``SP_LAYERS``
   layers, 4 x 2048, ``--tp 1 --sp 1``, in a NCCL world of one: plain,
   then inside ``sequence_parallel`` in ring and in Ulysses mode (sp =
   1): the losses within ``SP_LOSS_RTOL`` of the plain run's; the plain
   path and Ulysses launch B1, B2 and B3 layers x steps times each, ring
   none (its blocks are f32 products). A control run of ring with its
   causal mask off must read beyond ``SP_LOSS_RTOL``. Paths ``sp_plain``,
   ``sp_ring``, ``sp_ulysses``.
16. mixture-of-experts and ViT, after phase 15: (16a) the ViT recipe's
   ``main`` at ViT-B/16 (no cut), ``VIT_BATCH`` synthetic u8 224^2
   images a step normalized and flipped on the card, ``VIT_STEPS`` steps
   and one eval: finite losses and eval metrics, B1 12 launches a step
   and an eval batch, B2 and B3 12 a step; then B1-B3 at its attention
   shape (128 x 197, 12 heads of 64, bidirectional, bf16: the 64-row
   tiles end in a ragged 5-row tail) against their plain versions at
   phase 3's limits, timed beside SDPA and the bound. (16b) the Mixtral
   recipe's ``main`` at Mixtral-8x7B width cut to ``MIXTRAL_LAYERS``
   layers (3.17 B parameters), 4 x 2048, capacity 1.25, remat, the
   chunked loss with the load loss: finite losses, B1-B3 2/1/1 a layer
   and step; then its checkpoint round trip at ``MIXTRAL_CKPT_LAYERS``
   layer(s): every parameter, both moments and the step restored to the
   bit. (16c) Mixtral-8x7B width at ``MIXTRAL_SERVE_LAYERS`` layers,
   seeded bf16, drop-free: the paged engine at phase 4's request mix (B4
   launches ticks x layers) and ``generate`` 8 x 256 + 32, at least
   ``MIXTRAL_GREEDY_SHARE`` of their greedy tokens within
   ``GREEDY_MARGIN`` of a teacher-forced forward (the routing flips at
   bf16 near-ties), which launches B1 once a layer. (16d) one
   ``MoEMLP`` at Mixtral's widths in f32 on the card against itself on
   the CPU, drop-free and at capacity 1.25: the kept pairs and slots
   equal, the outputs within ``MOE_CHECK_RTOL``. Paths ``vit_recipe``,
   ``mixtral_train``, ``mixtral_serve`` (B4), ``mixtral_forward`` (B1),
   ``moe_layer`` (none).
17. T5, after phase 16: (17a) T5-base at its published widths (d_model
   768, 12 + 12 layers, 12 heads of 64, vocab 32128, relu, tied; seeded,
   dropout off, f32 weights and bf16 products) through the Trainer with
   ``seq2seq_lm_loss_fn`` and the recipe's clip + AdamW, ``T5_STEPS``
   steps of 16 x 512 encoder tokens (seeded real lengths 256-512) and
   128 labels: finite falling losses, B1, B2 and B3 12 launches a step
   (each decoder layer's cross-attention; the self-attention carries the
   relative bias and runs on the einsum path), B4 none. (17b) B1-B3 at
   T5-base's cross-attention shape (16 x 128 queries over 512 keys,
   key-padded, 12 heads of 64, scale 1.0, bf16) against their plain
   versions at phase 3's limits, timed beside SDPA and the bound. (17c)
   ``generate_encdec`` over 16 padded 512-token inputs, 64 greedy tokens
   (no kernel: every decode call is one query), at least
   ``T5_GREEDY_SHARE`` of them within ``T5_GREEDY_MARGIN`` logit spreads
   of a teacher-forced forward (B1 once a decoder layer). (17d) the
   port's ``recipes/t5_seq2seq.py`` through its ``main`` at
   ``T5_RECIPE``: exact-match at or above ``T5_RECIPE_BAR``, token-match
   at or above ``T5_TOKEN_BAR`` and the loss below half its first; then
   ``--size small --steps-per-epoch 3 --ckpt-dir`` and a run that
   restores it and trains steps 4-6. (17e)
   T5-base's HF layout: export then load bitwise, and card vs CPU logits
   in f32 within ``T5_HF_FLOORS`` times the CPU model's own one-ulp
   noise floor, which must stay under ``T5_HF_FLOOR_CAP`` of the largest
   logit. Paths ``t5_train``, ``t5_generate`` (none),
   ``t5_forced``, ``t5_recipe``, ``t5_recipe_small``,
   ``t5_recipe_small_resumed`` (B1-B3), ``t5_hf`` (B1).

18. pipeline parallelism, after phase 17: (18a) the host 1F1B executor
   (``HostPipelineStep``) at GPT-2-medium's full width and depth,
   seeded, ``Policy.train()``, SGD(``PP_LR``) on one repeated batch of
   4 microbatches of 2 x 1024: solo (``num_stages=1``) here, then two
   stage processes of 12 + 12 layers on the one card, linked over a gloo
   stage link (host hand-offs), ``PP_STEPS`` steps: the losses fall and
   lie within ``PP_LOSS_RTOL`` of solo's, the merged stage parameters
   within ``PP_PARAM_RTOL`` of solo's (the stages' tensors come back as
   shared CUDA tensors), the last stage's ``head_wte`` equal to stage 0's
   ``wte``; a control without the tied gradient's exchange must read
   beyond ``PP_PARAM_RTOL``. Each process counts its own launches: solo
   24 x 4 of B1-B3 a step, stage 0 2 x 12 x 4 of B1 (its backward
   recomputes the forward) and 12 x 4 of B2 and B3, stage 1 12 x 4 of
   each. (18b) ``pipelined_causal_lm_loss_fn`` under ``PipelineParallel``
   at one stage through the Trainer in a NCCL world of one, GPT-2-medium,
   clip + AdamW(3e-4), 4 microbatches of 2 x 1024, ``PP_STEPS`` steps:
   losses within ``GPIPE_LOSS_RTOL`` of ``causal_lm_loss_fn``'s on the
   same weights and batches, B1-B3 24 x 4 a step. Paths
   ``pp_host_solo``, ``pp_host_stage0``, ``pp_host_stage1``,
   ``pp_gpipe_one_stage`` (B1-B3; B4 0 on each). The GPipe form over
   more than one stage needs a card a stage: ``scripts/port_pp_scale.py``.
19. tensor parallelism, after phase 18: (19a) B4 at Llama-3-8B's
   per-rank decode ticks at tp 2, 4 and 8 (16/4, 8/2, 4/1 heads of 128,
   8 rows, 36 pages of 32) against ``stream`` and ``gather``, and B1-B3
   at GPT-2-medium's per-rank shape at tp 2 (8 x 1024, 8 heads of 64,
   causal, bf16) against their plain versions, each timed beside its
   bound and SDPA. The tp paths run on four cards
   (``scripts/port_tp_scale.py``): two gloo ranks on one card crash in
   DTensor's functional all-gather of CUDA tensors, and NCCL takes one
   rank a card.

Serve, ResNet, 7a, train, 8a, 9, each path of 10, 11, 12, 13, 14, 15,
16, 17 and 18 set all four kernel counts to 0 just before their run and
read all four just after; a kernel off the path that launched fails the
run.

Output: a ``details`` JSON line (every check and serve number), a
``kernels`` JSON line (each kernel's ``launches`` summed over the paths,
``launches_by_path`` per path as read, for the flash kernels their
numbers ``at_llama_shape``, ``at_bert_shape``, ``at_family_shapes``
per dtype, ``at_sp_tp_shapes``, ``at_vit_shape``, ``at_t5_shape`` and
``at_tp_shapes``, for the paged kernel ``at_gpt2_shape`` at W=1 and W=5,
``at_family_shapes`` and ``at_tp_shapes``), then the
card's name and power
limit as ``nvidia-smi`` prints them, then the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import sys
import time

# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 (and fp16)
# tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12   # f32 outside the tensor cores

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
_HEAD_DIMS = (16, 32, 64, 96, 128, 256)
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
_PAGED_HEAD_DIMS = (64, 96, 128, 256)


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


def gpt2_paged_cases(shape):
    """The paged checks at GPT-2-small's shape (12 heads of 64, one query
    head per kv head): the decode tick, the speculative verify (W = k +
    1 = 5), a one-page bucket, and W = 5 rows whose next split starts
    just past lengths[b]."""
    from pytorch_distributed_tpu_torch.ops.paged_attention import (
        pages_per_split,
    )

    B, n, ps = shape["B"], shape["n"], shape["ps"]
    split_keys = pages_per_split(B, shape["Hkv"], n) * ps
    return (
        ("decode W=1", 1, None, n, None),
        ("verify W=5", 5, None, n, None),
        ("bucket n=1", 1, None, 1, None),
        ("split sentinel W=5", 5, None, n,
         [split_keys * (i % (n * ps // split_keys - 1) + 1) - 1
          for i in range(B)]),
    )


def _paged_checks(gen, shape, cases, device, label=""):
    """Every case in bf16 and f32 against ``stream`` and ``gather``, and
    bitwise equal over two launches. Returns (checks, deterministic,
    {case name: bf16 inputs})."""
    import torch

    from pytorch_distributed_tpu_torch.ops.paged_attention import (
        paged_attention,
    )

    checks, same, inputs = [], {}, {}
    for dtype, rtol in ((torch.bfloat16, BF16_RTOL), (torch.float32,
                                                       F32_RTOL)):
        dname = str(dtype).replace("torch.", "")
        for name, W, window, n, lengths in cases:
            max_len = min(shape["max_len"], n * shape["ps"] - W)
            q, kp, vp, tables, lengths = _paged_case(
                gen, dtype=dtype, device=device,
                **dict(shape, n=n, max_len=max_len), W=W, lengths=lengths,
            )
            args = dict(page_tables=tables, lengths=lengths, window=window)
            out = paged_attention(q, kp, vp, **args)
            # two launches on the same inputs give the same bits
            same[f"{label}{name} {dname}"] = torch.equal(
                out, paged_attention(q, kp, vp, **args))
            out = out.float()
            torch.cuda.synchronize()
            for impl in ("stream", "gather"):
                ref = paged_attention(q, kp, vp, impl=impl, **args).float()
                err = (out - ref).abs().max().item()
                scale = ref.abs().max().item()
                ok = math.isfinite(err) and err <= rtol * scale
                checks.append(dict(
                    case=label + name, dtype=dname, plain=impl,
                    max_abs_err=err, max_abs_ref=scale, tol=rtol * scale,
                    ok=ok,
                ))
                print(f"kernel {label}{name} {dname} vs {impl}: max|err| "
                      f"{err:.3e} <= {rtol:g} * max|ref| {scale:.4f} -> "
                      f"{'ok' if ok else 'FAIL'}")
            if dtype is torch.bfloat16:
                inputs[name] = (q, kp, vp, tables, lengths)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    print(f"paged kernel {label}bitwise equal over two launches: "
          f"{all(same.values())}")
    if not all(same.values()):
        raise AssertionError(f"the paged kernel is not deterministic: {same}")
    return checks, same, inputs


def _paged_times(q, kp, vp, tables, lengths, device):
    """The kernel's time at these inputs (replayed from a CUDA graph,
    eager beside), its plain ``stream`` version's, SDPA's over the same
    K/V gathered dense, and the bound: max(bytes once / HBM rate, live
    pairs' flops / bf16 peak)."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_tpu_torch.ops.paged_attention import (
        gather_dense,
        paged_attention,
    )

    B, W, Hq, D = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    n = tables.shape[1]
    args = dict(page_tables=tables, lengths=lengths)
    # the kernel's device time, replayed from a CUDA graph as the library
    # call is; eager calls add the ctypes launches and the wrapper's checks
    kernel_ms = _graph_ms(lambda: paged_attention(q, kp, vp, **args), 200)
    eager_ms = _time_ms(lambda: paged_attention(q, kp, vp, **args), 200)
    plain_ms = _time_ms(
        lambda: paged_attention(q, kp, vp, impl="stream", **args), 5
    )
    # the library yardstick: SDPA over the same K/V gathered dense, with
    # the ragged lengths as a boolean mask (query j sees keys <= length +
    # j). Its default (cuDNN) backend lets the null page's large garbage
    # through the mask, so the pages it reads are gathered with a zeroed
    # null page.
    kp0, vp0 = kp.clone(), vp.clone()
    kp0[0], vp0[0] = 0, 0
    kd = gather_dense(kp0, tables).transpose(1, 2)         # [B, Hkv, T, D]
    vd = gather_dense(vp0, tables).transpose(1, 2)
    qd = q.transpose(1, 2)                                 # [B, Hq, W, D]
    kpos = torch.arange(n * ps, device=device)
    qpos = lengths[:, None].long() + torch.arange(W, device=device)
    mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
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
    # QK^T and PV over each query's visible keys
    pairs = sum(min(L + j + 1, n * ps) for L in lengths.tolist()
                for j in range(W))
    flops = pairs * Hq * D * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    out = dict(
        ms=kernel_ms, eager_ms=eager_ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms, bytes=nbytes, flops=flops, live_keys=live,
        sdpa_max_abs_diff=lib_err,
        sdpa_max_abs_diff_null_page_garbage=garbage_err,
    )
    print(f"kernel B={B} W={W} Hq={Hq} Hkv={Hkv} D={D} n={n}: "
          f"{kernel_ms:.4f} ms (graph replay; eager {eager_ms:.4f} ms; "
          f"{nbytes / kernel_ms / 1e6:.0f} GB/s), plain (stream) "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (max|diff| vs "
          f"kernel {lib_err:.3e}; {garbage_err:.3e} with the null page's "
          f"garbage left in), bound {out['bound_ms']:.4f} ms ({nbytes} "
          f"bytes, {flops} flops)")
    return out


# GPT-2-small's paged attention (phase 11's model): 12 heads of 64, one
# query head per kv head, 32-token pages, 32 pages (1024 positions)
_GPT2_PAGED_SHAPE = dict(B=8, Hq=12, Hkv=12, D=64, ps=32, n=32, max_len=1000)


def kernel_phase(device, seed):
    import torch

    from pytorch_distributed_tpu_torch.ops.paged_attention import (
        pages_per_split,
    )

    gen = torch.Generator().manual_seed(seed)
    shape = dict(B=8, Hq=32, Hkv=8, D=128, ps=32, n=64, max_len=2000)
    checks, same, inputs = _paged_checks(gen, shape, paged_cases(shape),
                                         device)
    # time at the decode tick's shapes (bf16, W=1)
    q, kp, vp, tables, lengths = inputs["decode W=1"]
    B, W, Hq, D = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    n = tables.shape[1]
    pps = pages_per_split(B, Hkv, n)
    ctas = Hkv * -(-(Hq // Hkv * W) // 16) * B * -(-n // pps)
    print(f"split: {pps} pages ({pps * ps} keys) per CTA, grid of {ctas} "
          f"CTAs (B x Hkv = {B * Hkv})")
    if ctas <= B * Hkv:
        raise AssertionError(f"the split leaves {ctas} CTAs <= B x Hkv")
    times = _paged_times(q, kp, vp, tables, lengths, device)
    record = dict(
        name="paged_attention", route="cuda",
        source="pytorch_distributed_tpu_torch/csrc/paged_attention.cu",
        replaces="pytorch_distributed_tpu/ops/paged_attention.py:423",
        launches=None,
        max_abs_err=max(c["max_abs_err"] for c in checks
                        if c["case"] == "decode W=1"
                        and c["dtype"] == "bfloat16"),
        **{k: times[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
    )
    details = dict(checks=checks, deterministic=same, pages_per_split=pps,
                   ctas=ctas, **times)

    # GPT-2-small's shape: head_dim 64 and G = 1 (16-row m-tiles with W
    # of them real), the decode tick and the speculative verify
    g = _GPT2_PAGED_SHAPE
    gchecks, gsame, ginputs = _paged_checks(
        gen, g, gpt2_paged_cases(g), device, label="gpt2 ")
    at_gpt2 = {}
    for name in ("decode W=1", "verify W=5"):
        t = _paged_times(*ginputs[name], device)
        at_gpt2[name] = dict(
            max_abs_err=max(c["max_abs_err"] for c in gchecks
                            if c["case"] == "gpt2 " + name
                            and c["dtype"] == "bfloat16"),
            **{k: t[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")})
        details[f"gpt2 {name}"] = t
    record["at_gpt2_shape"] = at_gpt2
    details.update(gpt2_checks=gchecks, gpt2_deterministic=gsame)
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


def _flash_check(gen, seed, name, shape, causal, extras, dname, device):
    """The forward, dq and dkv kernels against their plain versions on
    one case (the backward ones fed the same dO, lse and delta): a row
    per tensor with its max and norm-relative errors and limits."""
    import torch

    from pytorch_distributed_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dname)
    tol = FLASH_TOL[dname]
    q, k, v, bias, seg = _flash_inputs(gen, seed, shape, dtype, device,
                                       extras)
    kw = dict(sm_scale=extras.get("sm_scale", shape["D"] ** -0.5),
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
    rows = []
    for what, got, want, lim in pairs:
        want = want.float()
        diff = got.float() - want
        err = diff.abs().max().item()
        scale = want.abs().max().item()
        norm = (diff.norm() / want.norm()).item()
        ok = (math.isfinite(err) and err <= lim["max"] * scale
              and norm <= lim["norm"])
        rows.append(dict(case=name, dtype=dname, what=what,
                         max_abs_err=err, max_abs_ref=scale,
                         tol=lim["max"] * scale, norm_rel_err=norm,
                         norm_tol=lim["norm"], ok=ok))
        print(f"flash {name} {dname} {what}: max|err| {err:.3e} <= "
              f"{lim['max']:g} * max|ref| {scale:.4f}, norm "
              f"{norm:.3e} <= {lim['norm']:g} -> "
              f"{'ok' if ok else 'FAIL'}")
    return rows


def flash_phase(device, seed):
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from pytorch_distributed_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(seed + 1)
    checks = []
    worst = {}
    for dname in FLASH_DTYPES:
        for name, shape, causal, extras in FLASH_CASES:
            rows = _flash_check(gen, seed, name, shape, causal, extras,
                                dname, device)
            checks += rows
            worst.setdefault(dname, {})[name] = {
                r["what"]: r["max_abs_err"] for r in rows}
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
                 causal=True, extras=None, sm_scale=None):
    """The three kernels at ``shape`` (bf16 and causal unless given;
    ``extras`` as ``_flash_inputs`` takes them: a padding mask): bitwise
    equal over two launches, then each one's time replayed from a CUDA
    graph beside its eager time, its plain version's, its bound and
    ``scaled_dot_product_attention``'s. Without a mask the yardstick is
    SDPA's flash backend (K/V expanded to the query heads outside the
    timed region when the shape has GQA: that backend takes equal head
    counts; the memory-efficient backend where the flash one refuses the
    head dim); with one it is the memory-efficient backend, the one that
    takes an additive bias, given the mask as a ``[B, H, S, T]`` bias in
    the input dtype (made outside the timed region). ``sm_scale`` is the
    softmax scale (``D ** -0.5`` unless given)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from pytorch_distributed_tpu_torch.ops import flash_attention as fa

    dtype = dtype or torch.bfloat16
    B, S, T, Hq, Hkv, D = (shape[k] for k in ("B", "S", "T", "Hq", "Hkv",
                                              "D"))
    q, k, v, bias, seg = _flash_inputs(gen, seed, shape, dtype, device,
                                       extras or {})
    kw = dict(sm_scale=D ** -0.5 if sm_scale is None else sm_scale,
              causal=causal)
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
    backend = "flash" if bias is None else "efficient"
    if backend == "flash":
        try:
            lib = aten._scaled_dot_product_flash_attention(
                qt, kt, vt, 0.0, causal, False, scale=scale)
        except RuntimeError as e:   # a head dim the backend lacks
            print(f"sdpa's flash backend refuses {shape}: {e}; timing its "
                  "memory-efficient one")
            backend = "efficient"
    if backend == "flash":
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
        abias = None if bias is None else bias.to(dtype)[
            :, None, None, :].expand(B, Hq, S, T).contiguous()
        lo, llse, seed_t, offset_t = (
            aten._scaled_dot_product_efficient_attention(
                qt, kt, vt, abias, True, 0.0, causal, scale=scale))

        def sdpa_fwd():
            return aten._scaled_dot_product_efficient_attention(
                qt, kt, vt, abias, False, 0.0, causal, scale=scale)[0]

        def sdpa_bwd():
            return aten._scaled_dot_product_efficient_attention_backward(
                gout, qt, kt, vt, abias, lo, llse, seed_t, offset_t, 0.0,
                [True, True, True, False], causal, scale=scale)

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
# phase 11: GPT-2-small through the rest of the serving stack
# --------------------------------------------------------------------------

# bench_serving's shape (bench.py:745): 8 slots, 32 requests of 64-token
# prompts, 64 new tokens. max_len 128 in 32-token pages keeps every
# decode tick in one length bucket (4 pages): lengths 64-127.
GPT2_SERVE = dict(slots=8, requests=32, prompt=64, new=64, max_len=128,
                  chunk=64)
GPT2_SPEC_K = 4
# 11d: a 64-token system prompt shared by every request (2 full pages),
# a 16-token tail of its own (sub-page: the prefix's 2 pages are all a
# request can publish), 48 new tokens: lengths 80-127, one bucket again.
# The 64-token chunk is the prefix itself, so a request computes its
# prefix and tail in the same chunks whether it shares the prefix or not.
GPT2_FLEET = dict(prefix=64, tail=16, new=48, loss_after=40)
# 11b: an int8 pool's bytes over the f32 pool of the same geometry:
# (1 + 4/64) / 4 = 0.266 at GPT-2's head_dim (bench_disagg's 0.55 limit)
KV8_POOL_RATIO = 0.55


def _gpt2_small(device, seed, **kw):
    """GPT-2-small at full width and depth, bf16 serving policy, seeded
    weights, frozen."""
    import torch

    from pytorch_distributed_tpu_torch import GPT2Config, GPT2LMHead

    cfg = dataclasses.replace(GPT2Config.small(), dropout_rate=0.0, **kw)
    model = GPT2LMHead(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model.requires_grad_(False)


def _gpt2_serve_requests(seed, vocab):
    import numpy as np

    from pytorch_distributed_tpu_torch.serve import Request

    rng = np.random.default_rng(seed)
    c = GPT2_SERVE
    return [Request(rng.integers(1, vocab, size=c["prompt"]), c["new"],
                    request_id=f"g{i}") for i in range(c["requests"])]


def _gpt2_fleet_requests(seed, vocab):
    """32 requests opening with one shared 64-token prompt, half of them
    sampled (T 0.8, top_p 0.95)."""
    import numpy as np

    from pytorch_distributed_tpu_torch.serve import Request

    rng = np.random.default_rng(seed + 1)
    f = GPT2_FLEET
    shared = rng.integers(1, vocab, size=f["prefix"])
    return [
        Request(np.concatenate([shared,
                                rng.integers(1, vocab, size=f["tail"])]),
                f["new"], temperature=0.8 if i % 2 else 0.0,
                top_p=0.95 if i % 2 else None, seed=300 + i,
                request_id=f"f{i}")
        for i in range(GPT2_SERVE["requests"])
    ]


def _serve_part(name, server, reqs, on, tick_span="serve.decode_tick"):
    """One part of phase 11: warm ``server`` (an engine or a router) up,
    set the four kernel counts to 0, serve ``reqs`` submitted at once,
    read the counts (fail on an off-path launch) and check every request
    finished with its full token count. Returns (streams, counts,
    stats)."""
    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch.runtime import tracing
    from pytorch_distributed_tpu_torch.serve import RequestStatus, warm_up

    if hasattr(server, "warm_up"):
        server.warm_up(np.ones(1, np.int32))
    else:
        warm_up(server, np.ones(1, np.int32))
    torch.cuda.synchronize()
    spec = [getattr(server, k, 0) for k in
            ("spec_verifies", "spec_drafted", "spec_accepted")]
    kernel_counts(reset=True)
    with tracing.enabled() as tracer:
        t0 = time.perf_counter()
        handles = [server.submit(r) for r in reqs]
        server.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernel_counts()
    off_path(counts, on)
    for r, h in zip(reqs, handles):
        if h.status is not RequestStatus.COMPLETED or len(h.tokens) != (
            r.max_new_tokens
        ):
            raise AssertionError(f"{name} {r.request_id}: {h.status} with "
                                 f"{len(h.tokens)} of {r.max_new_tokens}")
    summary = (server.summary() if hasattr(server, "warm_up")
               else server.telemetry.summary())
    roll = tracer.rollups()
    tokens = sum(len(h.tokens) for h in handles)
    stats = dict(
        wall_s=wall, tokens_per_s=tokens / wall, completed_tokens=tokens,
        ttft_ms_p50=summary["ttft_ms_p50"], ttft_ms_p99=summary["ttft_ms_p99"],
        decode_tick_ms=sum(roll[k]["mean_ms"]
                           for k in (tick_span, "serve.token_fetch")),
        decode_tick_ms_p50=sum(roll[k]["p50_ms"]
                               for k in (tick_span, "serve.token_fetch")),
        ticks=roll[tick_span]["count"],
        prefill_chunk_ms=roll["serve.prefill_chunk"]["mean_ms"],
        launches=counts,
    )
    if getattr(server, "spec", None) is not None:
        # this run's counters, the warm-up's left out
        stats.update(zip(("spec_verifies", "spec_drafted", "spec_accepted"),
                         (getattr(server, k) - v for k, v in zip(
                             ("spec_verifies", "spec_drafted",
                              "spec_accepted"), spec))))
    print(f"11 {name}: {tokens} tokens in {wall:.3f} s, "
          f"{stats['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{stats['ttft_ms_p50']:.2f} ms p99 {stats['ttft_ms_p99']:.2f} ms, "
          f"decode tick {stats['decode_tick_ms']:.3f} ms (p50 "
          f"{stats['decode_tick_ms_p50']:.3f}) over {stats['ticks']} ticks, "
          f"launches {counts}")
    return [list(h.tokens) for h in handles], counts, stats


def _forced_worst(model, reqs, streams, device, forward):
    """(exact, worst gap): for every greedy token, ``forward``'s
    teacher-forced max logit minus the chosen token's logit."""
    import torch

    gaps, exact = [], 0
    with torch.no_grad():
        for r, toks in zip(reqs, streams):
            if r.temperature > 0:
                continue
            seq = torch.tensor(list(r.prompt_ids) + toks,
                               device=device)[None].long()
            logits = forward(seq)[0, r.prompt_len - 1:-1].float()
            if not torch.isfinite(logits).all():
                raise AssertionError(f"{r.request_id}: non-finite logits")
            t = torch.tensor(toks, device=device)
            mine = logits.gather(1, t[:, None])[:, 0]
            gaps.extend((logits.max(dim=-1).values - mine).tolist())
            exact += int((logits.argmax(dim=-1) == t).sum())
    return exact, len(gaps), max(gaps)


def _margin(what, exact, n, worst):
    print(f"11 {what} vs teacher-forced: {exact}/{n} exact argmax, worst "
          f"logit gap {worst:.4f} (margin {GREEDY_MARGIN})")
    if worst > GREEDY_MARGIN:
        raise AssertionError(f"{what}: a greedy token sits {worst:.4f} below "
                             f"the teacher-forced argmax")
    return dict(greedy_exact=exact, greedy_tokens=n, greedy_worst_gap=worst)


def _same_streams(what, got, want, reqs):
    diff = [r.request_id for r, a, b in zip(reqs, got, want) if a != b]
    print(f"11 {what}: {len(reqs) - len(diff)}/{len(reqs)} streams equal")
    if diff:
        raise AssertionError(f"{what}: streams differ for {diff}")


def _forks(model, reqs, got, want, device):
    """Where two greedy streams of one model part: for each stream pair
    that differs, the first position j and the gap between the two
    tokens chosen there, in a teacher-forced forward of the shared
    prefix (einsum attention). Both tokens within ``GREEDY_MARGIN`` is
    a near-tie that bf16 rounding (other GEMM shapes, another split of
    the keys) may break either way; a wider gap is a wrong token."""
    import torch

    out = []
    with torch.no_grad():
        for r, a, b in zip(reqs, got, want):
            if a == b:
                continue
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            seq = torch.tensor(list(r.prompt_ids) + b[:j],
                               device=device)[None].long()
            logits = model(seq, attn_impl="xla")[0, -1].float()
            gap = abs(float(logits[a[j]] - logits[b[j]]))
            out.append(dict(request=r.request_id, position=j, gap=gap))
    worst = max((f["gap"] for f in out), default=0.0)
    print(f"11 forks: {len(out)}/{len(reqs)} streams part, widest gap "
          f"between the two tokens {worst:.4f} (margin {GREEDY_MARGIN}): "
          f"{out}")
    if worst > GREEDY_MARGIN:
        raise AssertionError(f"streams part at a gap of {worst:.4f}: {out}")
    return out


def serve_gpt2_phase(device, seed):
    """Phase 11: GPT-2-small at full width through the serving stack:
    (11a) the paged solo engine, with a dense-tick A/B; (11b) int8 pools;
    (11c) speculative decoding (k = 4, the target as its own draft);
    (11d) a 2 + 2 prefill/decode fleet behind the router with a prefix
    store, then the same with one decode engine lost mid-run, both
    against a solo engine's streams. Returns (stats, launches by path).
    """
    import contextlib
    import gc

    import torch

    from pytorch_distributed_tpu_torch.runtime import faults
    from pytorch_distributed_tpu_torch.serve import (
        EngineConfig,
        InProcPrefixStore,
        Router,
        ServeEngine,
        SpecConfig,
        frame_f32_nbytes,
        frame_nbytes,
    )

    t_phase = time.perf_counter()
    model = _gpt2_small(device, seed)
    L = model.config.num_layers
    c = GPT2_SERVE
    ecfg = EngineConfig(num_slots=c["slots"], max_len=c["max_len"],
                        prefill_chunk=c["chunk"], page_size=32)
    reqs = _gpt2_serve_requests(seed, model.config.vocab_size)
    stats, by_path = {}, {}
    plain = lambda seq: model(seq, attn_impl="xla")  # noqa: E731

    # 11a: the paged solo engine, then the dense tick on the same requests
    engine = ServeEngine(model, ecfg, device=device)
    streams_a, by_path["serve_gpt2"], st = _serve_part(
        "11a paged", engine, reqs, on=("paged_attention",))
    if by_path["serve_gpt2"]["paged_attention"] != st["ticks"] * L:
        raise AssertionError(f"11a: {by_path['serve_gpt2']} launches over "
                             f"{st['ticks']} ticks x {L} layers")
    st.update(_margin("11a", *_forced_worst(model, reqs, streams_a, device,
                                            plain)),
              buckets=sorted(engine.decode_buckets))
    stats["11a"] = st
    dense = ServeEngine(model, dataclasses.replace(ecfg, decode_mode="dense"),
                        device=device)
    streams_dense, by_path["serve_gpt2_dense"], st = _serve_part(
        "11a dense A/B", dense, reqs, on=())
    st.update(_margin("11a dense", *_forced_worst(
        model, reqs, streams_dense, device, plain)))
    st["streams_equal_paged"] = sum(a == b for a, b in
                                    zip(streams_dense, streams_a))
    stats["11a_dense"] = st
    del engine, dense

    # 11b: int8 pools on the same weights: the gather path, no kernel
    q8 = _gpt2_small(device, seed, kv_cache_quantize="int8")
    q8.load_state_dict(model.state_dict())
    engine = ServeEngine(q8, ecfg, device=device)
    streams_b, by_path["serve_gpt2_int8"], st = _serve_part(
        "11b int8 pools", engine, reqs, on=())
    pool = engine.pool
    f32_bytes = frame_f32_nbytes(pool.cache) * (pool.num_pages + 1)
    ratio = pool.kv_bytes() / f32_bytes
    print(f"11b pool {pool.kv_bytes()} B = {ratio:.4f} x the f32 pool's "
          f"{f32_bytes} B (limit {KV8_POOL_RATIO})")
    if ratio > KV8_POOL_RATIO:
        raise AssertionError(f"11b: int8 pool at {ratio:.4f} x f32")

    def int8_forced(seq):
        T = seq.shape[1]
        pos = torch.arange(T, device=device)[None]
        logits, _ = q8(seq, pos, decode=True, cache_len=T,
                       write_pos=torch.zeros(1, dtype=torch.int32,
                                             device=device))
        return logits

    st.update(_margin("11b", *_forced_worst(q8, reqs, streams_b, device,
                                            int8_forced)),
              pool_bytes=pool.kv_bytes(), f32_pool_bytes=f32_bytes,
              pool_ratio=ratio,
              streams_equal_exact=sum(a == b for a, b in
                                      zip(streams_b, streams_a)))
    stats["11b"] = st
    del engine, q8, pool

    # 11c: speculative decoding, the target as its own draft, k = 4: the
    # verify is the kernel at W = 5, once per layer per tick
    k = GPT2_SPEC_K
    engine = ServeEngine(
        model, dataclasses.replace(ecfg, max_len=c["max_len"] + 32),
        device=device, spec=SpecConfig(model, k))
    streams_c, by_path["serve_gpt2_spec"], st = _serve_part(
        "11c speculative", engine, reqs, on=("paged_attention",),
        tick_span="serve.spec_tick")
    verifies = st["spec_verifies"]
    if by_path["serve_gpt2_spec"]["paged_attention"] != verifies * L:
        raise AssertionError(f"11c: {by_path['serve_gpt2_spec']} launches "
                             f"over {verifies} verify ticks x {L} layers")
    accepted = st["spec_accepted"] / (st["spec_drafted"] // k)
    print(f"11c: {verifies} verify ticks, {st['spec_accepted']} of "
          f"{st['spec_drafted']} drafts accepted, {accepted:.3f} accepted "
          f"tokens per row verify (of {k})")
    st.update(_margin("11c", *_forced_worst(model, reqs, streams_c, device,
                                            plain)),
              accepted_per_row_verify=accepted,
              buckets=sorted(engine.decode_buckets))
    # the verify's [S, k + 1] products and its 5-page bucket round
    # otherwise than 11a's [S, 1] tick in bf16: a stream may part from
    # 11a's at a near-tie, and only there
    st["forks_vs_11a"] = _forks(model, reqs, streams_c, streams_a, device)
    st["streams_equal_11a"] = len(reqs) - len(st["forks_vs_11a"])
    stats["11c"] = st
    del engine

    # 11d: the fleet against a solo engine on the same requests
    f = GPT2_FLEET
    freqs = _gpt2_fleet_requests(seed, model.config.vocab_size)
    solo = ServeEngine(model, ecfg, device=device)
    streams_solo, by_path["serve_gpt2_solo_ref"], st = _serve_part(
        "11d solo reference", solo, freqs,
        on=("paged_attention",))
    stats["11d_solo"] = st
    del solo
    prefix_pages = f["prefix"] // ecfg.page_size

    def fleet(loss):
        store = InProcPrefixStore()
        pre = [ServeEngine(model, dataclasses.replace(
            ecfg, role="prefill", engine_id=f"p{i}"), device=device,
            prefix_store=store)
            for i in range(2)]
        dec = [ServeEngine(model, dataclasses.replace(
            ecfg, role="decode", engine_id=f"d{i}"), device=device)
            for i in range(2)]
        router = Router(prefill=pre, decode=dec, store=store)
        what = "11d fleet, d1 lost" if loss else "11d fleet 2+2"
        arm = (f"serve.engine_loss:mode=raise,match=d1,after="
               f"{f['loss_after']}") if loss else None
        with faults.injected(arm) if arm else contextlib.nullcontext():
            streams, counts, st = _serve_part(
                what, router, freqs, on=("paged_attention",))
        ticks = st["ticks"]   # the decode tier's, the lost engine's included
        if counts["paged_attention"] != ticks * L:
            raise AssertionError(f"{what}: {counts} launches over {ticks} "
                                 f"decode-tier ticks x {L} layers")
        puts = store.stats()["puts"]
        # every prompt spans the same pages; a replayed request migrates
        # again
        pages = router.migration_frames * -(-freqs[0].prompt_len
                                             // ecfg.page_size)
        want = pages * frame_nbytes(pre[0].pool.cache)
        print(f"{what}: store puts {puts} (prefix pages {prefix_pages}), "
              f"{router.migration_frames} frames, payload "
              f"{router.migration_payload_bytes} B (= {pages} pages x "
              f"frame_nbytes: {want}), wire {router.migration_bytes} B, "
              f"replays {router.replays}, lost {router.lost_engines}")
        if puts != prefix_pages:
            raise AssertionError(f"{what}: {puts} store puts, want "
                                 f"{prefix_pages} (once per fleet)")
        if router.migration_payload_bytes != want:
            raise AssertionError(f"{what}: payload "
                                 f"{router.migration_payload_bytes} != {want}")
        if not loss and router.migration_frames != len(freqs):
            raise AssertionError(f"{what}: {router.migration_frames} "
                                 f"frames for {len(freqs)} requests")
        if loss and (router.lost_engines != ["d1"] or router.replays < 1):
            raise AssertionError(f"{what}: lost {router.lost_engines}, "
                                 f"replays {router.replays}")
        _same_streams(f"{what} vs solo", streams, streams_solo, freqs)
        st.update(store=store.stats(), frames=router.migration_frames,
                  payload_bytes=router.migration_payload_bytes,
                  wire_bytes=router.migration_bytes, replays=router.replays,
                  lost=list(router.lost_engines), decode_ticks=ticks,
                  adopted_pages=sum(e.store_adopted_pages for e in pre))
        return counts, st

    by_path["serve_gpt2_fleet"], stats["11d"] = fleet(False)
    by_path["serve_gpt2_fleet_loss"], stats["11d_loss"] = fleet(True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    stats["wall_s"] = time.perf_counter() - t_phase
    stats["launches"] = by_path
    print(f"phase 11: {stats['wall_s']:.1f} s; launches by path {by_path}")
    return stats, by_path


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

# (a) and (b) at GPT-2-medium's width and 12 of its 24 layers (24 up to
# the pipeline slice, whose phase 18 took the time): half the blocks of
# each 4.3 GB checkpoint and of each step
ZERO_LAYERS = 12
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
    """GPT-2-medium (at ``ZERO_LAYERS`` layers) under ``Policy.train()``
    as the recipe builds it with ``--strategy zero1 --remat --vocab-chunk
    8192``: ZeRO-1 (DDP, the AdamW state sharded), clip(1.0) then
    adamw(3e-4, decay 1e-4), batch 8 x 1024 in 2 microbatches, a
    checkpoint every 3 steps. The data follows ``seed``, the weights
    ``init_seed`` (``seed`` unless given)."""
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

    cfg = dc.replace(GPT2Config.medium(), remat=remat,
                     num_layers=ZERO_LAYERS)
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

LLAMA_LAYERS = 2        # of 32: the 8B AdamW state (128.5 GB) exceeds a card
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


def _llama_trainer(device, seed, ckpt_dir, *, init_seed=None,
                   optimizer="adamw", lr=1e-4, log_mfu=False, rows=None,
                   epochs=1, steps=None):
    """Llama-3-8B at full width and ``LLAMA_LAYERS`` layers as the recipe
    builds it with ``--strategy fsdp --remat --vocab-chunk 8192``:
    ``Policy.train()``, FSDP full-shard at world 1 (made on the meta
    device, each rank drawing its own rows), clip(1.0) then adamw(1e-4,
    decay 1e-4) (``optimizer="adafactor"``: the recipe's Adafactor(lr)
    alone), batch 8 x 2048 in one microbatch, checkpoints every
    ``LLAMA_CKPT_AT`` steps into ``ckpt_dir``. The data follows ``seed``
    (``rows`` rows, ``steps`` a epoch, ``epochs`` of them), the weights
    ``init_seed`` (``seed`` unless given)."""
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
        build_optimizer,
    )

    cfg = dc.replace(LlamaConfig.llama3_8b(), num_layers=LLAMA_LAYERS,
                     remat=True)
    policy = Policy.train()
    strategy = FSDP(device, MeshSpec(dp=1, fsdp=-1))
    model, net = build_model(cfg, strategy, device,
                             seed if init_seed is None else init_seed, policy)
    if optimizer == "adafactor":
        opt = build_optimizer("adafactor", model, strategy, lr)
    else:
        opt = optim.clip_grad_norm(strategy.optimizer(
            model, optim.AdamW, lr=lr, weight_decay=ADAMW_WEIGHT_DECAY), 1.0)
    steps = steps or LLAMA_STEPS
    ds = SyntheticTextDataset(n=rows or steps * LLAMA_BATCH,
                              seq_len=LLAMA_SEQ, vocab_size=cfg.vocab_size,
                              seed=seed)
    trainer = Trainer(
        TrainState(net, opt, policy=policy),
        build_train_step(causal_lm_loss_fn(net,
                                           vocab_chunk_size=LLAMA_CHUNK)),
        DataLoader(ds, LLAMA_BATCH, seed=seed,
                   sharding=strategy.batch_sharding()),
        config=TrainerConfig(epochs=epochs, log_every=1,
                             max_steps_per_epoch=steps, ckpt_dir=ckpt_dir,
                             ckpt_every_steps=(LLAMA_CKPT_AT if epochs == 1
                                               else None),
                             log_mfu=log_mfu))
    return model, trainer


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _llama_snapshot(model, trainer):
    """Host copies of this rank's rows of every parameter and of every
    optimizer state tensor (AdamW's moments; Adafactor's ``v``, its
    leaves' ``v_row``/``v_col`` and every ``step``), the step and the
    cursor."""
    from pytorch_distributed_tpu_torch.interop import unwrap_optimizer

    _, local, _ = unwrap_optimizer(trainer.state.optimizer)
    adam = not hasattr(local, "leaves")
    out = {}
    for n, p in model.named_parameters():
        out[n] = _local(p).detach().to("cpu", copy=True)
        for k, v in local.state.get(p, {}).items():
            if not (adam and k == "step"):
                out[f"{n}.{k}"] = _local(v).to("cpu", copy=True)
    return dict(tensors=out, step=trainer.state.step,
                cursor=(trainer._cursor_epoch, trainer._cursor_offset))


def _opt_state_bytes(optimizer) -> int:
    """The bytes of this rank's optimizer state: the sum of its state
    tensors' ``nbytes`` (their local shards under FSDP)."""
    import torch

    from pytorch_distributed_tpu_torch.interop import unwrap_optimizer

    _, local, _ = unwrap_optimizer(optimizer)
    return sum(_local(t).nbytes for st in local.state.values()
               for t in st.values() if torch.is_tensor(t))


def llama_phase(device, seed):
    """Phase 8a: the recipe's path on one card, then torch.profiler over
    two steps. (Its checkpoint and restore were cut to keep the smoke in
    its time: the FSDP round trip is held on four cards by
    ``scripts/port_fsdp_scale.py`` and on the CPU by
    ``tests/test_torch_fsdp_ckpt.py``.)"""
    import gc

    import torch

    stats = {}
    with _World1(device):
        model, trainer = _llama_trainer(device, seed, None)
        n_params = sum(p.numel() for p in model.parameters())
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
        state_bytes = _opt_state_bytes(trainer.state.optimizer)
        roll = tracer.rollups()
        losses = [r["loss"] for r in trainer.history]
        step_s = [r["step_time_s"] for r in trainer.history]
        steady = sorted(step_s[1:])
        step_ms = 1e3 * steady[len(steady) // 2]
        tokens = LLAMA_BATCH * LLAMA_SEQ
        L = LLAMA_LAYERS * LLAMA_STEPS
        want = dict(flash_fwd=2 * L, flash_dq=L, flash_dkv=L)
        launches = {k: counts[k] for k in FLASH}
        print(f"(8a) Llama-3-8B width, {LLAMA_LAYERS} of 32 layers, {n_params}"
              f" params, FSDP full-shard at world 1, remat(full), vocab chunk"
              f" {LLAMA_CHUNK}, batch {LLAMA_BATCH} x {LLAMA_SEQ}: "
              f"{LLAMA_STEPS} steps in {wall:.2f} s; step ms "
              + " ".join(f"{1e3 * x:.2f}" for x in step_s)
              + f", median of steps 2-{LLAMA_STEPS} {step_ms:.2f} ms = "
              f"{tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
              f"{peak:.2f} GiB; losses " + " ".join(f"{x:.4f}" for x in losses)
              + f"; launches {counts} (want {want} and no paged kernel); "
              f"AdamW state {state_bytes} bytes")
        if len(losses) != LLAMA_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"Llama losses {losses}")
        if launches != want:
            raise AssertionError(f"flash launches {launches} != {want}")
        off_path(counts, FLASH)
        stats.update(params=n_params, layers=LLAMA_LAYERS, losses=losses,
                     opt_state_bytes=state_bytes,
                     step_ms=[1e3 * x for x in step_s], step_ms_median=step_ms,
                     tokens_per_s=tokens / step_ms * 1e3, peak_mem_gib=peak,
                     launches=counts, wall_s=wall,
                     spans={k: roll[k]["mean_ms"] for k in roll})

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


# -- 12. image-classification training, complete ---------------------------

# (12a) the ResNet-18/CIFAR-10 recipe at its defaults, on full-size pickles
CIFAR_TRAIN, CIFAR_TEST = 50_000, 10_000
CIFAR_STEPS = 50           # --steps-per-epoch, one epoch and its eval
STAGING_BATCHES = 12       # (12a) loader batches held against fresh ones
# (12b) the ResNet-50 recipe with EMA and the writers; its folder path
IMAGE50_BATCH, IMAGE50_STEPS = 64, 10
FOLDER_CLASSES, FOLDER_PER_CLASS = 10, 64   # 640 JPEGs, 2 of them corrupt
# (12c) ZeRO-1 against DDP over the recipe's first steps, cuDNN kept to
# deterministic algorithms so that the two runs' arithmetic is the same:
# at world 1 ZeRO-1 steps every parameter itself, so the losses agree to
# the f32 rounding of identical sums (read bitwise or near it)
ZERO1_RESNET_STEPS = 5
ZERO1_LOSS_RTOL = 1e-6
# (12d) the q8 round trip on the card against the CPU, at ResNet-50's
# largest leaf (2,359,296 = 512 x 512 x 3 x 3) plus a ragged tail
Q8_CHECK_ELEMS = 2_359_296 + 93


def _write_cifar(root, seed):
    """Full-size CIFAR-10 pickles (``cifar-10-batches-py``, 5 x 10,000
    train images and 10,000 test images, uint8, seeded)."""
    import os
    import pickle

    import numpy as np

    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    rng = np.random.default_rng(seed)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in names:
        n = CIFAR_TEST if name == "test_batch" else CIFAR_TRAIN // 5
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f,
                        protocol=4)
    return sum(os.path.getsize(os.path.join(base, n)) for n in names)


def _staging_check(device, root, seed):
    """(12a) the recipe's train feed through the staging ring (pinned
    buffers reused behind each copy's event) against the same pipeline on
    fresh allocations: ``STAGING_BATCHES`` batches, each copy queued
    behind a long matmul, bitwise equal."""
    import torch

    from pytorch_distributed_tpu_torch.data import (
        DataLoader,
        ImageBatchPipeline,
        load_cifar10,
    )
    from pytorch_distributed_tpu_torch.recipes.resnet18_cifar10 import (
        CIFAR_MEAN,
        CIFAR_STD,
    )

    ds = load_cifar10(root, train=True, raw_uint8=True)
    kw = dict(train=True, pad=4, mean=CIFAR_MEAN, std=CIFAR_STD, seed=seed)
    staged = ImageBatchPipeline(32, **kw)
    fresh = ImageBatchPipeline(32, reuse_staging=False, **kw)
    a = DataLoader(ds, 128, seed=seed, sharding=device, fetch=staged)
    b = DataLoader(ds, 128, seed=seed, fetch=fresh)
    big = torch.randn(4096, 4096, device=device)
    held = []
    for i, batch in enumerate(a):
        if i == STAGING_BATCHES:
            break
        held.append(batch)      # on the card, never synchronized here
        big = big @ big         # the next copy queues behind this
        big = big / big.norm()
    torch.cuda.synchronize(device)
    ring = staged.staging_ring
    bad = 0
    for got, want in zip(held, b):
        for k in want:
            if not torch.equal(got[k].cpu(), want[k]):
                bad += 1
    stats = dict(batches=len(held), mismatched_leaves=bad,
                 reused=ring.reused, one_shot=ring.one_shot,
                 waits=ring.waits, depth=ring.depth)
    print(f"(12a) staging ring: {len(held)} batches of 128 through "
          f"{ring.depth} pinned buffers a leaf ({ring.reused} reuses, "
          f"{ring.waits} waits on a copy's event, {ring.one_shot} one-shot "
          f"buffers), each copy queued behind a 4096^3 matmul: "
          f"{bad} leaves differ from fresh allocations (must be 0)")
    if bad or not ring.reused:
        raise AssertionError(f"staging ring check failed: {stats}")
    return stats


def _recipe_stats(trainer, roll, steps, batch, wall):
    """A recipe run's readings from its per-step log: the first step
    (cuDNN's autotuning, the pipeline's first pass) apart from the
    steady steps after it."""
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    evals = trainer.last_eval_metrics
    if trainer.state.step != steps or not all(
            math.isfinite(x) for x in losses + list(evals.values())):
        raise AssertionError(f"recipe ran {trainer.state.step} steps; "
                             f"losses {losses}, eval {evals}")
    times = [r["step_time_s"] for r in hist]   # logged every step
    steady = sorted(times[1:])
    wait = roll.get("train.data_wait", {})
    fetch = roll.get("ingest.fetch", {})
    return dict(images_per_s=(steps - 1) * batch / sum(times[1:]),
                first_step_ms=1e3 * times[0],
                step_ms=1e3 * steady[len(steady) // 2],
                loop_s=sum(times), wall_s=wall,
                data_wait_share=wait.get("total_ms", 0.0)
                / (1e3 * sum(times)),
                data_wait_p50_ms=wait.get("p50_ms"),
                fetch_p50_ms=fetch.get("p50_ms"),
                fetch_mean_ms=fetch.get("mean_ms"),
                fetch_count=fetch.get("count"), losses=losses, eval=evals)


def _cifar_recipe(device, seed, tmp):
    """(12a) ``recipes/resnet18_cifar10.main`` at its defaults on the
    pickles, traced; then the staging-ring check."""
    import torch

    from pytorch_distributed_tpu_torch.recipes import resnet18_cifar10
    from pytorch_distributed_tpu_torch.runtime import tracing

    t0 = time.perf_counter()
    nbytes = _write_cifar(tmp, seed)
    print(f"(12a) CIFAR-10 pickles: {CIFAR_TRAIN} + {CIFAR_TEST} images, "
          f"{nbytes / 1e6:.1f} MB written in {time.perf_counter() - t0:.2f} s")
    kernel_counts(reset=True)
    with tracing.enabled() as tracer:
        t0 = time.perf_counter()
        trainer = resnet18_cifar10.main([
            "--data-dir", tmp, "--epochs", "1", "--steps-per-epoch",
            str(CIFAR_STEPS), "--log-every", "1", "--seed", str(seed)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernel_counts()
    off_path(launches, ())
    dev = next(trainer.state.model.parameters()).device
    if dev.type != device.type or trainer.train_loader.fetch is None:
        raise AssertionError("the CIFAR recipe did not run the native "
                             f"pipeline on the card ({dev})")
    st = _recipe_stats(trainer, tracer.rollups(), CIFAR_STEPS, 128, wall)
    print(f"(12a) resnet18_cifar10 at its defaults (batch 128, ResNet18 "
          f"CIFAR stem, uint8 through ImageBatchPipeline, {CIFAR_STEPS} "
          f"steps + eval): step {st['step_ms']:.2f} ms (median of steps 2-"
          f"{CIFAR_STEPS}; the first {st['first_step_ms']:.0f} ms), "
          f"{st['images_per_s']:.1f} images/s over steps 2-{CIFAR_STEPS}, "
          f"ingest.fetch p50 {st['fetch_p50_ms']:.3f} ms a batch (mean "
          f"{st['fetch_mean_ms']:.3f}, the first pads the set), "
          f"train.data_wait p50 {st['data_wait_p50_ms']:.3f} ms, "
          f"{100 * st['data_wait_share']:.2f}% of the whole loop; "
          f"loss {st['losses'][0]:.4f} -> {st['losses'][-1]:.4f}; eval "
          + " ".join(f"{k}={v:.4f}" for k, v in st["eval"].items())
          + f"; launches {launches}")
    st.update(launches=launches,
              staging=_staging_check(device, tmp, seed))
    # one of its batches, on the card, for the profile at the end
    st["_profile_batch"] = next(iter(trainer.train_loader))
    return st


def _write_folder(root, seed):
    """``FOLDER_CLASSES`` x ``FOLDER_PER_CLASS`` JPEGs of 160-200 x 120-160
    pixels in ``root/train``, a tenth of that in ``root/val``; one train
    JPEG cut in half, one emptied. Returns the damaged paths."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    damaged = []
    for split, per in (("train", FOLDER_PER_CLASS),
                       ("val", FOLDER_PER_CLASS // 10)):
        for c in range(FOLDER_CLASSES):
            d = os.path.join(root, split, f"n{c:03d}")
            os.makedirs(d)
            for i in range(per):
                h, w = int(rng.integers(120, 161)), int(rng.integers(160, 201))
                path = os.path.join(d, f"{i:04d}.jpg")
                Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)
                                ).save(path, quality=85)
                if split == "train" and (c, i) in ((3, 5), (7, 11)):
                    data = open(path, "rb").read()
                    with open(path, "wb") as f:
                        f.write(data[:len(data) // 2] if c == 3 else b"")
                    damaged.append(path)
    return sorted(damaged)


def _image50(device, seed, tmp, by_path):
    """(12b) the ResNet-50 recipe with EMA and both writers on the
    synthetic feed and, where PIL imports, on image folders; (12c) ZeRO-1
    against DDP."""
    import glob
    import os

    import torch

    from pytorch_distributed_tpu_torch.recipes import resnet50_imagenet
    from pytorch_distributed_tpu_torch.runtime import tracing
    from pytorch_distributed_tpu_torch.train import read_metrics
    from pytorch_distributed_tpu_torch.utils.tensorboard import read_records

    base = ["--batch-size", str(IMAGE50_BATCH), "--epochs", "1",
            "--log-every", "1", "--seed", str(seed), "--lr", "0.025"]
    out = {}

    def run(name, extra, steps):
        kernel_counts(reset=True)
        with tracing.enabled() as tracer:
            t0 = time.perf_counter()
            trainer = resnet50_imagenet.main(base + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_path[name] = kernel_counts()
        off_path(by_path[name], ())
        st = _recipe_stats(trainer, tracer.rollups(), steps, IMAGE50_BATCH,
                           wall)
        st["launches"] = by_path[name]
        return trainer, st

    tb, jsonl = os.path.join(tmp, "tb"), os.path.join(tmp, "m.jsonl")
    trainer, st = run("resnet50_ema", [
        "--steps-per-epoch", str(IMAGE50_STEPS), "--ema-decay", "0.999",
        "--tensorboard-dir", tb, "--metrics-path", jsonl], IMAGE50_STEPS)
    recs = read_metrics(jsonl, strict=True)
    (events,) = glob.glob(os.path.join(tb, "events.out.tfevents.*"))
    records = read_records(events)      # raises on a CRC that fails
    splits = [r["split"] for r in recs]
    want = (splits.count("train") == IMAGE50_STEPS
            and splits.count("eval") == 1
            and len(records) == 1 + IMAGE50_STEPS + 1
            and trainer.state.ema_params is not None
            and trainer.config.eval_with_ema)
    print(f"(12b) resnet50_imagenet --ema-decay 0.999 --tensorboard-dir "
          f"--metrics-path, batch {IMAGE50_BATCH} x 224^2, synthetic uint8: "
          f"step {st['step_ms']:.2f} ms (the first {st['first_step_ms']:.0f}"
          f"), {st['images_per_s']:.1f} images/s over steps 2-"
          f"{IMAGE50_STEPS}; JSONL {len(recs)} records ({splits.count('train')} train, "
          f"{splits.count('eval')} eval, {splits.count('trace')} trace), "
          f"event file {len(records)} records, every CRC checked; eval on "
          f"the shadow " + " ".join(
              f"{k}={v:.4f}" for k, v in st["eval"].items()))
    if not want:
        raise AssertionError(f"the writers' files do not read back: "
                             f"{splits} / {len(records)} events")
    out["ema_writers"] = dict(st, jsonl_records=len(recs),
                              event_records=len(records))
    del trainer
    try:
        import PIL  # noqa: F401 - the folder path decodes with PIL
    except ImportError as e:
        print(f"(12b) --data-dir not run on the card: PIL does not import "
              f"here ({e}); the folder decode is held on the CPU by "
              f"tests/test_torch_image_folder.py")
        out["folders"] = dict(run=False, reason=f"PIL: {e}")
    else:
        root = os.path.join(tmp, "imagenet")
        t0 = time.perf_counter()
        damaged = _write_folder(root, seed)
        write_s = time.perf_counter() - t0
        steps = FOLDER_CLASSES * FOLDER_PER_CLASS // IMAGE50_BATCH
        trainer, fst = run("resnet50_folders", [
            "--data-dir", root, "--bad-sample-budget", "4"], steps)
        q = trainer.train_loader.fetch.quarantine
        print(f"(12b) resnet50_imagenet --data-dir: "
              f"{FOLDER_CLASSES * FOLDER_PER_CLASS} JPEGs in "
              f"{FOLDER_CLASSES} classes (written in {write_s:.1f} s), "
              f"PIL decode + random-resized crop on the host: step "
              f"{fst['step_ms']:.2f} ms, {fst['images_per_s']:.1f} images/s "
              f"(synthetic feed above: {st['images_per_s']:.1f}), ingest."
              f"fetch p50 {fst['fetch_p50_ms']:.1f} ms a batch, "
              f"train.data_wait p50 {fst['data_wait_p50_ms']:.1f} ms, "
              f"{100 * fst['data_wait_share']:.1f}% of the loop; quarantined "
              f"{len(q)} ({', '.join(os.path.basename(p) for p in q.paths)})")
        if q.paths != damaged:
            raise AssertionError(f"quarantine {q.paths} != {damaged}")
        out["folders"] = dict(fst, run=True, quarantined=len(q))
        del trainer
    # (12c) ZeRO-1 against DDP
    losses = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for strategy in ("dp", "zero1"):
            trainer, zst = run(f"resnet50_{strategy}_det", [
                "--steps-per-epoch", str(ZERO1_RESNET_STEPS), "--strategy",
                strategy], ZERO1_RESNET_STEPS)
            losses[strategy] = zst["losses"]
            del trainer
    finally:
        torch.backends.cudnn.deterministic = det
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses["zero1"],
                                                   losses["dp"]))
    print(f"(12c) resnet50_imagenet --strategy zero1 vs dp, world 1, "
          f"{ZERO1_RESNET_STEPS} steps (deterministic cuDNN): zero1 "
          + " ".join(f"{x:.6f}" for x in losses["zero1"]) + "; dp "
          + " ".join(f"{x:.6f}" for x in losses["dp"])
          + f"; worst relative gap {worst:.2e} (<= {ZERO1_LOSS_RTOL:g}), "
          f"{'bitwise' if losses['zero1'] == losses['dp'] else 'not bitwise'}")
    if not worst <= ZERO1_LOSS_RTOL:
        raise AssertionError("ZeRO-1 and DDP losses disagree")
    out["zero1"] = dict(losses=losses, worst_rel=worst,
                        bitwise=losses["zero1"] == losses["dp"])
    return out


def _wire_checks(device, seed):
    """(12d) ``q8_local_roundtrip`` (and the codes and scales) on the card
    against the CPU, bitwise; in a world of one (NCCL) ``ring_all_reduce``
    returns its input, and one chunk through the two-stage routine's body
    gives the owner's rounding: f32 and bf16 unchanged, q8 the quantized
    round trip, and no byte on the wire."""
    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch.parallel import overlap

    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(Q8_CHECK_ELEMS) * 3).astype(np.float32)
    x[256:512] = 0.0
    x[1000] = np.nan
    x[2000] = np.inf
    cpu = overlap.q8_local_roundtrip(torch.from_numpy(x))
    gpu = overlap.q8_local_roundtrip(torch.from_numpy(x).to(device)).cpu()
    same = torch.equal(cpu.view(torch.int32), gpu.view(torch.int32))
    q_cpu = overlap.q8_quantize(torch.from_numpy(x))
    q_gpu = [t.cpu() for t in overlap.q8_quantize(
        torch.from_numpy(x).to(device))]
    codes_same = torch.equal(q_cpu[0], q_gpu[0]) and torch.equal(
        q_cpu[1].view(torch.int32), q_gpu[1].view(torch.int32))
    res = dict(roundtrip_bitwise=same, codes_bitwise=codes_same)
    with _World1(device):
        xt = torch.from_numpy(x[:300_000]).to(device)
        xt = torch.where(torch.isfinite(xt), xt, torch.zeros_like(xt))
        ident = all(torch.equal(overlap.ring_all_reduce(xt, q8=q8), xt)
                    for q8 in (False, True))
        stats = overlap.SyncStats()   # the facade's collectives
        f32 = overlap._reduce_chunk(xt, False, stats)
        b16 = overlap._reduce_chunk(xt.to(torch.bfloat16), False, stats)
        q8 = overlap._reduce_chunk(xt, True, stats)
        chunk_ok = (torch.equal(f32, xt)
                    and torch.equal(b16, xt.to(torch.bfloat16))
                    and torch.equal(q8, overlap.q8_local_roundtrip(xt)))
    res.update(world1_identity=ident, world1_chunk=chunk_ok,
               world1_wire_bytes=stats.wire_bytes)
    print(f"(12d) q8 round trip of {Q8_CHECK_ELEMS} f32 (zero, NaN and inf "
          f"blocks) on the card vs the CPU: values "
          f"{'bitwise' if same else 'DIFFER'}, codes and scales "
          f"{'bitwise' if codes_same else 'DIFFER'}; ring_all_reduce at "
          f"world 1 the identity: {ident}; one chunk through the two-stage "
          f"routine's body at world 1 (f32, bf16, q8): "
          f"{'as the owner rounds' if chunk_ok else 'WRONG'} "
          f"({stats.wire_bytes} wire bytes: none at world 1)")
    if not (same and codes_same and ident and chunk_ok
            and stats.wire_bytes == 0):
        raise AssertionError(f"wire-form checks failed: {res}")
    return res


def image_phase(device, seed):
    """Phase 12, (a)-(d); (a)'s profile is :func:`image_profile`, run
    last. Returns (stats, launches by path)."""
    import gc
    import tempfile

    import torch

    t_phase = time.perf_counter()
    torch.backends.cudnn.benchmark = True
    stats, by_path = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        stats["cifar"] = _cifar_recipe(device, seed, tmp)
        by_path["resnet18_cifar10"] = stats["cifar"]["launches"]
        gc.collect()
        torch.cuda.empty_cache()
        stats["resnet50"] = _image50(device, seed, tmp, by_path)
    gc.collect()
    torch.cuda.empty_cache()
    stats["wire"] = _wire_checks(device, seed)
    stats["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 12: {stats['wall_s']:.1f} s; launches by path {by_path}")
    return stats, by_path


def image_profile(device, seed, stats):
    """(12a) torch.profiler over two steps of the CIFAR recipe's step
    (ResNet-18 CIFAR stem in DDP, the device normalizer, SGD with
    Nesterov momentum), rebuilt in a live world of one (the recipe's own
    was torn down) on one of its batches: device busy ms and the idle
    share against the recipe's median step."""
    import torch

    from pytorch_distributed_tpu_torch import (
        DataParallel,
        Policy,
        ResNet18,
        TrainState,
        build_train_step,
        classification_loss_fn,
        optim,
    )
    from pytorch_distributed_tpu_torch.data import device_normalizer_for
    from pytorch_distributed_tpu_torch.recipes.resnet18_cifar10 import (
        CIFAR_MEAN,
        CIFAR_STD,
    )

    batch = stats["cifar"].pop("_profile_batch")
    with _World1(device):
        model = ResNet18(10, stem="cifar", device=device,
                         policy=Policy.train())
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
        ddp = DataParallel(device).wrap(model)
        step = build_train_step(
            classification_loss_fn(ddp, weight_decay=5e-4),
            batch_transform=device_normalizer_for(CIFAR_MEAN, CIFAR_STD))
        state = TrainState(ddp, optim.SGD(
            model, lr=optim.WarmupCosine(0.1, 0, 100), momentum=0.9,
            nesterov=True))
        for _ in range(5):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        total_us, rows = profile_step(step, state, batch)
    step_ms = stats["cifar"]["step_ms"]
    busy = total_us / 2e3
    families = by_family(rows)
    if total_us:
        print(f"(12a) profile, 2 steps of resnet18_cifar10's step: device "
              f"busy {busy:.3f} ms/step against the recipe's median step of "
              f"{step_ms:.2f} ms (idle {100 * (1 - busy / step_ms):.1f}%)")
        for name, ms in sorted(families.items(), key=lambda kv: -kv[1]):
            print(f"  {ms:9.3f} ms/step  {100 * ms / busy:5.1f}%  {name}")
    else:
        print("(12a) profiler: no device time recorded (not measured)")
    return dict(device_busy_ms=busy,
                idle_share=(1 - busy / step_ms) if total_us else None,
                families=families)


# -- 13. the trainer's lifecycle and the optimizer library ----------------

ADAFACTOR_LR = 1e-2      # (13a) a relative step of ~1% of each leaf's RMS
LIFE_LAYERS = 2          # (13b) of GPT-2-medium's 24: the saves, not the
# step, are the subject; the embedding (51.5M of the 78M params) remains
LIFE_EPOCHS, LIFE_STEPS, LIFE_EVAL_BATCHES = 2, 3, 2
LIFE_EVERY, LIFE_KEEP = 2, 2
MFU_RESNET_BATCH, MFU_RESNET_STEPS = 64, 3   # (13c)
STALL_LIMIT_S, STALL_S = 1.0, 1.8            # (13d)


def _peak_gib(device):
    import torch

    return torch.cuda.max_memory_allocated(device) / 2**30


def _reset_peak(device):
    import torch

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)


def _median_ms(hist):
    steady = sorted(r["step_time_s"] for r in hist[1:])
    return 1e3 * steady[len(steady) // 2]


def _adafactor_phase(device, seed, adamw):
    """(13a) the Llama recipe's ``--optimizer adafactor`` at 8a's cut: 6
    steps (one repeated batch, so the loss must fall) with ``log_mfu``, a
    checkpoint at 3 restored into another model and compared to the
    bit (Adafactor's state included), steps 4-6 again."""
    import gc
    import tempfile

    import torch

    from pytorch_distributed_tpu_torch.runtime import tracing
    from pytorch_distributed_tpu_torch.runtime.device import peak_flops

    kw = dict(optimizer="adafactor", lr=ADAFACTOR_LR, rows=LLAMA_BATCH,
              epochs=LLAMA_STEPS, steps=1)
    stats = {}
    with tempfile.TemporaryDirectory(prefix="ptd_adafactor_") as tmp:
        model, trainer = _llama_trainer(device, seed, tmp, log_mfu=True,
                                        **kw)
        n_params = sum(p.numel() for p in model.parameters())
        snap = {}
        save = trainer.save_checkpoint

        def save_at_ckpt_step(tag="latest"):
            # one save (7.7 GB of parameters and a few MB of state)
            if trainer.host_step != LLAMA_CKPT_AT or "state" in snap:
                return None
            path = save(tag)
            snap["state"] = _llama_snapshot(model, trainer)
            return path

        trainer.save_checkpoint = save_at_ckpt_step
        _reset_peak(device)
        kernel_counts(reset=True)
        with tracing.enabled() as tracer:   # the main path
            t0 = time.perf_counter()
            trainer.fit()
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        counts = kernel_counts()
        peak = _peak_gib(device)
        state_bytes = _opt_state_bytes(trainer.state.optimizer)
        roll = tracer.rollups()
        hist = trainer.history
        losses = [r["loss"] for r in hist]
        step_ms = _median_ms(hist)
        tokens = LLAMA_BATCH * LLAMA_SEQ
        L = model.config.num_layers * LLAMA_STEPS
        want = dict(flash_fwd=2 * L, flash_dq=L, flash_dkv=L)
        launches = {k: counts[k] for k in FLASH}
        flops, flash_flops = trainer._step_flops, trainer._step_flash_flops
        peak_flop = peak_flops(device)
        mfu = flops / (step_ms / 1e3) / peak_flop if peak_flop else None
        ckpt = roll.get("train.checkpoint", {})
        opt = trainer.state.optimizer
        factored = sum(1 for leaf in opt.leaves if opt.factored(leaf))
        print(f"(13a) Llama-3-8B width, {model.config.num_layers} layers, "
              f"{n_params} params, FSDP at world 1, remat, vocab chunk "
              f"{LLAMA_CHUNK}, batch {LLAMA_BATCH} x {LLAMA_SEQ}, "
              f"--optimizer adafactor (lr {ADAFACTOR_LR}, no clip; "
              f"{factored} of {len(opt.leaves)} JAX leaves factored): "
              f"{LLAMA_STEPS} steps in {wall:.2f} s incl. "
              f"{ckpt.get('count', 0)} checkpoint(s) of "
              f"{ckpt.get('mean_ms', 0.0):.0f} ms; step ms "
              + " ".join(f"{r['step_time_s'] * 1e3:.2f}" for r in hist)
              + f", median of steps 2-{LLAMA_STEPS} {step_ms:.2f} ms = "
              f"{tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
              f"{peak:.2f} GiB; optimizer state {state_bytes} bytes "
              f"({state_bytes / 2**20:.2f} MiB); losses "
              + " ".join(f"{x:.4f}" for x in losses)
              + f"; launches {counts} (want {want})")
        print(f"(13a) AdamW at the same cut (8a, this run): "
              f"{adamw['step_ms_median']:.2f} ms/step, "
              f"{adamw['tokens_per_s']:.0f} tokens/s, peak "
              f"{adamw['peak_mem_gib']:.2f} GiB, optimizer state "
              f"{adamw['opt_state_bytes']} bytes "
              f"({adamw['opt_state_bytes'] / 1e9:.2f} GB); Adafactor keeps "
              f"{state_bytes / max(adamw['opt_state_bytes'], 1):.2e} of it")
        print(f"(13a) log_mfu: {flops:.4g} FLOPs a step counted in step 1 "
              f"({flash_flops:.4g} of them the flash kernels', "
              f"{100 * flash_flops / flops:.1f}%; remat's recompute "
              f"included): {flops / step_ms / 1e9:.1f} TFLOP/s at the "
              f"median step, MFU "
              + (f"{100 * mfu:.2f}% of {peak_flop / 1e12:.0f} TFLOP/s"
                 if mfu else "off (no peak for this device)"))
        if len(losses) != LLAMA_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"Adafactor losses {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"Adafactor's loss did not fall: {losses}")
        if launches != want:
            raise AssertionError(f"flash launches {launches} != {want}")
        off_path(counts, FLASH)
        if not flash_flops > 0:
            raise AssertionError("log_mfu counted no attention FLOPs")
        if not all("tflops" in r for r in hist):
            raise AssertionError("log_mfu logged no TFLOP/s")
        stats.update(params=n_params, losses=losses, step_ms_median=step_ms,
                     step_ms=[1e3 * r["step_time_s"] for r in hist],
                     tokens_per_s=tokens / step_ms * 1e3, peak_mem_gib=peak,
                     opt_state_bytes=state_bytes,
                     adamw_opt_state_bytes=adamw["opt_state_bytes"],
                     launches=counts, wall_s=wall, step_flops=flops,
                     flash_flops=flash_flops, mfu=mfu,
                     peak_flops=peak_flop, factored_leaves=factored,
                     leaves=len(opt.leaves),
                     ckpt_save_ms=ckpt.get("mean_ms"))
        saved = snap["state"]
        del model, trainer, opt
        gc.collect()
        torch.cuda.empty_cache()

        model, trainer = _llama_trainer(device, seed, tmp,
                                        init_seed=seed + 1, **kw)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        if not trainer.restore_checkpoint():
            raise AssertionError("nothing restored")
        torch.cuda.synchronize(device)
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
        kinds = sorted({k.rsplit(".", 1)[1] for k in saved["tensors"]
                        if k.rsplit(".", 1)[1] in (
                            "v", "v_row", "v_col", "v_leaf", "step")})
        trainer.config = dataclasses.replace(trainer.config, ckpt_dir=None)
        trainer.fit()
        resumed = [r["loss"] for r in trainer.history]
        print(f"(13a) restore of step {LLAMA_CKPT_AT} in {restore_ms:.0f} ms:"
              f" {len(saved['tensors'])} tensors (parameters and Adafactor's "
              f"{'/'.join(kinds)}), step and cursor equal to the bit; steps "
              f"4-6 " + " ".join(f"{x:.6f}" for x in resumed) + " against "
              + " ".join(f"{x:.6f}" for x in losses[LLAMA_CKPT_AT:]))
        if resumed != losses[LLAMA_CKPT_AT:]:
            raise AssertionError("the resumed run left the uninterrupted one")
        stats.update(restore_ms=restore_ms, resumed_losses=resumed)
        del model, trainer, saved, got
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def _lifecycle_trainer(device, seed, ckpt_dir, metrics, *, async_save):
    """(13b) the GPT-2 recipe's ZeRO-1 trainer (GPT-2-medium's width,
    ``LIFE_LAYERS`` layers, remat, vocab chunk 8192, batch 8 x 1024 in 2
    microbatches, adamw(3e-4)) with the JAX recipe's checkpoint
    lifecycle: a step tag every ``LIFE_EVERY`` steps, the newest
    ``LIFE_KEEP`` kept, ``best`` on the eval loss (min), early stopping
    after one eval without improvement, async or sync saves."""
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
    from pytorch_distributed_tpu_torch.train import causal_lm_eval_step

    cfg = dc.replace(GPT2Config.medium(), remat=True, num_layers=LIFE_LAYERS)
    policy = Policy.train()
    model = GPT2LMHead(cfg, device=device, policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    strategy = ZeRO1(device)
    opt = optim.clip_grad_norm(strategy.optimizer(
        model, optim.AdamW, lr=3e-4, weight_decay=1e-4), 1.0)
    net = strategy.wrap(model)
    seq = 1024
    ds = SyntheticTextDataset(n=LIFE_STEPS * 8, seq_len=seq,
                              vocab_size=cfg.vocab_size, seed=seed)
    eval_ds = SyntheticTextDataset(n=LIFE_EVAL_BATCHES * 8, seq_len=seq,
                                   vocab_size=cfg.vocab_size, seed=seed + 1)
    trainer = Trainer(
        TrainState(net, opt, policy=policy),
        build_train_step(causal_lm_loss_fn(net, vocab_chunk_size=ZERO_CHUNK),
                         accum_steps=2),
        DataLoader(ds, 8, seed=seed, sharding=device),
        eval_step=causal_lm_eval_step(net, vocab_chunk_size=ZERO_CHUNK),
        eval_loader=DataLoader(eval_ds, 8, shuffle=False, sharding=device),
        config=TrainerConfig(
            epochs=LIFE_EPOCHS, log_every=1, max_steps_per_epoch=LIFE_STEPS,
            ckpt_dir=ckpt_dir, ckpt_every_steps=LIFE_EVERY,
            keep_checkpoints=LIFE_KEEP, async_checkpoint=async_save,
            keep_best="loss", best_mode="min", early_stop_patience=1,
            metrics_path=metrics))
    return model, trainer


def _crcs(final):
    with open(os.path.join(final, "manifest.json")) as f:
        return {e["path"]: [s.get("checksum") for s in e["shards"]]
                for e in json.load(f)["leaves"]}


def _lifecycle_run(device, seed, tmp, async_save):
    import torch

    from pytorch_distributed_tpu_torch.runtime import tracing
    from pytorch_distributed_tpu_torch.train import read_metrics

    name = "async" if async_save else "sync"
    ck, metrics = os.path.join(tmp, name), os.path.join(tmp, name + ".jsonl")
    model, trainer = _lifecycle_trainer(device, seed, ck, metrics,
                                        async_save=async_save)
    _reset_peak(device)
    kernel_counts(reset=True)
    with tracing.enabled() as tracer:   # this path
        t0 = time.perf_counter()
        trainer.fit()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    counts = kernel_counts()
    roll = tracer.rollups()
    recs = read_metrics(metrics)
    evals = [(r["step"], r["loss"]) for r in recs if r["split"] == "eval"]
    return dict(model=model, trainer=trainer, ck=ck, wall=wall,
                counts=counts, roll=roll, evals=evals,
                losses=[r["loss"] for r in trainer.history],
                step_ms=_median_ms(trainer.history),
                ckpt_ms=roll["train.checkpoint"]["mean_ms"],
                ckpt_count=roll["train.checkpoint"]["count"],
                goodput=trainer.last_goodput, peak=_peak_gib(device),
                name=name)


def _lifecycle_phase(device, seed):
    """(13b): the async run (the main path), then the sync one."""
    import gc
    import tempfile

    import torch

    from pytorch_distributed_tpu_torch.train import save_checkpoint
    from pytorch_distributed_tpu_torch.train.ckpt_io import (
        checkpoint_step,
        step_tags,
    )

    by_path, stats = {}, {}
    with tempfile.TemporaryDirectory(prefix="ptd_life_") as tmp:
        runs = {}
        for async_save in (True, False):
            r = _lifecycle_run(device, seed, tmp, async_save)
            L = r["model"].config.num_layers
            steps = r["trainer"].host_step
            n_evals = len(r["evals"])
            per = L * steps * 2          # layers x steps x microbatches
            want = dict(flash_fwd=2 * per + L * LIFE_EVAL_BATCHES * n_evals,
                        flash_dq=per, flash_dkv=per)
            launches = {k: r["counts"][k] for k in FLASH}
            tags = step_tags(r["ck"])
            best_step = checkpoint_step(r["ck"], "best")
            best_eval, best = None, None
            for step, loss in r["evals"]:   # the trainer's own rule
                if math.isfinite(loss) and (best is None or loss < best):
                    best_eval, best = step, loss
            g = r["goodput"]
            buckets = sum(v for k, v in g.items()
                          if k.endswith("_s") and k != "wall_s")
            print(f"(13b) GPT-2-medium width, {L} layers, ZeRO-1, remat, "
                  f"vocab chunk {ZERO_CHUNK}, {r['name']} saves: {steps} "
                  f"steps in {r['wall']:.2f} s, {r['ckpt_count']} saves "
                  f"(train.checkpoint {r['ckpt_ms']:.0f} ms mean on the "
                  f"loop), median step {r['step_ms']:.2f} ms; step tags "
                  f"left {tags}, best at step {best_step} (the best eval's:"
                  f" {best_eval}; evals {r['evals']}); goodput "
                  f"{g['goodput_pct']:.1f}% of {g['wall_s']:.2f} s "
                  f"(productive {g['productive_s']:.2f}, checkpoint "
                  f"{g['checkpoint_s']:.2f}, other {g['other_s']:.2f}; "
                  f"buckets sum {buckets:.6f}); losses "
                  + " ".join(f"{x:.4f}" for x in r["losses"])
                  + f"; launches {r['counts']} (want {want})")
            if len(tags) != LIFE_KEEP or tags != sorted(tags)[-LIFE_KEEP:]:
                raise AssertionError(f"step tags left {tags}")
            if best_step != best_eval:
                raise AssertionError(f"best at {best_step}, best eval at "
                                     f"{best_eval}")
            if launches != want:
                raise AssertionError(f"flash launches {launches} != {want}")
            off_path(r["counts"], FLASH)
            if not math.isclose(buckets, g["wall_s"], rel_tol=1e-6):
                raise AssertionError(f"goodput buckets {buckets} != wall "
                                     f"{g['wall_s']}")
            if not all(map(math.isfinite, r["losses"])):
                raise AssertionError(f"losses {r['losses']}")
            by_path["gpt2_lifecycle" if async_save
                    else "gpt2_lifecycle_sync"] = r["counts"]
            runs[r["name"]] = r
        a, s = runs["async"], runs["sync"]
        if a["losses"] != s["losses"]:
            raise AssertionError("async saves moved the training: "
                                 f"{a['losses']} vs {s['losses']}")
        # the async run's last save against a sync save of its final state,
        # and each step tag against the sync run's: step-4 was written while
        # steps 5-6 changed the state under the writer thread
        final = a["trainer"]
        save_checkpoint(os.path.join(tmp, "same"), final.state, tag="sync")
        pairs = {"latest": (os.path.join(a["ck"], "latest"),
                            os.path.join(tmp, "same", "sync"))}
        for x in step_tags(a["ck"]):
            pairs[f"step-{x}"] = (os.path.join(a["ck"], f"step-{x}"),
                                  os.path.join(s["ck"], f"step-{x}"))
        same = {k: _crcs(p) == _crcs(q) for k, (p, q) in pairs.items()}
        n_leaves = len(_crcs(pairs["latest"][0]))
        print(f"(13b) async vs sync saves: train.checkpoint "
              f"{a['ckpt_ms']:.0f} vs {s['ckpt_ms']:.0f} ms a save on the "
              f"loop, median step {a['step_ms']:.2f} vs {s['step_ms']:.2f} "
              f"ms, fit {a['wall']:.2f} vs {s['wall']:.2f} s; CRCs equal to "
              f"the sync ones ({n_leaves} leaves): {same} ('latest' against "
              f"a sync save of the same state, each step tag against the "
              f"sync run's)")
        if len(same) != 1 + LIFE_KEEP or not all(same.values()):
            raise AssertionError(f"async and sync saves differ: {same}")
        for r in (a, s):
            stats[r["name"]] = dict(
                wall_s=r["wall"], ckpt_ms=r["ckpt_ms"],
                saves=r["ckpt_count"], step_ms_median=r["step_ms"],
                losses=r["losses"], evals=r["evals"], goodput=r["goodput"],
                launches=r["counts"], peak_mem_gib=r["peak"])
        stats["crc_equal"] = same
        del runs, a, s, final
    gc.collect()
    torch.cuda.empty_cache()
    return stats, by_path


def _watchdog_phase(device, seed):
    """(13d) one stall in the loop, longer than ``stall_timeout_s``,
    injected in a step's batch fetch: the watchdog fires once and
    goodput's ``stalled`` holds its window."""
    import torch

    from pytorch_distributed_tpu_torch import (
        Trainer,
        TrainerConfig,
        TrainState,
        build_train_step,
        optim,
    )

    gen = torch.Generator(device=device).manual_seed(seed)
    model = torch.nn.Linear(1024, 1024, device=device)
    batches = [{"x": torch.randn(256, 1024, device=device, generator=gen)}
               for _ in range(4)]

    class Loader:
        def set_epoch(self, epoch):
            pass

        def __len__(self):
            return len(batches)

        def __iter__(self):
            for i, b in enumerate(batches):
                if i == 2:
                    time.sleep(STALL_S)   # the stall
                yield b

    def loss_fn(batch, generator):
        loss = model(batch["x"]).square().mean()
        return loss, {"metrics": {"loss": loss.detach()}}

    trainer = Trainer(TrainState(model, optim.AdamW(model, lr=1e-3)),
                      build_train_step(loss_fn), Loader(),
                      config=TrainerConfig(log_every=1,
                                           stall_timeout_s=STALL_LIMIT_S))
    fired = []
    note = trainer._note_stall
    trainer._note_stall = lambda idle: (fired.append(idle), note(idle))
    kernel_counts(reset=True)
    trainer.fit()
    counts = kernel_counts()
    g = trainer.last_goodput
    print(f"(13d) watchdog (limit {STALL_LIMIT_S} s) over a {STALL_S} s stall"
          f" in step 3's fetch: fired {len(fired)} time(s) at idle "
          + " ".join(f"{x:.2f} s" for x in fired)
          + f"; goodput stalled {g['stalled_s']:.2f} s of "
          f"{g['wall_s']:.2f} s; launches {counts}")
    if len(fired) != 1 or not g["stalled_s"] >= STALL_LIMIT_S:
        raise AssertionError(f"watchdog fired {fired}, stalled "
                             f"{g['stalled_s']}")
    off_path(counts, ())
    return dict(fired=fired, goodput=g), counts


def lifecycle_phase(device, seed, adamw):
    """Phase 13 (a, b, d) in its own NCCL world of one: the Llama
    recipe's Adafactor, the GPT-2 ZeRO-1 trainer's checkpoint lifecycle
    and the watchdog. Returns (stats, launches by path)."""
    with _World1(device):
        kernel_counts(reset=True)
        a = _adafactor_phase(device, seed, adamw)
        by_path = {"llama_adafactor": a["launches"]}
        b, paths = _lifecycle_phase(device, seed)
        by_path.update(paths)
        d, counts = _watchdog_phase(device, seed)
        by_path["watchdog"] = counts
    return dict(adafactor=a, lifecycle=b, watchdog=d), by_path


def recipe_config_phase(device, seed):
    """(13c) the ResNet-50 recipe through its ``RecipeConfig`` at batch
    64 with ``--log-mfu --profile-dir --keep-checkpoints
    --async-checkpoint --keep-best``: MFU beside the card's peak, the
    whole fit's profiler trace parsed, the goodput record summing to its
    wall. Run last: the profiler slows the host after it."""
    import glob
    import tempfile

    import torch

    from pytorch_distributed_tpu_torch.recipes import resnet50_imagenet
    from pytorch_distributed_tpu_torch.runtime.device import peak_flops
    from pytorch_distributed_tpu_torch.train import read_metrics

    with tempfile.TemporaryDirectory(prefix="ptd_r50cfg_") as tmp:
        ck, prof = os.path.join(tmp, "ck"), os.path.join(tmp, "prof")
        metrics = os.path.join(tmp, "m.jsonl")
        argv = ["--batch-size", str(MFU_RESNET_BATCH), "--epochs", "2",
                "--steps-per-epoch", str(MFU_RESNET_STEPS),
                "--log-every", "1", "--seed", str(seed), "--lr", "0.025",
                "--ckpt-dir", ck, "--ckpt-every-steps", "2",
                "--keep-checkpoints", "2", "--async-checkpoint",
                "--keep-best", "accuracy", "--log-mfu",
                "--profile-dir", prof, "--metrics-path", metrics]
        kernel_counts(reset=True)
        t0 = time.perf_counter()
        trainer = resnet50_imagenet.main(argv)
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        hist = trainer.history
        flops = trainer._step_flops
        step_ms = _median_ms(hist)
        peak = peak_flops(device)
        mfu = flops / (step_ms / 1e3) / peak if peak else None
        (trace,) = glob.glob(os.path.join(prof, "*.json"))
        t1 = time.perf_counter()
        with open(trace) as f:
            doc = json.load(f)
        parse_s = time.perf_counter() - t1
        kernels = sum(1 for e in doc.get("traceEvents", ())
                      if e.get("cat") == "kernel")
        (g,) = [r for r in read_metrics(metrics) if r["split"] == "goodput"]
        buckets = sum(v for k, v in g.items()
                      if k.endswith("_s") and k != "wall_s")
        tags = sorted(d for d in os.listdir(ck) if d.startswith("step-"))
        name = torch.cuda.get_device_name(device)
        print(f"(13c) ResNet-50 recipe via RecipeConfig, batch "
              f"{MFU_RESNET_BATCH}, {trainer.state.step} steps in "
              f"{wall:.2f} s under --profile-dir: {flops:.4g} FLOPs a step, "
              f"median step {step_ms:.2f} ms = "
              f"{flops / step_ms / 1e9:.1f} TFLOP/s, MFU "
              + (f"{100 * mfu:.2f}% of {peak / 1e12:.0f} TFLOP/s ({name}'s "
                 f"dense bf16 peak)" if mfu else "off")
              + f"; trace {os.path.basename(trace)} "
              f"{os.path.getsize(trace) / 2**20:.1f} MiB, "
              f"{len(doc.get('traceEvents', ()))} events ({kernels} device "
              f"kernels) parsed in {parse_s:.2f} s; goodput "
              f"{g['goodput_pct']:.1f}% of {g['wall_s']:.2f} s, buckets sum "
              f"{buckets:.6f}; step tags {tags}, best "
              f"{os.path.isdir(os.path.join(ck, 'best'))}; launches {counts}")
        if not math.isclose(buckets, g["wall_s"], rel_tol=1e-6):
            raise AssertionError("goodput buckets do not sum to wall")
        if not kernels:
            raise AssertionError("the profiler trace holds no device kernel")
        if len(tags) != 2 or not os.path.isdir(os.path.join(ck, "best")):
            raise AssertionError(f"checkpoints {os.listdir(ck)}")
        off_path(counts, ())
        del trainer, doc
    return dict(mfu=mfu, step_flops=flops, step_ms_median=step_ms,
                peak_flops=peak, trace_events=kernels, goodput=g,
                wall_s=wall, launches=counts), counts


# --------------------------------------------------------------------------
# phase 14: the model families (Gemma, Mistral, Qwen2, Qwen3, Phi-3, tied
# Llama-3.2, GPT-NeoX/Pythia), HF interop, and the flash and paged kernels
# at the head dims and groups they bring
# --------------------------------------------------------------------------

# (14a) a 7-8B family's layers cut to this many (Gemma-2B and
# Llama-3.2-1B run at full depth): widths stay published
FAMILY_LAYERS = 4
# (14a) Mistral again with its 4,096-token window cut to this, so that
# the band masks inside the 64-1024-token prompts
MISTRAL_CUT_WINDOW = 256
# (14a) the engine: 8 slots, 32-token pages, room for 1024 + 64 tokens
FAMILY_ENGINE = dict(num_slots=8, max_len=1152, prefill_chunk=256,
                     page_size=32)
# (14b) Pythia-1B through generate: rows, prompt and new tokens
PYTHIA_ROWS, PYTHIA_PROMPT, PYTHIA_NEW = 8, 256, 64
# (14c) the flash kernels at the families' training shapes, causal
FAMILY_FLASH_SHAPES = (
    ("phi3_mini", dict(B=4, S=2048, T=2048, Hq=32, Hkv=32, D=96)),
    ("gemma_2b", dict(B=4, S=2048, T=2048, Hq=8, Hkv=1, D=256)),
    ("pythia_1b", dict(B=4, S=2048, T=2048, Hq=8, Hkv=8, D=256)),
)
# (14c) Gemma-2B width at FAMILY_LAYERS layers through the Trainer
GEMMA_STEPS, GEMMA_BATCH, GEMMA_SEQ, GEMMA_CHUNK = 6, 8, 1024, 8192
# (14a) the paged kernel at the families' decode ticks: 8 rows, 36 pages
# of 32 (the engine's 1152 positions), head shapes of Phi-3-mini,
# Qwen2-7B (G = 7) and Gemma-2B (G = 8, one kv head), and Mistral's
# window in Mistral-7B's heads
FAMILY_PAGED_SHAPES = (
    ("phi3_mini", dict(B=8, Hq=32, Hkv=32, D=96, ps=32, n=36,
                       max_len=1100)),
    ("qwen2_7b", dict(B=8, Hq=28, Hkv=4, D=128, ps=32, n=36, max_len=1100)),
    ("gemma_2b", dict(B=8, Hq=8, Hkv=1, D=256, ps=32, n=36, max_len=1100)),
    ("mistral_7b", dict(B=8, Hq=32, Hkv=8, D=128, ps=32, n=36,
                        max_len=1100)),
)
# (14d) the HF round trip: f32 on the CPU and on the card, so the logits
# are held as tests/test_torch_llama.py holds them (1e-5 of their largest
# magnitude: the two sum in other orders)
HF_LAYERS = 2
HF_LOGIT_RTOL = 1e-5


def family_paged_cases(shape, window):
    """The paged checks at a family's decode tick: W = 1, the verify
    block W = 5, and (with ``window``) the band inside the rows."""
    n = shape["n"]
    cases = [("decode W=1", 1, None, n, None), ("verify W=5", 5, None, n,
                                                None)]
    if window:
        cases.append((f"window {window}", 1, window, n, None))
    return tuple(cases)


def _family_models():
    """(name, config) of 14a's models: published widths, seeded bf16."""
    import dataclasses as dc

    from pytorch_distributed_tpu_torch.models import (
        GemmaConfig,
        LlamaConfig,
        MistralConfig,
        Phi3Config,
        Qwen2Config,
        Qwen3Config,
    )

    cut = lambda cfg: dc.replace(cfg, num_layers=FAMILY_LAYERS)  # noqa: E731
    mistral = cut(MistralConfig.mistral_7b())
    return (
        ("gemma_2b", GemmaConfig.gemma_2b()),
        ("qwen2_7b", cut(Qwen2Config.qwen2_7b())),
        ("qwen3_8b", cut(Qwen3Config.qwen3_8b())),
        ("phi3_mini", cut(Phi3Config.phi3_mini())),
        ("llama3_2_1b", LlamaConfig.llama3_2_1b()),
        ("mistral_7b", mistral),
        ("mistral_7b_window256",
         dc.replace(mistral, sliding_window=MISTRAL_CUT_WINDOW)),
    )


def _family_class(cfg):
    from pytorch_distributed_tpu_torch import models

    return getattr(models, type(cfg).__name__.replace("Config",
                                                      "ForCausalLM"))


def _family_serve(device, seed, name, cfg, min_share=None):
    """(14a) one family through the paged engine at phase 4's request mix:
    every request completes, the paged kernel launches once a layer a
    decode tick, every greedy token lies within ``GREEDY_MARGIN`` of a
    teacher-forced forward's argmax (einsum attention: no kernel); with
    ``min_share``, that share of them at least (a mixture of experts,
    whose routing flips at bf16 near-ties)."""
    import torch

    from pytorch_distributed_tpu_torch import EngineConfig, ServeEngine
    from pytorch_distributed_tpu_torch.serve import Request

    t0 = time.perf_counter()
    model = _family_class(cfg)(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    model.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    ecfg = EngineConfig(**FAMILY_ENGINE)
    warm = ServeEngine(model, ecfg)
    warm.submit(Request(prompt_ids=list(range(1, 40)), max_new_tokens=4))
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()
    reqs = _requests(seed, cfg.vocab_size)
    kernel_counts(reset=True)
    engine, handles, timing = _drive(model, ecfg, reqs)   # the main path
    counts = kernel_counts()
    off_path(counts, ("paged_attention",))
    ticks = engine.decode_ticks
    if counts["paged_attention"] != ticks * cfg.num_layers:
        raise AssertionError(
            f"(14a) {name}: paged_attention launched "
            f"{counts['paged_attention']} times over {ticks} ticks x "
            f"{cfg.num_layers} layers")
    if engine.pool.prefix_hits < 1:
        raise AssertionError(f"(14a) {name}: the shared prefix was not "
                             "shared")
    exact, gaps = _teacher_gaps(model, reqs, handles, device)
    worst = max(gaps)
    within = sum(g <= GREEDY_MARGIN for g in gaps) / len(gaps)
    summary = engine.telemetry.summary()
    print(f"(14a) {name}: {n_params} params bf16, {cfg.num_layers} layers, "
          f"head_dim {cfg.head_dim}, {cfg.num_heads}/{cfg.num_kv_heads} "
          f"heads, window {cfg.sliding_window}; {ticks} decode ticks, "
          f"{counts['paged_attention']} paged launches (= ticks x "
          f"{cfg.num_layers}), decode tick {timing['decode_tick_ms']:.2f} "
          f"ms, {summary['tokens_per_sec']:.1f} tokens/s; greedy vs "
          f"teacher-forced {exact}/{len(gaps)} exact, worst gap "
          f"{worst:.4f}, {within:.3f} of them within the margin "
          f"{GREEDY_MARGIN}; {time.perf_counter() - t0:.1f} s")
    if min_share is None and worst > GREEDY_MARGIN:
        raise AssertionError(f"(14a) {name}: a greedy token sits {worst:.4f}"
                             f" below the teacher-forced argmax")
    if min_share is not None and within < min_share:
        raise AssertionError(f"(16c) {name}: {within:.3f} of the greedy "
                             f"tokens within {GREEDY_MARGIN} of the "
                             f"teacher-forced argmax (< {min_share})")
    return counts, dict(
        params=n_params, layers=cfg.num_layers, head_dim=cfg.head_dim,
        heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        window=cfg.sliding_window, decode_ticks=ticks,
        launches=counts["paged_attention"],
        tokens_per_s=summary["tokens_per_sec"], greedy_exact=exact,
        greedy_tokens=len(gaps), greedy_worst_gap=worst,
        greedy_within_margin=within,
        prefix_hits=engine.pool.prefix_hits, **timing)


def _family_paged(device, seed):
    """(14a) the paged kernel at the families' decode-tick shapes against
    ``stream`` and ``gather`` (bf16 and f32, bitwise over two launches),
    and its time at W = 1 beside its bound, plain version and SDPA."""
    import torch

    gen = torch.Generator().manual_seed(seed + 14)
    out = {}
    for name, shape in FAMILY_PAGED_SHAPES:
        window = MISTRAL_CUT_WINDOW if name == "mistral_7b" else None
        checks, same, inputs = _paged_checks(
            gen, shape, family_paged_cases(shape, window), device,
            label=f"{name} ")
        t = _paged_times(*inputs["decode W=1"], device)
        out[name] = dict(
            max_abs_err=max(c["max_abs_err"] for c in checks
                            if c["case"] == f"{name} decode W=1"
                            and c["dtype"] == "bfloat16"),
            checks=checks, deterministic=same,
            **{k: t[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "bytes",
                                 "flops")})
    return out


def _pythia_generate(device, seed):
    """(14b) Pythia-1B at full depth through ``generate`` on its dense
    cache: greedy tokens within ``GREEDY_MARGIN`` of an uncached forward's
    argmax, and that forward (the plain entry point) through the flash
    forward kernel at head_dim 256, once a layer."""
    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch import NeoXConfig, NeoXForCausalLM

    cfg = NeoXConfig.pythia_1b()
    model = NeoXForCausalLM(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    model.requires_grad_(False)
    rng = np.random.default_rng(seed + 15)
    prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (PYTHIA_ROWS, PYTHIA_PROMPT))).to(device)
    kernel_counts(reset=True)
    out, pre_ms, dec_ms, tok_s = _decode_times(model, prompt, None,
                                               PYTHIA_NEW)
    gen_counts = kernel_counts()
    off_path(gen_counts, ())   # decode attends on the einsum path
    kernel_counts(reset=True)
    with torch.no_grad():
        logits = model(out[:, :-1])[:, PYTHIA_PROMPT - 1:]
    fwd_counts = kernel_counts()
    off_path(fwd_counts, ("flash_fwd",))
    if fwd_counts["flash_fwd"] != cfg.num_layers:
        raise AssertionError(f"(14b) the uncached forward launched "
                             f"{fwd_counts} (want flash_fwd x "
                             f"{cfg.num_layers})")
    if not torch.isfinite(logits).all():
        raise AssertionError("(14b) non-finite logits")
    toks = out[:, PYTHIA_PROMPT:]
    gaps = (logits.max(-1).values
            - logits.gather(2, toks[..., None])[..., 0]).flatten()
    exact = int((logits.argmax(-1) == toks).sum())
    worst = float(gaps.max())
    print(f"(14b) Pythia-1B, {cfg.num_layers} layers, head_dim "
          f"{cfg.head_dim}: generate {PYTHIA_ROWS} x {PYTHIA_PROMPT} + "
          f"{PYTHIA_NEW}: prefill {pre_ms:.2f} ms, decode {dec_ms:.2f} ms a "
          f"token, {tok_s:.1f} tokens/s (launches {gen_counts}); the "
          f"uncached forward launched {fwd_counts}; greedy vs it "
          f"{exact}/{toks.numel()} exact, worst gap {worst:.4f} (margin "
          f"{GREEDY_MARGIN})")
    if worst > GREEDY_MARGIN:
        raise AssertionError(f"(14b) a greedy token sits {worst:.4f} below "
                             "the uncached forward's argmax")
    return fwd_counts, dict(prefill_ms=pre_ms, decode_ms_per_token=dec_ms,
                            tokens_per_s=tok_s, generate_launches=gen_counts,
                            greedy_exact=exact, greedy_tokens=toks.numel(),
                            greedy_worst_gap=worst)


def _family_flash(device, seed):
    """(14c) the flash kernels at the families' head dims against their
    plain versions and timed (CUDA-graph replays) beside SDPA and the
    bound, bf16 and fp16, causal."""
    import torch

    out, checks = {}, []
    for name, shape in FAMILY_FLASH_SHAPES:
        for dname in ("bfloat16", "float16"):
            gen = torch.Generator().manual_seed(seed + 16)
            rows = _flash_check(gen, seed, name, shape, True, {}, dname,
                                device)
            checks += rows
            worst = {r["what"]: r["max_abs_err"] for r in rows}
            gen = torch.Generator().manual_seed(seed + 16)
            records, details = _flash_times(gen, seed, shape, device, worst,
                                            dtype=getattr(torch, dname))
            out.setdefault(name, {})[dname] = dict(
                records={r["name"]: {k: r[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err")} for r in records}, details=details)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"(14c) flash kernels disagree with plain: "
                             f"{bad}")
    return out, checks


def _gemma_train(device, seed):
    """(14c) Gemma-2B width at ``FAMILY_LAYERS`` layers through the
    Trainer: ``Policy.train()``, remat, the chunked loss through the tied
    head, clip(1.0) then AdamW, one repeated batch of packed rows. The
    loss must fall; B1-B3 launch at head_dim 256 (the forward twice a
    layer and step: remat)."""
    import dataclasses as dc
    import gc

    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch import (
        ArrayDataset,
        DataLoader,
        GemmaConfig,
        GemmaForCausalLM,
        Policy,
        Trainer,
        TrainerConfig,
        TrainState,
        build_train_step,
        causal_lm_loss_fn,
        optim,
    )

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dc.replace(GemmaConfig.gemma_2b(), num_layers=FAMILY_LAYERS,
                     remat=True)
    policy = Policy.train()
    model = GemmaForCausalLM(cfg, device=device, policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    opt = optim.clip_grad_norm(optim.AdamW(model, lr=1e-4,
                                           weight_decay=1e-4), 1.0)
    packed = _packed_rows(seed, GEMMA_BATCH, GEMMA_SEQ, cfg.vocab_size)
    loader = DataLoader(ArrayDataset(**{
        k: np.tile(v, (GEMMA_STEPS, 1)) for k, v in packed.items()}),
        GEMMA_BATCH, shuffle=False)
    step = build_train_step(causal_lm_loss_fn(
        model, vocab_chunk_size=GEMMA_CHUNK))
    _reset_peak(device)
    kernel_counts(reset=True)
    trainer = Trainer(TrainState(model, opt, policy=policy), step, loader,
                      config=TrainerConfig(log_every=1))
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    off_path(counts, FLASH)
    want = {"flash_fwd": 2 * cfg.num_layers * GEMMA_STEPS,
            "flash_dq": cfg.num_layers * GEMMA_STEPS,
            "flash_dkv": cfg.num_layers * GEMMA_STEPS}
    if {k: counts[k] for k in FLASH} != want:
        raise AssertionError(f"(14c) Gemma launches {counts}, want {want}")
    losses = [r["loss"] for r in trainer.history]
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"(14c) Gemma's loss did not fall: {losses}")
    step_ms = _median_ms(trainer.history)
    peak = _peak_gib(device)
    print(f"(14c) Gemma-2B width, {cfg.num_layers} layers, remat, chunked "
          f"loss through the tied head, {GEMMA_BATCH} x {GEMMA_SEQ} packed:"
          f" {GEMMA_STEPS} steps in {wall:.1f} s, median {step_ms:.2f} ms, "
          f"peak {peak:.2f} GiB; losses "
          + " ".join(f"{x:.4f}" for x in losses) + f"; launches {counts}")
    return counts, dict(losses=losses, step_ms_median=step_ms,
                        peak_mem_gib=peak, wall_s=wall,
                        tokens_per_s=GEMMA_BATCH * GEMMA_SEQ / step_ms * 1e3)


def _hf_dict(cfg, seed, fused: bool):
    """A seeded HF-named Llama-body state_dict (numpy f32): norms about
    one, every other tensor 0.02 x normal; ``fused`` gives Phi-3's
    ``qkv_proj`` and ``gate_up_proj``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    D, V, I = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def draw(*shape, norm=False):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        return x + np.float32(1.0) if norm else x

    sd = {"model.embed_tokens.weight": draw(V, D),
          "model.norm.weight": draw(D, norm=True),
          "lm_head.weight": draw(V, D)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = draw(D, norm=True)
        sd[p + "post_attention_layernorm.weight"] = draw(D, norm=True)
        sd[p + "self_attn.o_proj.weight"] = draw(D, q)
        sd[p + "mlp.down_proj.weight"] = draw(D, I)
        if fused:
            sd[p + "self_attn.qkv_proj.weight"] = draw(q + 2 * kv, D)
            sd[p + "mlp.gate_up_proj.weight"] = draw(2 * I, D)
            continue
        for name, rows in (("q", q), ("k", kv), ("v", kv)):
            sd[p + f"self_attn.{name}_proj.weight"] = draw(rows, D)
            if cfg.attention_bias:
                sd[p + f"self_attn.{name}_proj.bias"] = draw(rows)
        sd[p + "mlp.gate_proj.weight"] = draw(I, D)
        sd[p + "mlp.up_proj.weight"] = draw(I, D)
    return sd


def _hf_round_trip(device, seed):
    """(14d) a seeded HF-named dict of Qwen2 at 7B width and of
    Phi-3-mini, ``HF_LAYERS`` layers each, loaded on the CPU and on the
    card (f32, TF32 off): logits equal within ``HF_LOGIT_RTOL``; the
    card model's export equals the input dict bit for bit."""
    import dataclasses as dc

    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch import Phi3Config, Policy, Qwen2Config
    from pytorch_distributed_tpu_torch import interop

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for name, cfg, conv, fused in (
                ("qwen2_7b", Qwen2Config.qwen2_7b(), "qwen2", False),
                ("phi3_mini", Phi3Config.phi3_mini(), "phi3", True)):
            cfg = dc.replace(cfg, num_layers=HF_LAYERS)
            t0 = time.perf_counter()
            hf = _hf_dict(cfg, seed + 17, fused)
            sd = getattr(interop, f"load_{conv}_weights")(hf, cfg)
            cls = _family_class(cfg)
            cpu = cls(cfg, device="meta", policy=Policy.full())
            cpu.load_state_dict(sd, assign=True)
            card = cls(cfg, device="meta", policy=Policy.full())
            card.load_state_dict({k: v.to(device) for k, v in sd.items()},
                                 assign=True)
            ids = torch.from_numpy(np.random.default_rng(seed + 18).integers(
                0, cfg.vocab_size, (2, 16)))
            with torch.no_grad():
                ref = cpu(ids)
                got = card(ids.to(device)).cpu()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            back = getattr(interop, f"export_{conv}_weights")(
                card.state_dict(), cfg)
            same = sorted(back) == sorted(hf) and all(
                np.array_equal(back[k], hf[k]) for k in hf)
            print(f"(14d) {name} ({HF_LAYERS} layers, "
                  f"{sum(v.size for v in hf.values())} HF values): card vs "
                  f"CPU logits max|err| {err:.3e} <= {HF_LOGIT_RTOL:g} * "
                  f"max|ref| {scale:.4f}; export bitwise equal to the input"
                  f": {same}; {time.perf_counter() - t0:.1f} s")
            if not (err <= HF_LOGIT_RTOL * scale and same):
                raise AssertionError(f"(14d) {name}: logits {err} vs "
                                     f"{HF_LOGIT_RTOL * scale}, export "
                                     f"equal {same}")
            out[name] = dict(max_abs_err=err, max_abs_ref=scale,
                             export_bitwise=same)
            del hf, sd, cpu, card, back
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def family_phase(device, seed):
    """Phase 14: 14a the families through the paged engine (and B4 at
    their head shapes), 14b Pythia-1B through generate, 14c the flash
    kernels at head_dim 96 and 256 and Gemma-2B width through the
    Trainer, 14d the HF round trip. Returns (stats, launches by path,
    per-kernel records at the families' shapes)."""
    import gc

    import torch

    t0 = time.perf_counter()
    by_path, serve = {}, {}
    for name, cfg in _family_models():
        counts, serve[name] = _family_serve(device, seed, name, cfg)
        by_path[f"family_{name}"] = counts
        gc.collect()
        torch.cuda.empty_cache()
    paged = _family_paged(device, seed)
    counts, pythia = _pythia_generate(device, seed)
    by_path["family_pythia_1b"] = counts
    gc.collect()
    torch.cuda.empty_cache()
    flash, fchecks = _family_flash(device, seed)
    counts, gemma = _gemma_train(device, seed)
    by_path["family_gemma_2b_train"] = counts
    gc.collect()
    torch.cuda.empty_cache()
    hf = _hf_round_trip(device, seed)
    print(f"(14) phase 14 in {time.perf_counter() - t0:.1f} s; launches by "
          f"path {by_path}")
    stats = dict(serve=serve, paged=paged, pythia=pythia, flash=flash,
                 flash_checks=fchecks, gemma_train=gemma, hf=hf)
    return stats, by_path


# --------------------------------------------------------------------------
# phase 15: tensor and sequence parallelism (the per-rank shapes on one
# card, and the recipe's sequence-parallel path in a world of one)
# --------------------------------------------------------------------------

# (15a) B1-B3 at the per-rank shapes of Llama-3-8B's parallel runs, bf16
# causal: Ulysses at sp 4 (S = 8192: each rank attends over the whole
# sequence with 32 / 4 query heads over 8 / 4 kv heads after its
# all-to-all, batch 4) and TP at tp 2 (16 over 4 heads, batch 8 x 2048)
SP_TP_FLASH_SHAPES = (
    ("ulysses_sp4", dict(B=4, S=8192, T=8192, Hq=8, Hkv=2, D=128)),
    ("tp2", dict(B=8, S=2048, T=2048, Hq=16, Hkv=4, D=128)),
)
# (15b) the recipe at Llama-3-8B width cut to this many layers
SP_LAYERS, SP_BATCH, SP_SEQ, SP_STEPS, SP_CHUNK = 2, 4, 2048, 3, 8192
# (15b) the step losses under ring (f32 einsum blocks) and Ulysses (the
# flash kernels) against the plain path's (the flash kernels): bf16
# products either way, so the loss moves by the attention's bf16
# rounding (ring read 2.0e-5 of itself, Ulysses 0, on an H100 80GB HBM3
# at 700 W); a control run of ring with its causal mask planted off must
# read above the limit, or the limit could not see a wrong mask
SP_LOSS_RTOL = 2e-4


def _sp_flash(device, seed):
    """(15a) the flash kernels at ``SP_TP_FLASH_SHAPES`` against their
    plain versions (phase 3's limits) and timed from CUDA graphs beside
    SDPA's forward and backward and the bound."""
    import torch

    out, checks = {}, []
    for name, shape in SP_TP_FLASH_SHAPES:
        gen = torch.Generator().manual_seed(seed + 17)
        rows = _flash_check(gen, seed, name, shape, True, {}, "bfloat16",
                            device)
        checks += rows
        worst = {r["what"]: r["max_abs_err"] for r in rows}
        gen = torch.Generator().manual_seed(seed + 17)
        records, details = _flash_times(gen, seed, shape, device, worst)
        out[name] = dict(records={r["name"]: {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")} for r in records}, details=details)
        t = out[name]["records"]
        print(f"(15a) {name} {shape}: kernels fwd {t['flash_fwd']['ms']:.3f}"
              f" ms vs sdpa {t['flash_fwd']['library_ms']:.3f} ms, dq + dkv "
              f"{t['flash_dq']['ms'] + t['flash_dkv']['ms']:.3f} ms vs sdpa "
              f"backward {t['flash_dq']['library_ms']:.3f} ms")
        torch.cuda.empty_cache()
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"(15a) flash kernels disagree with plain: "
                             f"{bad}")
    return out, checks


def _sp_recipe(device, seed):
    """(15b) the Llama recipe (``main``, ``--tp 1 --sp 1``) at Llama-3-8B
    width and ``SP_LAYERS`` layers in a NCCL world of one: plain, then
    with the sequence-parallel context on in each mode. Each run's losses
    against the plain run's; launches of the four kernels per run: the
    plain path and Ulysses launch B1 once a layer and step (no remat) and
    B2/B3 once a layer and step in the backward, ring launches none."""
    import dataclasses as dc
    import gc

    import torch

    from pytorch_distributed_tpu_torch import LlamaConfig
    from pytorch_distributed_tpu_torch.parallel import (
        sequence,
        sequence_parallel,
    )
    from pytorch_distributed_tpu_torch.recipes import llama_fsdp

    size = f"8b-{SP_LAYERS}l"
    llama_fsdp.SIZES[size] = lambda: dc.replace(LlamaConfig.llama3_8b(),
                                                num_layers=SP_LAYERS)
    argv = ["--size", size, "--batch-size", str(SP_BATCH), "--seq-len",
            str(SP_SEQ), "--steps-per-epoch", str(SP_STEPS), "--vocab-chunk",
            str(SP_CHUNK), "--log-every", "1", "--seed", str(seed)]
    runs, by_path = {}, {}
    with _World1(device):
        for mode in (None, "ring", "ulysses"):
            name = f"sp_{mode or 'plain'}"
            ctx = (contextlib.nullcontext() if mode is None
                   else sequence_parallel("sp", mode))
            kernel_counts(reset=True)
            _reset_peak(device)
            t0 = time.perf_counter()
            with ctx:
                trainer = llama_fsdp.main(argv)
            wall = time.perf_counter() - t0
            counts = kernel_counts()
            hist = trainer.history
            runs[name] = dict(losses=[r["loss"] for r in hist],
                              step_ms_median=_median_ms(hist),
                              peak_gib=_peak_gib(device), wall_s=wall)
            by_path[name] = counts
            print(f"(15b) {name}: losses {runs[name]['losses']}, step "
                  f"{runs[name]['step_ms_median']:.1f} ms (median), peak "
                  f"{runs[name]['peak_gib']:.2f} GiB, launches {counts}")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
        # the control: ring with causal planted off (no path: its
        # launches are not the main path's)
        ring = sequence.ring_attention
        sequence.ring_attention = (
            lambda *a, **kw: ring(*a, **{**kw, "causal": False}))
        try:
            with sequence_parallel("sp", "ring"):
                trainer = llama_fsdp.main(argv)
        finally:
            sequence.ring_attention = ring
        runs["sp_ring_unmasked"] = dict(
            losses=[r["loss"] for r in trainer.history])
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    per_run = SP_LAYERS * SP_STEPS
    want = {"sp_plain": per_run, "sp_ulysses": per_run, "sp_ring": 0}
    for name, n in want.items():
        got = {k: by_path[name][k] for k in FLASH}
        if got != dict.fromkeys(FLASH, n):
            raise AssertionError(f"(15b) {name}: flash launches {got}, "
                                 f"expected {n} each")
        if by_path[name]["paged_attention"]:
            raise AssertionError(f"(15b) {name} launched the paged kernel")
    plain = runs["sp_plain"]["losses"]
    for name in ("sp_ring", "sp_ulysses"):
        got = runs[name]["losses"]
        err = max(abs(a - b) / abs(b) for a, b in zip(got, plain))
        runs[name]["loss_rel_err_vs_plain"] = err
        if not (len(got) == len(plain) == SP_STEPS and err <= SP_LOSS_RTOL
                and all(math.isfinite(x) for x in got)):
            raise AssertionError(f"(15b) {name} losses {got} vs plain "
                                 f"{plain}: {err:.3e} > {SP_LOSS_RTOL}")
        print(f"(15b) {name} losses within {err:.3e} of the plain path's")
    got = runs["sp_ring_unmasked"]["losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(got, plain))
    runs["sp_ring_unmasked"]["loss_rel_err_vs_plain"] = err
    print(f"(15b) control, ring unmasked: losses {got}, {err:.3e} from the "
          f"plain path's (limit {SP_LOSS_RTOL})")
    if not err > SP_LOSS_RTOL:
        raise AssertionError(f"(15b) ring with its causal mask off reads "
                             f"{err:.3e} <= {SP_LOSS_RTOL}: the limit "
                             f"cannot see a wrong mask")
    return runs, by_path


def sp_tp_phase(device, seed):
    """Phase 15: 15a the flash kernels at the Ulysses and TP per-rank
    shapes, 15b the recipe's sequence-parallel path. Returns (stats,
    launches by path)."""
    t0 = time.perf_counter()
    flash, checks = _sp_flash(device, seed)
    runs, by_path = _sp_recipe(device, seed)
    print(f"(15) phase 15 in {time.perf_counter() - t0:.1f} s")
    return dict(flash=flash, flash_checks=checks, recipe=runs), by_path


# -- 16. mixture-of-experts (Mixtral-8x7B) and ViT-B/16 -------------------

# (16a) ViT-B/16 (no cut) through its recipe: 128 images of 224^2 a step
VIT_BATCH, VIT_STEPS = 128, 10
# (16a) B1-B3 at ViT-B/16's attention shape: 197 tokens (196 patches and
# the cls token), 12 heads of 64, bidirectional, bf16
VIT_FLASH_SHAPE = dict(B=128, S=197, T=197, Hq=12, Hkv=12, D=64)
# (16b) Mixtral-8x7B at full width through its recipe's Trainer, cut to
# MIXTRAL_LAYERS of 32 layers: 3.17e9 parameters, ~47 GiB of f32 weights,
# gradients and AdamW moments before activations
MIXTRAL_LAYERS, MIXTRAL_BATCH, MIXTRAL_SEQ = 2, 4, 2048
MIXTRAL_STEPS, MIXTRAL_CHUNK, MIXTRAL_CF = 4, 8192, 1.25
# (16b) the checkpoint round trip at this many layers: the state is
# 12 bytes a parameter on disk (weights and both moments)
MIXTRAL_CKPT_LAYERS = 1
# (16c) generate and the paged engine, bf16, drop-free, at this many
# layers (6.07e9 parameters, ~11.3 GiB); generate's rows, prompt, new
MIXTRAL_SERVE_LAYERS = 4
MIXTRAL_GEN_ROWS, MIXTRAL_GEN_PROMPT, MIXTRAL_GEN_NEW = 8, 256, 32
# (16c) the share of greedy tokens within GREEDY_MARGIN of the
# teacher-forced argmax that Mixtral must reach: its top-2 routing reads
# bf16 hidden states, so where two experts' router logits tie to within
# bf16 rounding the engine and the teacher-forced forward pick different
# experts, and the logits there move by far more than the margin
# (predicted: a few percent of token-layers)
MIXTRAL_GREEDY_SHARE = 0.8
# (16d) one MoE layer at Mixtral's widths, f32, on the card against the
# same layer on the CPU: tokens, and the limit on the outputs (f32 sums
# of 4,096 and 14,336 terms in other orders)
MOE_CHECK_TOKENS, MOE_CHECK_RTOL = 128, 1e-4


def _vit_phase(device, seed):
    """(16a) the ViT recipe's ``main`` at ViT-B/16 (no cut), synthetic u8
    224^2 images normalized and flipped on the card, ``VIT_STEPS`` steps
    of ``VIT_BATCH`` and one eval pass over 2 batches: finite losses and
    eval metrics; B1 launches 12 a step and 12 an eval batch, B2 and B3
    12 a step. Then B1-B3 at its attention shape against their plain
    versions, timed beside SDPA and the bound."""
    import torch

    from pytorch_distributed_tpu_torch.recipes import vit_imagenet

    argv = ["--batch-size", str(VIT_BATCH), "--steps-per-epoch",
            str(VIT_STEPS), "--epochs", "1", "--synthetic", "--log-every",
            "1", "--warmup-epochs", "0", "--seed", str(seed)]
    with _World1(device):
        _reset_peak(device)
        kernel_counts(reset=True)
        t0 = time.perf_counter()
        trainer = vit_imagenet.main(argv)   # the main path
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    step_ms = _median_ms(hist)
    evals = -(-min(50_000, 2 * VIT_BATCH) // VIT_BATCH)
    L = 12
    want = dict(flash_fwd=L * (VIT_STEPS + evals), flash_dq=L * VIT_STEPS,
                flash_dkv=L * VIT_STEPS)
    got = {k: counts[k] for k in FLASH}
    stats = dict(losses=losses, step_ms_median=step_ms,
                 images_per_s=VIT_BATCH / step_ms * 1e3,
                 peak_mem_gib=_peak_gib(device), wall_s=wall,
                 eval=trainer.last_eval_metrics, launches=counts)
    print(f"(16a) ViT-B/16 recipe, batch {VIT_BATCH} x 224^2: {VIT_STEPS} "
          f"steps and {evals} eval batches in {wall:.1f} s, step "
          f"{step_ms:.2f} ms (median), {stats['images_per_s']:.0f} "
          f"images/s, peak {stats['peak_mem_gib']:.2f} GiB; losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; eval {trainer.last_eval_metrics}; launches {counts} (want "
          f"{want})")
    if len(losses) != VIT_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"(16a) ViT losses {losses}")
    if not all(math.isfinite(v) for v in trainer.last_eval_metrics.values()):
        raise AssertionError(f"(16a) eval {trainer.last_eval_metrics}")
    if got != want:
        raise AssertionError(f"(16a) flash launches {got} != {want}")
    off_path(counts, FLASH)
    del trainer
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(seed + 18)
    rows = _flash_check(gen, seed, "vit_b16", VIT_FLASH_SHAPE, False, {},
                        "bfloat16", device)
    bad = [c for c in rows if not c["ok"]]
    if bad:
        raise AssertionError(f"(16a) flash kernels disagree with plain at "
                             f"ViT's shape: {bad}")
    worst = {r["what"]: r["max_abs_err"] for r in rows}
    gen = torch.Generator().manual_seed(seed + 18)
    records, details = _flash_times(gen, seed, VIT_FLASH_SHAPE, device,
                                    worst, causal=False)
    stats["flash"] = dict(records={r["name"]: {k: r[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err")} for r in records}, details=details, checks=rows)
    torch.cuda.empty_cache()
    return stats, counts


def _mixtral_argv(seed, layers, steps, ckpt_dir=None):
    argv = ["--size", "8x7b", "--layers", str(layers), "--vocab", "32000",
            "--batch-size", str(MIXTRAL_BATCH), "--seq-len",
            str(MIXTRAL_SEQ), "--steps-per-epoch", str(steps),
            "--capacity-factor", str(MIXTRAL_CF), "--remat",
            "--vocab-chunk", str(MIXTRAL_CHUNK), "--lr", "1e-4",
            "--log-every", "1", "--eval-rows", "0", "--seed", str(seed)]
    return argv + (["--ckpt-dir", ckpt_dir] if ckpt_dir else [])


def _mixtral_train(device, seed):
    """(16b) the Mixtral recipe's ``main`` at Mixtral-8x7B width and
    ``MIXTRAL_LAYERS`` layers, ``MIXTRAL_STEPS`` steps of 4 x 2048 at
    capacity 1.25 (remat, the chunked loss, clip then AdamW): finite
    losses and load losses, flash launches 2/1/1 a layer and step (the
    forward again in the recompute), the median step, tokens/s, peak."""
    import torch

    from pytorch_distributed_tpu_torch.recipes import mixtral_moe

    with _World1(device):
        _reset_peak(device)
        kernel_counts(reset=True)
        t0 = time.perf_counter()
        trainer = mixtral_moe.main(_mixtral_argv(seed, MIXTRAL_LAYERS,
                                                 MIXTRAL_STEPS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    aux = [r["moe_aux_loss"] for r in hist]
    n_params = sum(p.numel() for p in trainer.state.model.parameters())
    step_ms = _median_ms(hist)
    tokens = MIXTRAL_BATCH * MIXTRAL_SEQ
    L = MIXTRAL_LAYERS * MIXTRAL_STEPS
    want = dict(flash_fwd=2 * L, flash_dq=L, flash_dkv=L)
    got = {k: counts[k] for k in FLASH}
    stats = dict(params=n_params, layers=MIXTRAL_LAYERS, losses=losses,
                 aux=aux, step_ms=[1e3 * r["step_time_s"] for r in hist],
                 step_ms_median=step_ms, tokens_per_s=tokens / step_ms * 1e3,
                 peak_mem_gib=_peak_gib(device), wall_s=wall, launches=counts)
    print(f"(16b) Mixtral-8x7B width, {MIXTRAL_LAYERS} of 32 layers, "
          f"{n_params} params, capacity {MIXTRAL_CF}, batch {MIXTRAL_BATCH} "
          f"x {MIXTRAL_SEQ}, remat, chunk {MIXTRAL_CHUNK}: {MIXTRAL_STEPS} "
          f"steps in {wall:.1f} s, step ms "
          + " ".join(f"{x:.1f}" for x in stats["step_ms"])
          + f", median {step_ms:.2f} = {stats['tokens_per_s']:.0f} tokens/s,"
          f" peak {stats['peak_mem_gib']:.2f} GiB; losses "
          + " ".join(f"{x:.4f}" for x in losses) + "; load losses "
          + " ".join(f"{x:.4f}" for x in aux)
          + f"; launches {counts} (want {want})")
    if len(losses) != MIXTRAL_STEPS or not all(
            map(math.isfinite, losses + aux)):
        raise AssertionError(f"(16b) Mixtral losses {losses}, {aux}")
    if got != want:
        raise AssertionError(f"(16b) flash launches {got} != {want}")
    off_path(counts, FLASH)
    del trainer
    torch.cuda.empty_cache()
    return stats, counts


def _mixtral_ckpt(device, seed):
    """(16b) the checkpoint round trip at ``MIXTRAL_CKPT_LAYERS`` layers:
    the recipe's ``main`` runs 2 steps and checkpoints at the epoch's end;
    a second ``main`` with 2 epochs restores it (every parameter, both
    moments and the step equal to the bit, checked as it restores) and
    trains epoch 2 on."""
    import shutil
    import tempfile

    import torch

    from pytorch_distributed_tpu_torch.recipes import mixtral_moe
    from pytorch_distributed_tpu_torch.train import trainer as trainer_mod

    stats = {}
    with tempfile.TemporaryDirectory(prefix="ptd_mixtral_") as tmp, \
            _World1(device):
        print(f"(16b) checkpoint directory {tmp}: "
              f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB free")
        t0 = time.perf_counter()
        first = mixtral_moe.main(_mixtral_argv(seed, MIXTRAL_CKPT_LAYERS, 2,
                                               tmp))
        torch.cuda.synchronize()
        save_s = time.perf_counter() - t0
        model = first.state.model
        # the state as saved, copied on the card (a host copy and host
        # compares of 20 GB take longer than the restore)
        saved = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = first.state.optimizer.optimizer
        for n, p in model.named_parameters():
            for k, v in opt.state[p].items():
                if torch.is_tensor(v) and v.dim():
                    saved[f"{n}.{k}"] = v.clone()
        n_bytes = sum(t.nbytes for t in saved.values())
        del first, model, opt
        torch.cuda.empty_cache()
        checked = {}
        restore = trainer_mod.Trainer.restore_checkpoint

        def restore_and_check(self, *a, **kw):
            t1 = time.perf_counter()
            out = restore(self, *a, **kw)
            torch.cuda.synchronize()
            checked["restore_s"] = time.perf_counter() - t1
            net = self.state.model
            inner = self.state.optimizer.optimizer
            bad = []
            for n, p in net.named_parameters():
                if not torch.equal(p.detach(), saved[n]):
                    bad.append(n)
                for k, v in inner.state[p].items():
                    if torch.is_tensor(v) and v.dim() and not torch.equal(
                            v, saved[f"{n}.{k}"]):
                        bad.append(f"{n}.{k}")
            saved.clear()
            checked["bad"] = bad
            checked["step"] = self.state.step
            # epoch 2 trains on without a second 20 GB save
            self.config = dataclasses.replace(self.config, ckpt_dir=None)
            return out

        trainer_mod.Trainer.restore_checkpoint = restore_and_check
        try:
            again = mixtral_moe.main(_mixtral_argv(
                seed, MIXTRAL_CKPT_LAYERS, 2, tmp) + ["--epochs", "2"])
        finally:
            trainer_mod.Trainer.restore_checkpoint = restore
        torch.cuda.synchronize()
    print(f"(16b) Mixtral-8x7B width, {MIXTRAL_CKPT_LAYERS} layer(s): 2 steps "
          f"and a save of {n_bytes / 1e9:.1f} GB of state in {save_s:.1f} s;"
          f" restore in {checked.get('restore_s', 0.0):.1f} s at step "
          f"{checked.get('step')}, tensors differing: {checked.get('bad')};"
          f" resumed losses {[r['loss'] for r in again.history]}")
    if checked.get("bad") or checked.get("step") != 2:
        raise AssertionError(f"(16b) the restored state differs: {checked}")
    if len(again.history) != 2 or not math.isfinite(
            again.history[-1]["loss"]):
        raise AssertionError(f"(16b) the resumed run: {again.history}")
    stats.update(layers=MIXTRAL_CKPT_LAYERS, state_bytes=n_bytes,
                 run_and_save_s=save_s, restore_s=checked["restore_s"],
                 resumed=[r["loss"] for r in again.history])
    del again
    torch.cuda.empty_cache()
    return stats


def _mixtral_serve(device, seed):
    """(16c) Mixtral-8x7B width at ``MIXTRAL_SERVE_LAYERS`` layers, seeded
    bf16, drop-free: the paged engine at phase 4's request mix
    (``_family_serve``'s checks: B4 launches ticks x layers), then
    ``generate`` over 8 x 256 + 32 greedy tokens against an uncached
    forward (which launches the flash forward once a layer): at least
    ``MIXTRAL_GREEDY_SHARE`` of the greedy tokens within
    ``GREEDY_MARGIN`` of the argmax, in both."""
    import dataclasses as dc

    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch import MixtralConfig

    cfg = dc.replace(MixtralConfig.mixtral_8x7b(),
                     num_layers=MIXTRAL_SERVE_LAYERS)
    out = {}
    counts, out["engine"] = _family_serve(device, seed, "mixtral_8x7b", cfg,
                                          min_share=MIXTRAL_GREEDY_SHARE)
    from pytorch_distributed_tpu_torch import MixtralForCausalLM

    model = MixtralForCausalLM(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    model.requires_grad_(False)
    rng = np.random.default_rng(seed + 19)
    prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (MIXTRAL_GEN_ROWS, MIXTRAL_GEN_PROMPT))).to(device)
    kernel_counts(reset=True)
    gen_out, pre_ms, dec_ms, tok_s = _decode_times(model, prompt, None,
                                                   MIXTRAL_GEN_NEW)
    gen_counts = kernel_counts()
    off_path(gen_counts, ())   # decode attends on the einsum path
    kernel_counts(reset=True)
    with torch.no_grad():
        logits = model(gen_out[:, :-1])[:, MIXTRAL_GEN_PROMPT - 1:]
    fwd_counts = kernel_counts()
    off_path(fwd_counts, ("flash_fwd",))
    if fwd_counts["flash_fwd"] != cfg.num_layers:
        raise AssertionError(f"(16c) the uncached forward launched "
                             f"{fwd_counts} (want flash_fwd x "
                             f"{cfg.num_layers})")
    if not torch.isfinite(logits).all():
        raise AssertionError("(16c) non-finite logits")
    toks = gen_out[:, MIXTRAL_GEN_PROMPT:]
    gaps = (logits.max(-1).values
            - logits.gather(2, toks[..., None])[..., 0]).flatten()
    exact = int((logits.argmax(-1) == toks).sum())
    worst = float(gaps.max())
    within = float((gaps <= GREEDY_MARGIN).float().mean())
    print(f"(16c) Mixtral-8x7B width, {cfg.num_layers} layers, bf16, "
          f"drop-free: generate {MIXTRAL_GEN_ROWS} x {MIXTRAL_GEN_PROMPT} + "
          f"{MIXTRAL_GEN_NEW}: prefill {pre_ms:.2f} ms, decode {dec_ms:.2f} "
          f"ms a token, {tok_s:.1f} tokens/s (launches {gen_counts}); the "
          f"uncached forward launched {fwd_counts}; greedy vs it "
          f"{exact}/{toks.numel()} exact, worst gap {worst:.4f}, "
          f"{within:.3f} within the margin {GREEDY_MARGIN}")
    if within < MIXTRAL_GREEDY_SHARE:
        raise AssertionError(f"(16c) {within:.3f} of generate's greedy "
                             f"tokens within {GREEDY_MARGIN} of the "
                             f"uncached forward's argmax")
    out["generate"] = dict(prefill_ms=pre_ms, decode_ms_per_token=dec_ms,
                           tokens_per_s=tok_s, launches=gen_counts,
                           greedy_exact=exact, greedy_tokens=toks.numel(),
                           greedy_worst_gap=worst,
                           greedy_within_margin=within)
    del model
    torch.cuda.empty_cache()
    return out, counts, fwd_counts


def _moe_layer_check(device, seed):
    """(16d) ``MoEMLP`` at Mixtral's widths (4096 -> 8 x 14336, top-2,
    SwiGLU) in f32 on the card against itself on the CPU, drop-free and
    at capacity 1.25 on the same weights and ``MOE_CHECK_TOKENS`` tokens:
    the kept ``(t, k)`` pairs and slots equal, the outputs within
    ``MOE_CHECK_RTOL`` of their largest magnitude, the load losses too;
    and the layer's card ms at each dispatch."""
    import torch

    from pytorch_distributed_tpu_torch.ops import moe
    from pytorch_distributed_tpu_torch.runtime.precision import Policy

    D, E, Fd = 4096, 8, 14336
    gen = torch.Generator().manual_seed(seed + 20)
    cpu = moe.MoEMLP(D, E, Fd, k=2, capacity_factor=None,
                     activation="swiglu", policy=Policy.full(), device="cpu")
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    x = torch.randn(1, MOE_CHECK_TOKENS, D, generator=gen)
    card = moe.MoEMLP(D, E, Fd, k=2, capacity_factor=None,
                      activation="swiglu", policy=Policy.full(),
                      device=device)
    card.load_state_dict(cpu.state_dict())
    xc = x.to(device)
    out = {}
    kernel_counts(reset=True)
    for name, cf in (("dropfree", None), ("cf1.25", 1.25)):
        cpu.capacity_factor = card.capacity_factor = cf
        with torch.no_grad():
            want, want_aux = cpu(x)
            got, got_aux = card(xc)
            logits = x[0] @ cpu.router.weight.t()
            r_cpu = moe.route(logits, 2, cf)
            r_card = moe.route(xc[0] @ card.router.weight.t(), 2, cf)
            ms = _time_ms(lambda: card(xc), 5)
        same_idx = torch.equal(r_cpu[2], r_card[2].cpu())
        same_kept = torch.equal(r_cpu[4], r_card[4].cpu()) and (
            cf is None or torch.equal(r_cpu[3], r_card[3].cpu()))
        err = (got.cpu() - want).abs().max().item()
        scale = want.abs().max().item()
        aux_err = abs(got_aux.item() - want_aux.item())
        out[name] = dict(max_abs_err=err, scale=scale, aux_err=aux_err,
                         same_experts=same_idx, same_kept=same_kept,
                         ms=ms)
        print(f"(16d) MoEMLP {name}, {MOE_CHECK_TOKENS} tokens at 4096 -> 8 "
              f"x 14336, f32: card vs CPU max|diff| {err:.3e} of "
              f"{scale:.3e}, load loss {aux_err:.3e}, experts equal "
              f"{same_idx}, kept pairs and slots equal {same_kept}; "
              f"{ms:.3f} ms a call on the card")
        if not (same_idx and same_kept and err <= MOE_CHECK_RTOL * scale
                and aux_err <= MOE_CHECK_RTOL * abs(want_aux.item())):
            raise AssertionError(f"(16d) MoEMLP {name} on the card differs "
                                 f"from the CPU: {out[name]}")
    counts = kernel_counts()
    off_path(counts, ())
    del card, cpu
    torch.cuda.empty_cache()
    return out, counts


def moe_vit_phase(device, seed):
    """Phase 16: (16a) the ViT-B/16 recipe and B1-B3 at its shape, (16b)
    Mixtral-8x7B training and its checkpoint round trip, (16c) its
    generate and paged engine, (16d) one MoE layer card vs CPU. Returns
    (stats, launches by path)."""
    t0 = time.perf_counter()
    stats, by_path = {}, {}
    stats["vit"], by_path["vit_recipe"] = _vit_phase(device, seed)
    stats["mixtral_train"], by_path["mixtral_train"] = _mixtral_train(
        device, seed)
    stats["mixtral_ckpt"] = _mixtral_ckpt(device, seed)
    stats["mixtral_serve"], by_path["mixtral_serve"], \
        by_path["mixtral_forward"] = _mixtral_serve(device, seed)
    stats["moe_layer"], by_path["moe_layer"] = _moe_layer_check(device, seed)
    stats["wall_s"] = time.perf_counter() - t0
    print(f"(16) phase 16 in {stats['wall_s']:.1f} s")
    return stats, by_path


# -- 17. T5-base and the seq2seq recipe --------------------------------------

# T5-base at its published widths (the JAX ``T5Config.base()``: d_model
# 768, 12 + 12 layers, 12 heads of 64, d_ff 3072, vocab 32128, relu,
# tied), dropout off as the recipe runs it (attention-weight dropout
# would keep the cross-attention off the flash kernels)
T5_BATCH, T5_ENC, T5_DEC, T5_STEPS, T5_LR = 16, 512, 128, 6, 1e-4
T5_LENGTHS = (256, 512)   # the encoder rows' real lengths, seeded
# B1-B3 at T5-base's cross-attention: 16 x 128 decoder queries over 512
# encoder keys, key-padded, 12 heads of 64, unscaled logits
T5_FLASH_SHAPE = dict(B=16, S=128, T=512, Hq=12, Hkv=12, D=64)
T5_FLASH_EXTRAS = {"lengths": T5_LENGTHS, "sm_scale": 1.0}
T5_GEN_ROWS, T5_GEN_NEW = 16, 64
# greedy tokens against the teacher-forced forward: T5-base's seeded
# logits are small (the head multiplies a d_model ** -0.5 scaled state by
# a table of std d_model ** -0.5: a std near 0.04), so the margin is a
# share of each position's logit spread (its std over the vocab), and at
# least T5_GREEDY_SHARE of the tokens must fall within it
T5_GREEDY_MARGIN, T5_GREEDY_SHARE = 0.25, 0.9
# (17d) the recipe at its docstring's flags. The JAX recipe at the same
# flags on the CPU read exact-match 0.000 and token-match 0.222 (its
# docstring claims ~1.0): the exact-match bar is that less 0.05, so it
# cannot fail; what tells a working generation from a broken one is the
# token-match, which must reach T5_TOKEN_BAR (the port read 0.219 on the
# card and 0.163 on the CPU; a greedy decode that has lost its cache or
# its positions reads near chance, 1/62 over ids 2-63). The logged loss
# must also fall below half its first value (the JAX run: 4.16 -> 0.69)
T5_RECIPE = ["--size", "tiny", "--epochs", "50", "--steps-per-epoch", "30",
             "--log-every", "30"]
T5_JAX_EXACT = 0.0
T5_RECIPE_BAR = T5_JAX_EXACT - 0.05
T5_TOKEN_BAR = 0.1
# (17e) T5-base's HF round trip: f32 on the CPU and on the card (TF32
# off). Seeded T5-base is ill-conditioned in f32 (unscaled logits of std
# ~8 give near one-hot softmaxes over 24 layers): one ulp of noise on
# every weight moves its logits by ~2e-4 of their largest, which the
# phase measures on the CPU (the floor); the card's logits must lie
# within T5_HF_FLOORS floors of the CPU's (a wrong mask or kernel reads
# a share of 1). The floor itself must stay under T5_HF_FLOOR_CAP of the
# largest logit (it read 1.6e-4), so that a model grown more
# ill-conditioned cannot loosen its own check
T5_HF_ROWS, T5_HF_ENC, T5_HF_DEC, T5_HF_FLOORS = 2, 64, 16, 3.0
T5_HF_FLOOR_CAP = 1e-3


def _t5_cfg():
    import dataclasses as dc

    from pytorch_distributed_tpu_torch import T5Config

    return dc.replace(T5Config.base(), dropout_rate=0.0)


def _t5_base(device, seed, policy):
    """``(cfg, model)``: T5-base on ``device`` with seeded weights."""
    import torch

    from pytorch_distributed_tpu_torch import T5ForConditionalGeneration

    cfg = _t5_cfg()
    model = T5ForConditionalGeneration(cfg, device=device, policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return cfg, model


def _t5_rows(seed, rows, vocab):
    """Encoder ids with a seeded real length per row (the rest padding,
    its mask False), label ids of ``T5_DEC`` tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    enc = rng.integers(2, vocab, (rows, T5_ENC))
    lengths = rng.integers(T5_LENGTHS[0], T5_LENGTHS[1] + 1, rows)
    mask = np.arange(T5_ENC)[None, :] < lengths[:, None]
    enc = np.where(mask, enc, 0)
    labels = rng.integers(2, vocab, (rows, T5_DEC))
    return enc, mask, labels


def _t5_train(device, seed):
    """(17a) T5-base through the Trainer: ``seq2seq_lm_loss_fn``, the
    recipe's clip + AdamW, ``T5_STEPS`` steps of one repeated batch of
    ``T5_BATCH`` x ``T5_ENC`` encoder tokens (padded rows) and
    ``T5_DEC`` labels: finite losses that fall; B1, B2 and B3 launch 12
    a step (each decoder layer's cross-attention), B4 never."""
    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch import (
        ArrayDataset,
        DataLoader,
        DataParallel,
        MeshSpec,
        Policy,
        Trainer,
        TrainerConfig,
        TrainState,
        build_train_step,
        seq2seq_lm_loss_fn,
        t5_partition_rules,
    )
    from pytorch_distributed_tpu_torch.optim import AdamW, clip_grad_norm
    from pytorch_distributed_tpu_torch.recipes import t5_seq2seq

    enc, mask, labels = _t5_rows(seed + 21, T5_BATCH, 32128)
    ds = ArrayDataset(input_ids=enc.astype(np.int32),
                      input_mask=mask, labels=labels.astype(np.int32),
                      label_mask=np.ones_like(labels, dtype=bool))
    with _World1(device):
        _reset_peak(device)
        strategy = DataParallel(device, mesh_spec=MeshSpec(dp=1),
                                extra_rules=t5_partition_rules())
        cfg = _t5_cfg()
        model, net = t5_seq2seq.build_model(cfg, strategy, device, seed,
                                            Policy.train())
        opt = clip_grad_norm(AdamW(model, lr=T5_LR, weight_decay=
                                   t5_seq2seq.ADAMW_WEIGHT_DECAY), 1.0)
        trainer = Trainer(
            TrainState(net, opt, policy=Policy.train()),
            build_train_step(seq2seq_lm_loss_fn(net)),
            DataLoader(ds, T5_BATCH, shuffle=False,
                       sharding=strategy.batch_sharding()),
            config=TrainerConfig(epochs=T5_STEPS, log_every=1,
                                 samples_axis="input_ids"))
        kernel_counts(reset=True)
        t0 = time.perf_counter()
        trainer.fit()   # the main path
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        peak = _peak_gib(device)
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    step_ms = _median_ms(hist)
    # real tokens (each row's unpadded encoder length plus its labels),
    # and every position the step computes, padding included
    tokens = int(mask.sum()) + labels.size
    padded = T5_BATCH * (T5_ENC + T5_DEC)
    want = {k: cfg.num_layers * T5_STEPS for k in FLASH}
    got = {k: counts[k] for k in FLASH}
    stats = dict(params=sum(p.numel() for p in model.parameters()),
                 losses=losses, step_ms=[1e3 * r["step_time_s"] for r in hist],
                 step_ms_median=step_ms, tokens_per_s=tokens / step_ms * 1e3,
                 padded_positions_per_s=padded / step_ms * 1e3,
                 peak_mem_gib=peak, wall_s=wall, launches=counts)
    print(f"(17a) T5-base ({stats['params']} params), batch {T5_BATCH} x "
          f"{T5_ENC} encoder (real lengths {T5_LENGTHS}) + {T5_DEC} decoder "
          f"tokens, clip + AdamW: {T5_STEPS} steps in {wall:.1f} s, step ms "
          + " ".join(f"{x:.1f}" for x in stats["step_ms"])
          + f", median {step_ms:.2f} = {stats['tokens_per_s']:.0f} tokens/s "
          f"({tokens} real encoder + decoder tokens a step; "
          f"{stats['padded_positions_per_s']:.0f} positions/s with the "
          f"padding), peak {peak:.2f} GiB; losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; launches {counts} (want {want})")
    if len(losses) != T5_STEPS or not all(map(math.isfinite, losses)) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"(17a) T5-base losses {losses}")
    if got != want:
        raise AssertionError(f"(17a) flash launches {got} != {want}")
    off_path(counts, FLASH)
    stats["head"] = _t5_head_ms(model, cfg, device, seed)
    del trainer, model, net, opt
    torch.cuda.empty_cache()
    return stats, counts


def _t5_head_ms(model, cfg, device, seed):
    """The tied head alone at 17a's decoder shape: ``[T5_BATCH *
    T5_DEC, d_model]`` bf16 states scaled and projected through the f32
    table (TF32 off, as the model runs it), forward and forward +
    backward, beside the bound (f32 products on the CUDA cores)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed + 26)
    x = torch.randn(T5_BATCH, T5_DEC, cfg.d_model, generator=gen,
                    device=device, dtype=torch.bfloat16).requires_grad_()
    table = model.shared.weight
    gout = torch.randn(T5_BATCH, T5_DEC, cfg.vocab_size, generator=gen,
                       device=device)
    with torch.no_grad():
        fwd = _time_ms(lambda: model._head(x), 10)
    both = _time_ms(lambda: torch.autograd.grad(model._head(x), (x, table),
                                                gout), 10)
    N, D, V = T5_BATCH * T5_DEC, cfg.d_model, cfg.vocab_size
    flops = 2 * N * D * V
    nbytes = 4 * (D * V + N * V) + 2 * N * D
    bound = max(flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    print(f"(17a) the tied f32 head, [{N}, {D}] x [{D}, {V}]: forward "
          f"{fwd:.3f} ms, forward + backward {both:.3f} ms; the forward's "
          f"bound {bound:.3f} ms ({flops} flops at the f32 CUDA-core peak, "
          f"{nbytes} bytes)")
    return dict(forward_ms=fwd, forward_backward_ms=both,
                forward_bound_ms=bound)


def _t5_flash(device, seed):
    """(17b) B1-B3 at T5-base's cross-attention shape against their plain
    versions at phase 3's limits, timed beside SDPA and the bound."""
    import torch

    gen = torch.Generator().manual_seed(seed + 22)
    rows = _flash_check(gen, seed, "t5_cross", T5_FLASH_SHAPE, False,
                        T5_FLASH_EXTRAS, "bfloat16", device)
    bad = [c for c in rows if not c["ok"]]
    if bad:
        raise AssertionError(f"(17b) flash kernels disagree with plain at "
                             f"T5's cross-attention shape: {bad}")
    worst = {r["what"]: r["max_abs_err"] for r in rows}
    gen = torch.Generator().manual_seed(seed + 22)
    records, details = _flash_times(
        gen, seed, T5_FLASH_SHAPE, device, worst, causal=False,
        extras={"lengths": T5_LENGTHS}, sm_scale=1.0)
    torch.cuda.empty_cache()
    return dict(records={r["name"]: {k: r[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err")} for r in records}, details=details, checks=rows)


def _t5_generate(device, seed):
    """(17c) ``generate_encdec`` at T5-base (seeded, the train policy):
    ``T5_GEN_ROWS`` padded ``T5_ENC``-token inputs, ``T5_GEN_NEW`` greedy
    tokens (the encoder and the 1-token prefill, then each token); the
    tokens against a teacher-forced forward of the same rows, which
    launches B1 once a decoder layer."""
    import torch

    from pytorch_distributed_tpu_torch import (
        Policy,
        generate_encdec,
        shift_right,
    )

    cfg, model = _t5_base(device, seed, Policy.train())
    model.requires_grad_(False)
    enc, mask, _ = _t5_rows(seed + 23, T5_GEN_ROWS, cfg.vocab_size)
    enc = torch.from_numpy(enc).to(device)
    mask = torch.from_numpy(mask).to(device)
    kernel_counts(reset=True)
    _, pre_ms = _cuda_ms(lambda: generate_encdec(
        model, enc, max_new_tokens=1, input_mask=mask, eos_id=-1))
    out, ms = _cuda_ms(lambda: generate_encdec(
        model, enc, max_new_tokens=T5_GEN_NEW, input_mask=mask, eos_id=-1))
    gen_counts = kernel_counts()
    off_path(gen_counts, ())   # every decode call is one query: einsum
    dec_ms = (ms - pre_ms) / (T5_GEN_NEW - 1)
    kernel_counts(reset=True)
    with torch.no_grad():
        logits = model(enc, shift_right(out, cfg.pad_token_id),
                       input_mask=mask)
    fwd_counts = kernel_counts()
    off_path(fwd_counts, ("flash_fwd",))
    if fwd_counts["flash_fwd"] != cfg.num_layers:
        raise AssertionError(f"(17c) the teacher-forced forward launched "
                             f"{fwd_counts} (want flash_fwd x "
                             f"{cfg.num_layers})")
    if not torch.isfinite(logits).all():
        raise AssertionError("(17c) non-finite logits")
    spread = logits.float().std(dim=-1)
    gaps = (logits.max(-1).values
            - logits.gather(2, out[..., None])[..., 0]) / spread
    exact = int((logits.argmax(-1) == out).sum())
    within = float((gaps <= T5_GREEDY_MARGIN).float().mean())
    worst = float(gaps.max())
    print(f"(17c) T5-base generate_encdec, {T5_GEN_ROWS} x {T5_ENC} padded "
          f"inputs, {T5_GEN_NEW} greedy tokens: encoder + first token "
          f"{pre_ms:.2f} ms, decode {dec_ms:.2f} ms a token (launches "
          f"{gen_counts}); the teacher-forced forward launched {fwd_counts}; "
          f"greedy vs it {exact}/{out.numel()} exact, worst gap "
          f"{worst:.4f} of the logits' spread (median spread "
          f"{float(spread.median()):.4f}), {within:.3f} within "
          f"{T5_GREEDY_MARGIN} of it")
    if within < T5_GREEDY_SHARE:
        raise AssertionError(f"(17c) {within:.3f} of the greedy tokens "
                             f"within {T5_GREEDY_MARGIN} spreads of the "
                             f"teacher-forced argmax")
    stats = dict(prefill_ms=pre_ms, decode_ms_per_token=dec_ms,
                 tokens_per_s=T5_GEN_ROWS * T5_GEN_NEW / ms * 1e3,
                 launches=gen_counts, greedy_exact=exact,
                 greedy_tokens=out.numel(), greedy_worst_gap_spreads=worst,
                 greedy_within_margin=within,
                 logit_spread_median=float(spread.median()))
    del model
    torch.cuda.empty_cache()
    return stats, gen_counts, fwd_counts


def _t5_recipe(device, seed):
    """(17d) the port's recipe through its ``main``: at ``T5_RECIPE``
    (exact-match at or above ``T5_RECIPE_BAR``, token-match at or above
    ``T5_TOKEN_BAR``, the logged loss below half its first); then
    ``--size small --steps-per-epoch 3`` with a checkpoint and a second
    run that restores it and trains epoch 2."""
    import tempfile

    import torch

    from pytorch_distributed_tpu_torch.recipes import t5_seq2seq

    out, paths = {}, {}
    with _World1(device):
        kernel_counts(reset=True)
        t0 = time.perf_counter()
        trainer = t5_seq2seq.main(T5_RECIPE + ["--seed", str(seed)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paths["t5_recipe"] = counts = kernel_counts()
    losses = [r["loss"] for r in trainer.history]
    rates = trainer.seq2seq
    out["tiny"] = dict(argv=T5_RECIPE, wall_s=wall, losses=losses,
                       step_ms_median=_median_ms(trainer.history),
                       eval=trainer.last_eval_metrics, launches=counts,
                       **rates)
    print(f"(17d) recipes/t5_seq2seq.py {' '.join(T5_RECIPE)}: "
          f"{trainer.state.step} steps in {wall:.1f} s (median logged step "
          f"{out['tiny']['step_ms_median']:.2f} ms), loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, eval {trainer.last_eval_metrics}, exact-match "
          f"{rates['exact_match']:.3f} (bar {T5_RECIPE_BAR:.3f}: the JAX "
          f"recipe's {T5_JAX_EXACT:.3f} less 0.05), token-match "
          f"{rates['token_match']:.3f} (bar {T5_TOKEN_BAR:.3f}) over "
          f"{rates['rows']} rows; launches {counts}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0] / 2
            and rates["exact_match"] >= T5_RECIPE_BAR
            and rates["token_match"] >= T5_TOKEN_BAR):
        raise AssertionError(f"(17d) the recipe: {out['tiny']}")
    off_path(counts, FLASH)
    del trainer
    with tempfile.TemporaryDirectory() as tmp:
        small = ["--size", "small", "--steps-per-epoch", "3", "--log-every",
                 "1", "--ckpt-dir", tmp, "--seed", str(seed)]
        runs = []
        for extra in ([], ["--epochs", "2"]):
            with _World1(device):
                kernel_counts(reset=True)
                t0 = time.perf_counter()
                tr = t5_seq2seq.main(small + extra)
                torch.cuda.synchronize()
                runs.append(dict(wall_s=time.perf_counter() - t0,
                                 steps=[r["step"] for r in tr.history],
                                 losses=[r["loss"] for r in tr.history],
                                 launches=kernel_counts()))
            del tr
    paths["t5_recipe_small"] = runs[0]["launches"]
    paths["t5_recipe_small_resumed"] = runs[1]["launches"]
    out["small"] = runs
    print(f"(17d) --size small --steps-per-epoch 3 --ckpt-dir: steps "
          f"{runs[0]['steps']} (losses "
          + " ".join(f"{x:.4f}" for x in runs[0]["losses"])
          + f", {runs[0]['wall_s']:.1f} s), restored and continued: steps "
          f"{runs[1]['steps']} (losses "
          + " ".join(f"{x:.4f}" for x in runs[1]["losses"])
          + f", {runs[1]['wall_s']:.1f} s)")
    if runs[1]["steps"] != [4, 5, 6] or not all(
            math.isfinite(x) for r in runs for x in r["losses"]):
        raise AssertionError(f"(17d) the small run's restore: {runs}")
    for r in runs:
        off_path(r["launches"], FLASH)
    torch.cuda.empty_cache()
    return out, paths


def _t5_hf(device, seed):
    """(17e) T5-base's HF layout: ``export_t5_weights`` then
    ``load_t5_weights`` give the state back bit for bit; the loaded
    weights on the CPU and on the card (f32, TF32 off) give logits within
    ``T5_HF_FLOORS`` times the CPU model's one-ulp floor of each other on
    ``T5_HF_ROWS`` rows (one padded)."""
    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch import (
        Policy,
        T5ForConditionalGeneration,
        export_t5_weights,
        load_t5_weights,
    )

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        cfg, card = _t5_base(device, seed, Policy.full())
        sd = card.state_dict()
        back = load_t5_weights(export_t5_weights(sd, cfg), cfg)
        same = sorted(back) == sorted(sd) and all(
            torch.equal(back[k], sd[k].cpu()) for k in sd)
        cpu = T5ForConditionalGeneration(cfg, device="meta",
                                         policy=Policy.full())
        cpu.load_state_dict(back, assign=True)
        rng = np.random.default_rng(seed + 24)
        enc = torch.from_numpy(rng.integers(2, cfg.vocab_size,
                                            (T5_HF_ROWS, T5_HF_ENC)))
        dec = torch.from_numpy(rng.integers(2, cfg.vocab_size,
                                            (T5_HF_ROWS, T5_HF_DEC)))
        mask = torch.ones(T5_HF_ROWS, T5_HF_ENC, dtype=torch.bool)
        mask[1, T5_HF_ENC // 2:] = False
        kernel_counts(reset=True)
        with torch.no_grad():
            ref = cpu(enc, dec, input_mask=mask)
            got = card(enc.to(device), dec.to(device),
                       input_mask=mask.to(device)).cpu()
        counts = kernel_counts()
        # the floor: every CPU weight times 1 +- 2^-24 (seeded signs)
        gen = torch.Generator().manual_seed(seed + 25)
        with torch.no_grad():
            for p in cpu.parameters():
                sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
                p.mul_(1 + sign * 2.0 ** -24)
            noisy = cpu(enc, dec, input_mask=mask)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    floor = (noisy - ref).abs().max().item()
    print(f"(17e) T5-base HF round trip: export then load bitwise equal "
          f"{same}; card vs CPU logits (f32, {T5_HF_ROWS} rows) max|err| "
          f"{err:.3e} of max|ref| {scale:.4f} ({err / scale:.3e}); one ulp "
          f"of weight noise on the CPU moves them {floor:.3e} "
          f"({floor / scale:.3e}, cap {T5_HF_FLOOR_CAP:g}); limit "
          f"{T5_HF_FLOORS:g} x that; {time.perf_counter() - t0:.1f} s; "
          f"launches {counts}")
    if not (same and err <= T5_HF_FLOORS * floor
            and floor <= T5_HF_FLOOR_CAP * scale):
        raise AssertionError(f"(17e) T5-base HF: bitwise {same}, logits "
                             f"{err} vs {T5_HF_FLOORS * floor}, floor "
                             f"{floor / scale} of the largest logit (cap "
                             f"{T5_HF_FLOOR_CAP})")
    off_path(counts, ("flash_fwd",))
    del card, cpu, sd, back
    torch.cuda.empty_cache()
    return dict(export_load_bitwise=same, max_abs_err=err,
                max_abs_ref=scale, one_ulp_floor=floor), counts


def t5_phase(device, seed):
    """Phase 17: (17a) T5-base training, (17b) B1-B3 at its
    cross-attention shape, (17c) its ``generate_encdec``, (17d) the
    recipe, (17e) its HF layout. Returns (stats, launches by path)."""
    t0 = time.perf_counter()
    stats, by_path = {}, {}
    stats["train"], by_path["t5_train"] = _t5_train(device, seed)
    stats["flash"] = _t5_flash(device, seed)
    stats["generate"], by_path["t5_generate"], by_path["t5_forced"] = \
        _t5_generate(device, seed)
    stats["recipe"], paths = _t5_recipe(device, seed)
    by_path.update(paths)
    stats["hf"], by_path["t5_hf"] = _t5_hf(device, seed)
    stats["wall_s"] = time.perf_counter() - t0
    print(f"(17) phase 17 in {stats['wall_s']:.1f} s")
    return stats, by_path


# -- 18. pipeline parallelism ---------------------------------------------

# (18a) the host 1F1B executor at GPT-2-medium's full width and depth:
# two stage processes of 12 + 12 layers on the one card, 4 microbatches
# of 2 x 1024 a step, SGD on one repeated batch (so the loss must fall)
PP_STEPS = 3
PP_MICRO, PP_ROWS, PP_SEQ = 4, 2, 1024
PP_DEPTHS = (12, 12)
PP_LR = 0.1
# the pipeline against the solo executor on the same weights and batch:
# every block, fold and hand-off is the solo run's arithmetic in the same
# order (the backward's recompute replays the deterministic flash
# forward); only the tied head's gradient joins the embedding's across
# stages (the solo backward sums the two inside autograd), so wte moves
# by f32 last bits: the card read the losses equal and the parameters
# 5.1e-9 of their largest apart (NVIDIA H100 80GB HBM3, 700 W); a later
# bf16 product that rounds otherwise would move them by ~1e-7
PP_LOSS_RTOL = 1e-6
PP_PARAM_RTOL = 1e-6
# (18b) the GPipe form at one stage against causal_lm_loss_fn through the
# Trainer, clip + AdamW(3e-4): the same f32 loss summed in another order,
# and the microbatches' gradients summed by autograd in one graph rather
# than over four; AdamW's first steps move a weight by ~lr whatever its
# gradient's size, so rounding noise in a gradient that is zero in exact
# arithmetic (the key bias's) becomes +-lr moves: the card read 1.4e-5
# over 3 steps (NVIDIA H100 80GB HBM3, 700 W)
GPIPE_LOSS_RTOL = 1e-4


def _pp_batch(seed):
    """(18a)'s one batch: 8 x 1024 seeded token ids."""
    import numpy as np

    rng = np.random.default_rng(seed + 18)
    return {"input_ids": rng.integers(0, 50257, (PP_MICRO * PP_ROWS,
                                                 PP_SEQ)).astype(np.int64)}


def _pp_executor(device, seed, stage, num_stages, link, depths):
    """GPT-2-medium's stage ``stage`` of ``num_stages`` (``Policy.train()``,
    seeded whole and then sliced) in ``HostPipelineStep`` with SGD:
    ``(executor, stage module, buffers)``."""
    import torch

    from pytorch_distributed_tpu_torch import (
        GPT2Config,
        GPT2LMHead,
        HostPipelineStep,
        Policy,
        optim,
    )
    from pytorch_distributed_tpu_torch.parallel.pipeline_lm import (
        GPT2HostStagePrograms,
        host_act_template,
        host_stage_params,
    )

    policy = Policy.train()
    model = GPT2LMHead(GPT2Config.medium(), device=device, policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    module, buffers = host_stage_params(model, stage=stage,
                                        num_stages=num_stages, depths=depths)
    del model
    host = HostPipelineStep(
        GPT2HostStagePrograms(module, stage=stage, num_stages=num_stages),
        stage=stage, num_stages=num_stages, num_microbatches=PP_MICRO,
        optimizer=optim.SGD(module, lr=PP_LR), group=link,
        act_template=host_act_template(module.config, PP_ROWS, PP_SEQ,
                                       policy.compute_dtype))
    return host, module, buffers


def _pp_steps(host, buffers, batch, device):
    """``PP_STEPS`` executor steps, kernel counts set to 0 just before and
    read just after: (losses, counts, ms of each step; the first pays
    the process's warm-up)."""
    import torch

    torch.cuda.synchronize(device)
    kernel_counts(reset=True)
    losses, ms = [], []
    for _ in range(PP_STEPS):
        t0 = time.perf_counter()
        losses.append(host.step(batch, buffers).get("loss"))
        torch.cuda.synchronize(device)
        ms.append(1e3 * (time.perf_counter() - t0))
    return losses, kernel_counts(), ms


def _pp_stage(rank, port, seed, out, done):
    """One stage process of (18a) on card 0, linked to the other over a
    gloo group: the pipelined run, then the control without the tied
    gradient's exchange. Its final tensors go to the parent as CUDA
    tensors (shared, not copied), kept alive until ``done``."""
    import traceback

    import torch

    from pytorch_distributed_tpu_torch import (
        StageLink,
        destroy_process_group,
        init_process_group,
    )
    from pytorch_distributed_tpu_torch.ops import kernel_build

    try:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        kernel_build.build(["flash_attention"])   # the parent's build
        init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                           world_size=2, rank=rank, device="cpu")
        link = StageLink()
        res = {}
        batch = _pp_batch(seed)
        for name in ("pipelined", "control"):
            host, module, buffers = _pp_executor(device, seed, rank, 2, link,
                                                 PP_DEPTHS)
            if name == "control":
                host.programs.exchange_grads = None
            losses, counts, ms = _pp_steps(host, buffers, batch, device)
            res[name] = dict(
                losses=losses, counts=counts, step_ms=ms,
                start=module.start,
                tensors={n: t.detach() for n, t in
                         module.state_dict().items()},
                head_wte=buffers.get("head_wte"))
        out.put((rank, res))
        done.wait(600)
        destroy_process_group()
    except Exception:   # reported to the parent, which fails the phase
        out.put((rank, traceback.format_exc()))


def _pp_merged(stages):
    """The whole model's tensors from the stage processes' results."""
    merged = {}
    for res in stages:
        for n, t in res["tensors"].items():
            if n.startswith("blocks."):
                i, sub = n[len("blocks."):].split(".", 1)
                n = f"blocks.{res['start'] + int(i)}.{sub}"
            merged[n] = t
    return merged


def _pp_rel(got, want):
    """max over tensors of max|got - want| / max|want| (f32)."""
    worst = 0.0
    for n, w in want.items():
        w = w.float()
        err = (got[n].float() - w).abs().max() / w.abs().max()
        worst = max(worst, float(err))
    return worst


def _pp_compare(got, solo, solo_losses):
    """(18a)'s readings of the stage processes' results against the solo
    run's: every reference to their shared tensors ends with this call."""
    import torch

    for r, res in got.items():
        if isinstance(res, str):
            raise AssertionError(f"(18a) stage {r} failed:\n{res}")
    stats = {}
    for name in ("pipelined", "control"):
        s0, s1 = got[0][name], got[1][name]
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(s1["losses"], solo_losses))
        stats[name] = dict(
            losses=s1["losses"], loss_rel_err=loss_err,
            param_rel_err=_pp_rel(_pp_merged([s0, s1]), solo),
            step_ms=[s0["step_ms"], s1["step_ms"]],
            counts=[s0["counts"], s1["counts"]],
            head_wte_equal=bool(torch.equal(s1["head_wte"],
                                            s0["tensors"]["wte.weight"])))
    return stats


def _pp_host(device, seed):
    """(18a): the solo executor here, then the two stage processes."""
    import gc

    import torch
    import torch.multiprocessing as tmp

    host, module, buffers = _pp_executor(device, seed, 0, 1, None, None)
    solo_losses, solo_counts, solo_ms = _pp_steps(host, buffers,
                                                  _pp_batch(seed), device)
    solo = {n: t.detach() for n, t in module.state_dict().items()}
    del host
    ctx = tmp.get_context("spawn")
    out, done = ctx.Queue(), ctx.Event()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_pp_stage, args=(r, port, seed, out, done))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        stats = _pp_compare(dict(out.get(timeout=600) for _ in procs), solo,
                            solo_losses)
        wall = time.perf_counter() - t0
        stats.update(solo=dict(losses=solo_losses, step_ms=solo_ms,
                               counts=solo_counts), stages_wall_s=wall)
    finally:
        done.set()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    del solo, module, buffers
    gc.collect()
    torch.cuda.empty_cache()
    pl, ctl = stats["pipelined"], stats["control"]
    print(f"(18a) host 1F1B, GPT-2-medium, stages {PP_DEPTHS} on one card "
          f"over gloo, {PP_MICRO} x {PP_ROWS} x {PP_SEQ} a step, "
          f"SGD({PP_LR}): solo losses {solo_losses}, ms by step "
          f"{[round(x, 1) for x in solo_ms]}, launches {solo_counts}; "
          f"pipelined "
          f"losses {pl['losses']} (max rel {pl['loss_rel_err']:.3e}, limit "
          f"{PP_LOSS_RTOL:g}), parameters within {pl['param_rel_err']:.3e} "
          f"of solo's (limit {PP_PARAM_RTOL:g}), head_wte == stage 0's wte "
          f"{pl['head_wte_equal']}, ms by step, by stage "
          f"{[[round(x, 1) for x in ms] for ms in pl['step_ms']]}, "
          f"launches by stage {pl['counts']}; control without the tied "
          f"gradient's exchange: parameters {ctl['param_rel_err']:.3e}, "
          f"losses {ctl['losses']}; stage processes {wall:.1f} s")
    steps = PP_STEPS * PP_MICRO
    want = dict(
        pp_host_solo=dict(flash_fwd=24 * steps, flash_dq=24 * steps,
                          flash_dkv=24 * steps),
        # a non-last stage recomputes its forward in its backward
        pp_host_stage0=dict(flash_fwd=2 * 12 * steps, flash_dq=12 * steps,
                            flash_dkv=12 * steps),
        pp_host_stage1=dict(flash_fwd=12 * steps, flash_dq=12 * steps,
                            flash_dkv=12 * steps))
    by_path = dict(pp_host_solo=solo_counts,
                   pp_host_stage0=pl["counts"][0],
                   pp_host_stage1=pl["counts"][1])
    for path, counts in by_path.items():
        got = {k: counts[k] for k in FLASH}
        if got != want[path]:
            raise AssertionError(f"(18a) {path}: launches {got}, expected "
                                 f"{want[path]}")
        off_path(counts, FLASH)
    if not (all(map(math.isfinite, solo_losses))
            and solo_losses[-1] < solo_losses[0]):
        raise AssertionError(f"(18a) solo losses {solo_losses} do not fall")
    if not (len(pl["losses"]) == PP_STEPS
            and pl["loss_rel_err"] <= PP_LOSS_RTOL
            and pl["losses"][-1] < pl["losses"][0]):
        raise AssertionError(f"(18a) pipelined losses {pl['losses']} vs "
                             f"solo {solo_losses}")
    if not (pl["param_rel_err"] <= PP_PARAM_RTOL and pl["head_wte_equal"]):
        raise AssertionError(f"(18a) pipelined parameters "
                             f"{pl['param_rel_err']:.3e} from solo's, "
                             f"head_wte equal {pl['head_wte_equal']}")
    if not ctl["param_rel_err"] > PP_PARAM_RTOL:
        raise AssertionError(f"(18a) the control without the tied exchange "
                             f"reads {ctl['param_rel_err']:.3e} <= "
                             f"{PP_PARAM_RTOL}: the limit cannot see it")
    return stats, by_path


def _pp_gpipe(device, seed):
    """(18b): ``pipelined_causal_lm_loss_fn`` under ``PipelineParallel``
    at one stage through the Trainer, against ``causal_lm_loss_fn`` on
    the same weights and batches, in a NCCL world of one."""
    import dataclasses as dc
    import gc

    import torch

    from pytorch_distributed_tpu_torch import (
        DataLoader,
        GPT2Config,
        GPT2LMHead,
        MeshSpec,
        PipelineParallel,
        Policy,
        SyntheticTextDataset,
        Trainer,
        TrainerConfig,
        TrainState,
        build_train_step,
        causal_lm_loss_fn,
        optim,
        pipelined_causal_lm_loss_fn,
    )

    cfg = dc.replace(GPT2Config.medium(), dropout_rate=0.0)
    policy = Policy.train()
    runs = {}
    with _World1(device):
        for name in ("pp_gpipe_one_stage", "plain"):
            gen = torch.Generator(device=device).manual_seed(seed)
            if name == "plain":
                model = GPT2LMHead(cfg, device=device, policy=policy)
                model.init_weights(gen)
                loss_fn, accum = causal_lm_loss_fn(model), PP_MICRO
            else:
                strategy = PipelineParallel(device,
                                            mesh_spec=MeshSpec(dp=1, pp=1))
                model = strategy.wrap(GPT2LMHead(cfg, device="meta",
                                                 policy=policy))
                model.init_weights(gen)
                loss_fn = pipelined_causal_lm_loss_fn(
                    model, num_microbatches=PP_MICRO)
                accum = 1
            opt = optim.clip_grad_norm(optim.AdamW(
                model, lr=3e-4, weight_decay=1e-4), 1.0)
            ds = SyntheticTextDataset(n=PP_STEPS * 8, seq_len=PP_SEQ,
                                      vocab_size=cfg.vocab_size, seed=seed)
            trainer = Trainer(
                TrainState(model, opt, policy=policy),
                build_train_step(loss_fn, accum_steps=accum),
                DataLoader(ds, 8, shuffle=False, sharding=device),
                config=TrainerConfig(log_every=1,
                                     max_steps_per_epoch=PP_STEPS))
            _reset_peak(device)
            kernel_counts(reset=True)
            trainer.fit()
            torch.cuda.synchronize(device)
            runs[name] = dict(losses=[r["loss"] for r in trainer.history],
                              step_ms_median=_median_ms(trainer.history),
                              peak_gib=_peak_gib(device),
                              counts=kernel_counts())
            del model, opt, trainer
            gc.collect()
            torch.cuda.empty_cache()
    pp, plain = runs["pp_gpipe_one_stage"], runs["plain"]
    err = max(abs(a - b) / abs(b) for a, b in zip(pp["losses"],
                                                    plain["losses"]))
    pp["loss_rel_err_vs_plain"] = err
    print(f"(18b) GPipe form at one stage through the Trainer, "
          f"GPT-2-medium, {PP_MICRO} x 2 x {PP_SEQ}: losses {pp['losses']} "
          f"against causal_lm_loss_fn's {plain['losses']} (max rel "
          f"{err:.3e}, limit {GPIPE_LOSS_RTOL:g}), {pp['step_ms_median']:.1f}"
          f" ms a step (plain {plain['step_ms_median']:.1f}), peak "
          f"{pp['peak_gib']:.2f} GiB, launches {pp['counts']}")
    n = 24 * PP_MICRO * PP_STEPS
    got = {k: pp["counts"][k] for k in FLASH}
    if got != dict.fromkeys(FLASH, n):
        raise AssertionError(f"(18b) launches {got}, expected {n} each")
    off_path(pp["counts"], FLASH)
    if not (len(pp["losses"]) == PP_STEPS and err <= GPIPE_LOSS_RTOL
            and all(map(math.isfinite, pp["losses"]))):
        raise AssertionError(f"(18b) losses {pp['losses']} vs "
                             f"{plain['losses']}: {err:.3e}")
    return runs, {"pp_gpipe_one_stage": pp["counts"]}


def pp_phase(device, seed):
    """Phase 18: (18a) the host 1F1B executor, (18b) the GPipe form at
    one stage. Returns (stats, launches by path)."""
    t0 = time.perf_counter()
    stats, by_path = _pp_host(device, seed)
    gpipe, paths = _pp_gpipe(device, seed)
    by_path.update(paths)
    stats = dict(host=stats, gpipe=gpipe, wall_s=time.perf_counter() - t0)
    print(f"(18) phase 18 in {stats['wall_s']:.1f} s")
    return stats, by_path


# -- 19. tensor parallelism for GPT-2 and for inference --------------------

# (19a) B4 at Llama-3-8B's per-rank decode tick at tp 2, 4 and 8 (its 32
# query and 8 kv heads over tp): phase 14's tick, 8 rows, 36 pages of 32
TP_PAGED_SHAPES = tuple(
    (f"llama3_8b_tp{t}", dict(B=8, Hq=32 // t, Hkv=8 // t, D=128, ps=32,
                              n=36, max_len=1100))
    for t in (2, 4, 8))
# (19a) B1-B3 at GPT-2-medium's per-rank shape at tp 2: 8 x 1024, 8 of its
# 16 heads of 64, causal, bf16
TP_FLASH_SHAPE = ("gpt2_medium_tp2", dict(B=8, S=1024, T=1024, Hq=8, Hkv=8,
                                          D=64))
def _tp_paged(device, seed):
    """(19a) B4 at ``TP_PAGED_SHAPES`` against ``stream`` and ``gather``
    (bf16 and f32, bitwise over two launches), and at W = 1 its time
    beside its bound, plain version and SDPA."""
    import torch

    gen = torch.Generator().manual_seed(seed + 19)
    out = {}
    for name, shape in TP_PAGED_SHAPES:
        checks, same, inputs = _paged_checks(
            gen, shape, family_paged_cases(shape, None), device,
            label=f"{name} ")
        t = _paged_times(*inputs["decode W=1"], device)
        out[name] = dict(
            max_abs_err=max(c["max_abs_err"] for c in checks
                            if c["case"] == f"{name} decode W=1"
                            and c["dtype"] == "bfloat16"),
            checks=checks, deterministic=same,
            **{k: t[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "bytes",
                                 "flops")})
        print(f"(19a) B4 {name} {shape}: {t['ms']:.5f} ms, bound "
              f"{t['bound_ms']:.5f} ({t['bound_by']}), plain "
              f"{t['plain_ms']:.3f}, SDPA {t['library_ms']:.5f}")
    return out


def _tp_flash(device, seed):
    """(19a) B1-B3 at ``TP_FLASH_SHAPE`` against their plain versions
    (phase 3's limits), timed from CUDA graphs beside SDPA and the
    bound."""
    import torch

    name, shape = TP_FLASH_SHAPE
    gen = torch.Generator().manual_seed(seed + 19)
    rows = _flash_check(gen, seed, name, shape, True, {}, "bfloat16", device)
    bad = [c for c in rows if not c["ok"]]
    if bad:
        raise AssertionError(f"(19a) flash kernels disagree with plain: "
                             f"{bad}")
    worst = {r["what"]: r["max_abs_err"] for r in rows}
    gen = torch.Generator().manual_seed(seed + 19)
    records, details = _flash_times(gen, seed, shape, device, worst)
    out = dict(records={r["name"]: {k: r[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err")} for r in records}, details=details, checks=rows)
    t = out["records"]
    print(f"(19a) {name} {shape}: fwd {t['flash_fwd']['ms']:.4f} ms vs sdpa "
          f"{t['flash_fwd']['library_ms']:.4f}, dq + dkv "
          f"{t['flash_dq']['ms'] + t['flash_dkv']['ms']:.4f} ms vs sdpa "
          f"backward {t['flash_dq']['library_ms']:.4f}")
    torch.cuda.empty_cache()
    return out


def tp_phase(device, seed):
    """Phase 19: B4 and B1-B3 at the TP per-rank shapes (19a). The tp
    paths themselves run on four cards (``scripts/port_tp_scale.py``):
    two gloo ranks on one card crash in DTensor's functional all-gather
    of CUDA tensors (a SIGSEGV in ``_c10d_functional`` all_gather's
    ``wait``), and NCCL takes one rank a card. Returns the stats."""
    t0 = time.perf_counter()
    stats = dict(paged=_tp_paged(device, seed), flash=_tp_flash(device, seed))
    stats["wall_s"] = time.perf_counter() - t0
    print(f"(19) phase 19 in {stats['wall_s']:.1f} s")
    return stats


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
    s11, serve11_paths = serve_gpt2_phase(device, args.seed)
    kernel_counts(reset=True)
    rstats = resnet_phase(device, args.seed)
    # the ResNet path runs none of the four kernels
    rstats["kernel_launches"] = kernel_counts()
    print(f"ResNet path: launches of the four kernels "
          f"{rstats['kernel_launches']} (none on this path)")
    off_path(rstats["kernel_launches"], ())
    istats, image_paths = image_phase(device, args.seed)
    zstats = zero1_phase(device, args.seed)
    gstats, gen_paths = generation_phase(device, args.seed)
    train_counts, tstats = train_phase(device, args.seed, flash_records)
    lstats = llama_phase(device, args.seed)
    bstats = bert_phase(device, args.seed)
    life_stats, life_paths = lifecycle_phase(device, args.seed, lstats)
    fam_stats, fam_paths = family_phase(device, args.seed)
    sp_stats, sp_paths = sp_tp_phase(device, args.seed)
    mv_stats, mv_paths = moe_vit_phase(device, args.seed)
    t5_stats, t5_paths = t5_phase(device, args.seed)
    pp_stats, pp_paths = pp_phase(device, args.seed)
    tp_stats = tp_phase(device, args.seed)
    zt = zstats["train"]
    print(f"GPT-2-medium width, {ZERO_LAYERS} layers, batch 8 x 1024: "
          f"ZeRO-1 + remat + chunked loss "
          f"{zt['step_ms_median']:.2f} ms/step ({zt['loop_step_ms']:.2f} in "
          f"a plain loop), {zt['tokens_per_s']:.0f} tokens/s, peak "
          f"{zt['peak_mem_gib']:.2f} GiB; train phase (no "
          f"remat, full logits, no ZeRO) {tstats['step_ms_median']:.2f} "
          f"ms/step (24 layers), {tstats['tokens_per_s']:.0f} tokens/s, "
          f"peak {tstats['peak_mem_gib']:.2f} GiB")
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
    a13 = life_stats["adafactor"]
    print(f"(13) Llama-3-8B width, {LLAMA_LAYERS} layers, batch "
          f"{LLAMA_BATCH} x {LLAMA_SEQ}: AdamW {lstats['step_ms_median']:.2f}"
          f" ms/step, {lstats['tokens_per_s']:.0f} tokens/s, peak "
          f"{lstats['peak_mem_gib']:.2f} GiB, optimizer state "
          f"{lstats['opt_state_bytes']} bytes; Adafactor "
          f"{a13['step_ms_median']:.2f} ms/step, {a13['tokens_per_s']:.0f} "
          f"tokens/s, peak {a13['peak_mem_gib']:.2f} GiB, optimizer state "
          f"{a13['opt_state_bytes']} bytes")
    rstats["profile"] = resnet_profile(device, args.seed,
                                       rstats["bench"]["step_ms"])
    istats["cifar"]["profile"] = image_profile(device, args.seed, istats)
    cfg_stats, cfg_counts = recipe_config_phase(device, args.seed)
    life_stats["recipe_config"] = cfg_stats
    by_path = dict(serve=serve_counts, resnet=rstats["kernel_launches"],
                   zero1=zt["launches"], train=train_counts,
                   llama=lstats["launches"], bert=bstats["launches"],
                   **gen_paths, **serve11_paths, **image_paths,
                   **life_paths, resnet50_recipe_config=cfg_counts,
                   **fam_paths, **sp_paths, **mv_paths, **t5_paths,
                   **pp_paths)
    print(f"launches by path, each read around its run: {by_path}")
    for rec in [record] + flash_records:
        rec["launches_by_path"] = {path: counts[rec["name"]]
                                   for path, counts in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
    # phase 14's shapes beside each record: B4 at the families' decode
    # ticks, B1-B3 at their training shapes in bf16 and fp16
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    record["at_family_shapes"] = {
        name: {k: t[k] for k in keys}
        for name, t in fam_stats["paged"].items()}
    for rec in flash_records:
        rec["at_family_shapes"] = {
            name: {dname: d["records"][rec["name"]]
                   for dname, d in by_dtype.items()}
            for name, by_dtype in fam_stats["flash"].items()}
        # phase 15's per-rank shapes of TP and Ulysses, bf16
        rec["at_sp_tp_shapes"] = {
            name: d["records"][rec["name"]]
            for name, d in sp_stats["flash"].items()}
        # phase 16's ViT-B/16 shape, bf16, bidirectional
        rec["at_vit_shape"] = mv_stats["vit"]["flash"]["records"][
            rec["name"]]
        # phase 17's T5-base cross-attention shape, bf16, key-padded
        rec["at_t5_shape"] = t5_stats["flash"]["records"][rec["name"]]
        # phase 19's GPT-2-medium per-rank shape at tp 2, bf16 causal
        rec["at_tp_shapes"] = tp_stats["flash"]["records"][rec["name"]]
    # phase 19's Llama-3-8B per-rank decode ticks at tp 2, 4 and 8
    record["at_tp_shapes"] = {name: {k: t[k] for k in keys}
                              for name, t in tp_stats["paged"].items()}

    card = device_info()
    print(json.dumps({"details": dict(kernel=kdetails, flash=fdetails,
                                      train=tstats, serve=stats,
                                      resnet=rstats, zero1=zstats,
                                      llama=lstats, bert=bstats,
                                      generation=gstats,
                                      serve_gpt2=s11, image=istats,
                                      lifecycle=life_stats,
                                      family=fam_stats, sp_tp=sp_stats,
                                      moe_vit=mv_stats, t5=t5_stats,
                                      pipeline=pp_stats, tp=tp_stats)}))
    print(json.dumps({"kernels": [record] + flash_records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
