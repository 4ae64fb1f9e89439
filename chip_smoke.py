#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one H100.

Run from the repository root on a machine with the card and the CUDA
toolkit::

    python3 chip_smoke.py

Phases (any failure exits non-zero; no failure of the port is caught —
only the K4 library yardstick is skipped where the installed torch has
no CUDA ``_weight_int8pack_mm``):

1. print the card's name and power limit; require compute capability 9.0;
2. build the CUDA kernels from ``paddle_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and print the build seconds, ptxas's register
   and spill lines, and the spill-store bytes of the kernels of
   ``NEW_INSTANCES`` (K5's and K9's bf16 kernels, PR 14);
3. hold each kernel against its plain PyTorch version on the card, in
   bf16 at llama3_8b widths (32 q heads, 8 kv heads, head_dim 128), per
   output row (||out - ref|| / ||ref|| <= 2^-6), and show that the check
   fails on a planted fault (every row loses its last 64 keys); time
   kernel, plain version, the least time the card could take, and (for
   prefill) ``torch.nn.functional.scaled_dot_product_attention`` as a
   yardstick the port never calls;
4. serve 8 requests through ``create_engine`` -> ``Engine.submit`` ->
   prefill-on-admit -> lockstep paged decode with llama3_8b at full
   width and depth (random bf16 weights from a seed), prefix cache on,
   ``sync_interval=8``; the kernels' launch counters are zeroed just
   before and read just after, and must both be > 0;
5. run a 2-layer llama3_8b-width engine in float32 twice from one state,
   on the card (kernels) and with ``device="cpu"`` (plain versions): the
   first 16 greedy tokens of 4 prompts must be identical;
6. train: ``setup`` -> ``build_train_step(remat=True)`` -> 1 warm-up and
   10 timed steps of the bench's Llama (~0.95 B params: hidden 2048, 16
   layers, 16 heads, FFN 5632, vocab 32000; bf16 params, f32 AdamW) on
   one [8, 2049] batch; the loss must be finite and fall, and the
   flash-attention counters (zeroed just before, read just after) must
   show 2 K1 forwards (remat) and one K2 dq and dk/dv per layer per step;
   tokens/s, MFU, peak memory and a profile of one step;
7. one training step in float32 at 2 layers of the same width, card
   (kernels) vs CPU (plain versions) from one set of params: loss, every
   grad and every param after the step agree by relative norm;
8. the quantized and multi-LoRA serving modes at llama3_8b full width
   and depth, phase 4's engine settings and traffic: (8a) int8 weights
   with an ``AdapterStore`` of 4 random rank-16 adapters (two requests
   dense, six on adapters; the two that share the 1024-token prefix on
   one adapter, a third with that prefix on another, which must not
   share its pages), (8b) int4 weights with int8 KV pages.  The K4
   launches must be 224 per decode step (7 projections x 32 layers),
   K5 the same in 8a, K3 zero in 8b (int8 pages take the plain
   dequantizing attention); decode tokens/s, TTFT, memory and a profile
   of the decode step;
9. both phase-8 configurations at 2 layers of llama3_8b width in
   float32, card (kernels) vs CPU (plain versions) from one state
   quantized once on the host: identical greedy tokens, except that a
   request may part where the CPU's top two logits tie (within 1e-3 of
   the logits' std; int8 KV pages turn last-bit differences into
   whole quantization steps now and then);
10. the reference bench's long-context rung (``bench.py:285-366``):
   (10a) ``bench_longctx``, phase 6's path at seq 8192, batch 1
   (``max_position_embeddings`` 8192), 1 warm-up and 8 timed steps;
   (10b) ``bench_longctx_masked``: the gradient of sum(sdpa(q, k, v,
   flashmask=three packed documents, is_causal=True).float() ** 2) w.r.t.
   q, k, v at B 1, S 8192, 16 heads, bf16, next to the same without the
   flashmask: the masked and unmasked ms and their ratio, launches per
   call (masked: 1 K8 forward with lse, 1 dq, 1 dk/dv, 0 dbias, no
   K1/K2; unmasked: K1/K2 only); (10c) ``flashmask_attention(causal=True,
   window_size=1024)`` at 10b's shape (nvec 4); (10d) the dense-bias
   route at 10b's shape, an ALiBi float ``attn_mask`` that requires grad
   (1 biased forward, dq, dk/dv and dbias).  Each is held against the
   plain versions per row and prints where one call's device time goes
   (``torch.profiler``: the K8 forward, tile table, dq, dk/dv, dbias,
   other); 10b also prints the streamed K8 backward's bound and the
   library's fwd+bwd of the same loss;
11. the reference bench's decode rungs through the port's ``generate``
   (random bf16 weights from seed 0, greedy): (11a) ``bench_decode``
   (``bench.py:451-482``), the 0.95 B bench model (hidden 2048, 16
   layers, 16 heads, vocab 32000), batch 8, prompt 128, 128 new tokens,
   dense and ``weight_quant="int8"``, each with K7 on and off (best of
   2 after a warm-up; launches per call: K7 16 x 128 on and 0 off, the
   K8 forward 16, K4 (4 x 16 + 1) per decode step), and a profile of
   one decode step; (11b) ``bench_paged`` (``bench.py:485-525``): prompt
   2048 right-padded, ragged lengths, 64 new tokens, dense (K7 on and
   off) vs ``cache="paged"`` (K3); (11c) llama3_8b at full width and
   depth, 8 prompts of 8064 tokens and 128 new (T 8192): dense with K7
   on and off, and paged: tokens/s, the wall time of a one-token call,
   memory and K7's device ms per step;
12. generation at 2 layers of llama3_8b width in float32, card
   (kernels) vs CPU (plain versions) from one state made on the host:
   identical greedy tokens for dense, paged, int8, int4 and 4 beams
   with an eos id (a request may part only at a tie of the CPU's top
   scores, as in phase 9), and on the card: ``top_k=1`` equals greedy,
   one seed gives one output, every token drawn with ``top_k=8,
   top_p=0.9`` lies in the filter's support;
13. the reference bench's MoE rung (``bench.py:369-420``) through the
   port's ``moe_llm``: (13a) ``bench_moe``, hidden 1024, FFN 1408, 8
   layers, 8/8 heads, 8 experts top-2, bf16, plain SGD, batch 16 x 512,
   1 + 2 warm-up and 10 timed steps (the loss must fall; launches per
   step exactly 8 K1, 8 K2 dq, 8 K2 dk/dv and no K9: the model takes the
   "sort" dispatch); tokens/s, MFU over the active params (by leaf name,
   and the bench's own count beside it), memory and a profile of one
   step; (13b) one MoE layer, forward + backward of
   ``moe_dispatch_combine`` at 13a's layer and at DeepSeekMoE-16B's (4096
   tokens, 64 experts top-6, hidden 2048, FFN 1408) in the "sort",
   "grouped" (K9: exactly one forward and one backward launch per call)
   and "dense" modes, grouped held to sort at capacity_factor E / top_k
   (nothing dropped) per output row; (13c) ``incubate.nn.functional.
   fused_rms_norm`` with a residual, forward + backward at llama3_8b width
   (one K6 launch per call);
14. one ``moe_llm`` training step in float32 at 2 layers of 13a's width
   (batch 2 x 128), without and with 2 shared experts, card (kernels) vs
   CPU (plain versions) from one set of params: loss, every grad and
   every param agree by relative norm (1e-4); and the grouped
   ``moe_dispatch_combine`` (K9 in float32) with its grads.  Routing must
   agree except at a tie of the CPU's f32 probabilities (within 1e-6),
   which the run names;
15. TinyLlama-1.1B training (its config.json: the bench rung's widths
   with 22 layers, 32 q / 4 kv heads at head_dim 64, rms eps 1e-5;
   random bf16 weights from seed 0): phase 6's path at 8 x 2048, remat, 1
   warm-up and 10 timed steps, exactly 2 K1 forwards and one K2 dq and
   dk/dv per layer per step at head_dim 64, no call of an attention
   plain version (counted by wrapping them), a loss that falls; then
   phase 7's f32 step at 2 of its layers, card vs CPU;
16. TinyLlama-1.1B served: phase 4's engine and traffic, each prompt cut
   to its 2048 positions less the 64 new tokens (prefill: the K8 forward
   at head_dim 64; decode: K3 at head_dim 64, both launched); TTFT,
   decode tokens/s and the decode step's profile; then phase 5's greedy
   tokens at 2 of its layers in f32, card vs CPU;
17. speculative serving at llama3_8b full width and depth (one random
   bf16 state from seed 0 for phases 17 and 18): phase 4's engine
   settings, 8 requests of random prompts of 512-2048 tokens + 128 new
   tokens, at ``spec_k=0``, then at ``spec_k=4`` with the n-gram
   drafter, with drafts replayed from the plain run, and with drafts
   replayed from that replay run (``ReplayProposer``; random weights
   give the n-gram drafter almost nothing to draft): decode tokens/s of
   each, tokens per step, verify steps, acceptance, K3 launches (L per
   decode or verify step, counted from 0 over the window) and a profile
   of verify steps; each spec run's tokens equal the plain run's up to
   each request's first parting, with logits rows up to it within 2^-3
   (two bf16 runs round apart; this limit cannot see a verify step one
   key short, which phase 19 checks in f32);
18. preemption at llama3_8b: 8 slots, a pool of pages for six priority-0
   requests of 2048 tokens (+ 2 pages), two priority-1 requests of 512
   arriving after 8 steps; dense pages, then int8 pages (their f32
   scales spill too), each with ``preempt=False`` (the uninterrupted
   run) and ``True``: preemptions, spilled and restored pages and bytes,
   read_page / write_page ms per page, the priority-1 TTFT both ways;
   the other requests bit for bit as in the uninterrupted run, the
   victims' tokens up to their first parting with logits rows within
   2^-3, and a restore that swaps k and v (a planted fault) must fail;
19. 2 layers of llama3_8b width in float32, card vs CPU: ``spec_k=4``
   with drafts replayed from the CPU's own plain run (accepted: more
   than one a verify step, tokens equal to the plain run's, logits rows
   within 1e-4, and a verify step one key short must fail that check),
   ``spec_k=4`` with the n-gram drafter, a preempt -> spill -> resume,
   and a ``step_raise`` fault at decode step 3 recovered through
   ``EngineSupervisor``: identical tokens and counters;
20. llama3_8b at full width and depth behind the HTTP server
   (``serve(config, state)`` on the card, phases 17-18's state: 8 slots,
   pages of 64, prefix cache): phase 4's traffic (``serve_prompts``, 64
   new tokens) first in-process on the server's engine, then, the prefix
   cache flushed, from 8 threads at once through ``ServingClient`` (four
   blocking, four streamed over SSE, each under its own trace): every
   answer 200 with 64 tokens and ``finish_reason`` "length", usage equal
   to the tokens returned, the ``/metrics`` token count's growth equal
   to the tokens sent, one ``request`` span per request under the trace
   id the client sent, ``/healthz`` ok, K3 and K8 launched and no plain
   version of either (the cached-suffix prefill's bool mask takes plain
   attention once per layer, as it takes XLA in the reference); client
   TTFT of the streams, decode tokens/s over HTTP, and beside them the
   in-process numbers and phase 4's.  Then a drain with one stream in
   flight: the stream finishes, a request during the drain gets 503;
21. 2 layers of llama3_8b width in float32 behind the HTTP server on the
   card, with two rank-16 adapters named in half of 8 request bodies,
   against the port's engine on the CPU: tokens (parting only at a tie,
   as in phase 9), finish reasons and usage blocks equal; a ``Router``
   over two more card servers on the same state dict gives the same
   tokens at a prefix hit rate no worse than one server's;
22. hybrid-parallel training through ``torch.distributed``: (22a) one
   NCCL rank, a (1, 1, 1) mesh, llama3_8b's width at 4 layers, bf16,
   8 x 2048: a ``remat=True`` step launches K1 2·L times, then 5 timed
   ``remat="attn"`` steps L times a step (K2 L times a step in both),
   the loss finite and falling; tokens/s, MFU, peak memory and a
   profile of one step; then one f32 ``remat="attn"`` step at 2 layers,
   card vs CPU (loss, every grad and param within 1e-4).  (22b) where
   the machine has four cards, four NCCL ranks spawned one per card: at
   (pp 2, tp 2) zero bubble with VPP 2 and sp, (pp 2, dp 2) 1F1B with
   ZeRO-1, and (dp 2, tp 2) GPipe with sp and ZeRO-1, one f32 step at 4
   layers against the one-rank run on the same card (loss and every
   param within 1e-4), then 5 bf16 steps at 8 layers: tokens/s per
   card, MFU, the NCCL share of the device's busy time and each rank's
   peak memory.  ``python3 chip_smoke.py hybrid-ranks`` runs 22b alone.
23. ``python3 chip_smoke.py serving-tp`` (four cards; not part of the
   one-card run): serving tensor parallelism, one process per card.
   (23a) 2 layers of llama3_8b width in float32, tp=2 and tp=4 against
   tp=1 on card 0 from one state, in six modes (dense with the prefix
   cache and one preempt -> spill -> resume; the same preemption without
   the cache, its pages restored from the host tier; int8 weights; int8
   KV pages; two LoRA adapters mixed with dense requests; spec_k 4 with
   drafts replayed from tp=1's plain run): greedy tokens equal (parting
   only at a tie, as in phase 9), every logits row within 1e-4 of
   tp=1's (int8 KV pages: 2^-8, with every int8 page entry within one
   level of tp=1's), the engines' counters equal, every rank's ring
   equal to rank 0's after every step; a planted fault (rank 0's o
   partial left out of the all-reduce) must fail the logits check.
   (23b) llama3_8b in bf16 at full depth, its state on the host (rank 0
   holds only its shard), phase 4's traffic at tp 1, 2 and 4: decode
   tokens/s, TTFT, each card's resident and peak memory, the busy and
   NCCL shares of a profiled decode window on rank 0, all-reduces per
   decode step and the host microseconds of each one on rank 0, each
   rank's host time per decode call and its busy share of a core, and
   the control message's cost per call.  (23c) a
   worker killed mid-run: the engine's next call raises naming its
   rank within the mesh's timeout, and every process is stopped.
24. ``python3 chip_smoke.py expert-sep`` (four cards; not part of the
   one-card run, which prints one line saying so): expert and context
   parallelism, one NCCL process per card.  (24a) one ``moe_llm`` step in
   float32 at 2 layers of 13a's width (8 experts top-2), with 0 and 2
   shared experts, at capacity_factor 1.25 and 0.35 (entries dropped past
   the global capacity), at (dp 2, ep 2), (dp 1, ep 4) and (dp 4, ep 1)
   against the one-rank run on card 0 from the same params: loss, every
   grad and every param of each rank's shard within 1e-4 relative,
   routing equal except at a named tie, after which the config runs again
   on the next seed's batch (all three tying fails); a planted fault
   (capacity counted per holder, not globally) must fail.  (24b) bf16 at
   full width: DeepSeekMoE-16B (28 layers, 64 experts top-6, 2 shared) at
   (dp 1, ep 4) and 13a's model at (dp 2, ep 2), a warm-up and 5 timed
   steps: the loss finite and falling, K1 and each K2 L times a step on
   every rank; tokens/s per card, MFU over the active params, the NCCL
   share of a profiled step's device time and each rank's peak memory.
   (24c) ring and Ulysses attention over a sep axis of the four cards, B
   1, S 16384, 32 heads, d 128, causal and not: output and q/k/v
   gradients in bf16 per row (2^-6) against one card's ``sdpa`` of the
   whole sequence (K1/K2; the ring, which computes in float32, against a
   float64 reference as well, and against ``sdpa`` within 2^-6 plus that
   row's own distance from float64), ``sdpa``'s rows against the plain
   bf16 versions of K1 and K2 (2^-6), float32 at B 1, S 2048, 8 heads, d
   64 within 1e-5 by relative norm, Ulysses' K1/K2 launches per call (one
   each), ms of each beside the one-card ``sdpa``; a ring whose first
   rotation is skipped (a planted fault) must fail the row check.  Each
   part prints its wall seconds; the mode stops itself past 900 s.
25. (run after phase 16, before the llama3_8b phases 17-22) the eager
   Paddle API (``paddle_tpu_torch`` as ``paddle``: Tensor, autograd, the
   op registry, ``nn.Layer``, ``optimizer.AdamW``), first printing the
   bytes allocated on the card and its largest live tensors:
   (25a) TinyLlama-1.1B at full width and depth (phase 15's config and
   seeded weights) as a ``LlamaForCausalLM`` in bf16, 8 x 2048 without
   recompute (halved for both paths, and said so, if that exceeds the
   card's memory), 1 warm-up and 5 timed eager steps of
   ``crit(model(ids), labels).backward(); opt.step(); opt.clear_grad()``:
   K1, K2 dq and K2 dk/dv exactly 22 times a step each (the registry's
   ``flash_attention`` op -> ``sdpa``), no attention plain version
   called, a finite, falling loss; tokens/s, MFU, peak memory and a
   profile of one step, and beside them the functional step's tokens/s
   (``llama_hybrid.build_train_step(remat=False)``) on the same weights
   and batch and the ratio of the two; (25b) f32 at 2 of its layers: the
   Layer path on the card against the same on the CPU (the loss of each
   of 2 AdamW steps and every param after them, and every grad of each
   step against the CPU's at the card's params of that step, within
   1e-4 relative), against
   the functional path on the card (loss within 1e-5, grads within
   1e-4), and a planted fault (AdamW without its bias correction) that
   must fail the param check; (25c) greedy tokens of 4 prompts from
   ``model.generate`` and ``create_engine(model)`` on the card equal to
   the ``(state, config)`` forms on the card and to the CPU's.
26. (run after phase 25, before phase 17) the reference bench's LeNet,
   ResNet50 and BERT rungs through the public API
   (``paddle_tpu_torch.jit.train_step``, ``vision.models``,
   ``models.bert``): (26a) ``bench_lenet``: LeNet at batch 64 x 1 x 28²,
   SGD lr 0.01, f32, 3 warm-up steps, then 30 eager steps and 30
   ``train_step`` steps from the same seeded model: steps/s of each and
   their ratio, the loss falling on both; (26b) ``bench_resnet50``:
   128 x 3 x 224², 1000 classes, ``amp.auto_cast`` O1 in bf16,
   ``Momentum(0.1, 0.9)``, ``train_step(...).multi_step(10)``, a warm-up
   call and the best of 2 timed calls: images/s, MFU by the bench's
   count (3 x 4.1 GFLOP an image over 989 TFLOP/s), peak memory, the
   loss, and one profiled step's device time by group (cuDNN
   convolutions, batch norms, elementwise) with its top kernels and
   idle share; (26c) ``bench_bert``: ``BertConfig()`` (BERT-base: 12
   layers, 12 heads of 64) at 32 x 384, O1 in bf16, ``AdamW(3e-5)``,
   ``multi_step(10)``, 2 warm-up calls and 3 timed ones: examples/s, MFU
   by ``bench.py:272-274``, exactly 12 launches each of K1, K2 dq and K2
   dk/dv a step (not causal, d 64) and no call of an attention plain
   version, and a profiled step; (26d) f32, the card against the port on
   the CPU on the same weights: the output, loss and every grad of one
   eager step, then every param and BatchNorm buffer after 2
   ``train_step`` steps, within 1e-4 relative, for LeNet (batch 64), the
   whole ResNet50 (2 x 3 x 64 x 64) and BERT at base width with 2 layers
   (2 x 384); TF32 off for matmuls and cuDNN and put back after; a
   planted fault (BatchNorm stepped with torch's momentum number, 0.1,
   in place of Paddle's 0.9) must fail the buffers' check.  Phase 3
   holds K1/K2 not causal at BERT-base's attention (``bert_base``: b 32,
   12/12 heads, s 384, d 64) as it holds the causal rows; the kernels
   line's ``*_d64_noncausal`` entries take its times and 26c's launches.

Every phase prints its wall seconds.

The K1/K2 and K8 kernels are built for head dims 64, 128 and 256; phase
3 holds the 64 and 256 instances as it holds the 128 ones: K1/K2 at
TinyLlama-1.1B's training attention (b 8, 32/4 heads, s 2048, d 64) and
Gemma-2B's (8/1 heads, d 256), both with the pairs x head_dim of the
training shape, and the exponentials beside each bound; the K8 forward
at TinyLlama's 2048 prefill bucket (no lse, as serving runs it); the K8
backward at SFT padding (TinyLlama's and Gemma-2B's heads) and ALiBi
with dbias (both); float32 instances of each, card vs CPU; and
``phase_routes`` requires ``sdpa`` at d 64 and 256 (unmasked, flashmask,
bias, each with gradients) to launch the kernels once and agree per row
with the plain versions.  Every K1/K2 and K8 record also requires two
runs to give the same bits.

Phase 3 also holds the flash-attention kernels (K1 forward, K2 dq and
dk/dv; in bf16 the Hopper kernels of ``csrc/flash_sm90.cuh``: wgmma,
a TMA ring, register accumulators) to their plain versions in bf16 at
six shapes (the training shape, llama3_8b widths, a ragged sq > sk
case, seq 8192, 13a's MoE rung and phase 22b's tp-split heads, 16/4),
per row of out, dq, dk and dv, with
the same kind of planted fault (the kernels told 64 keys fewer than
there are); and the weight-only GEMV (K4, int8
and int4; bf16 on mma.sync tensor cores, one launch) and the
gather-LoRA matmul (K5: a shrink split over K, then an expand by
column blocks) at the llama3_8b decode
projection shapes, per output row (<= 2^-7), each with a planted fault
(int8: the last 64 K rows of q zeroed; int4: nibbles swapped; K5: every
adapter row reads the next adapter), K5's two runs bit-equal.  Phase 3 also holds the K8
backward and bias kernels (forward with lse, dq, dk/dv, dbias) in bf16
at three shapes: SFT with key padding at llama3_8b widths (B 4, S 2048,
lengths 2048/1900/1200/517, causal), packed documents (B 1, S 4096, 16
heads, non-causal, nvec 4) and an ALiBi bias that takes a gradient (B 2,
16 heads, S 2048, causal, f32 [1, 16, S, S]); out per row and gradients
by ``grad_row_err``, each with its planted fault (every row loses its
last 64 keys), and float32 instances of the three at S 512, card vs the
CPU plain versions by relative norm (1e-4).  Phase 3 also holds the
dense-cache decode attention (K7: mma.sync tensor cores, a cp.async
ring, one launch) in bf16 per row at the bench decode shape (B 8, 16/16
heads, T 256), the reference's own K7 shape (B 8, 32/8 heads, T 8192),
11c's last decode step (every row at T 8192) and the head dims and
groups no shipped model runs (TinyLlama-1.1B's 32/4 heads at head_dim
64, head_dim 256 at 16/4, a group of 32), with the planted fault (the
kernel told pos - 64), one launch per call and bit-equal reruns, its
times beside the plain version's, the bound and
``scaled_dot_product_attention`` with a bool mask, and float32
instances at T 512 card vs CPU (<= 1e-5); the bf16 K8 dbias (wgmma,
flash_sm90.cuh) at 10d's shape (b 1, h 16, s 8192, ALiBi) against its
plain version per gradient row with its planted fault and bit-equal
reruns; the head-dim routes on the card (d 32, llama_tiny's, runs the
plain versions of sdpa and K7 with no launch and equals the CPU,
llama_tiny's greedy generate gives the CPU's tokens, and its engine
launches K3 at d 32 and gives the CPU's tokens; flash and masked flash
at d 64 and 256 launch their kernels, and K3 at d 64 launches and
agrees with its plain version); the
paged attention (K3: mma.sync tensor cores, a cp.async ring over the
block table, one launch) in bf16 per row at phase 4's decode shape,
11b's and 11c's paged caches and the head dims and groups no shipped
model runs at the engine's pages (TinyLlama-1.1B's 32/4 heads at
head_dim 64, head_dim 256 at 16/4, a group of 32, llama_tiny's 4/2 at
head_dim 32 in pages of 16) and at phase 17's verify step (8 slots x 5
rows sharing each slot's table row, lens pos + 1 ... pos + 5, beside K7
on the same keys), with the planted fault (the kernel told
lens - 64), one launch per call and bit-equal reruns, its device time
beside the plain version's and the bound, and float32 instances (lens
up to 512) card vs CPU (<= 1e-5); and K4 at the generation
path's widths (fused q/k/v, fused gate/up, lm_head; M = 8).  Every
kernel phase 11 runs is also held, with its planted fault, at the shapes
phase 11 gives it: K4 int8 at 11a's bench-model widths, K7 at 11b's
dense cache (T 2176), K3 at page 128 with 11b's and 11c's heads and
lengths, and the K8 forward at the prompt prefills of 11a, 11b and 11c
(B 8, S 128, 2048 and 8064).  Phase 3 also holds the K8 forward, dq and
dk/dv at 10c's mask (``window_8192``: b 1, h 16, s 8192, three packed
documents and a 1024-token causal window, nvec 4) with their planted
fault, timed beside K1 and K2 at the same shape without the mask, and
prints how many of the tiles each reaches the bf16 kernels skip.  Phase 3 also holds the grouped expert FFN
(K9, forward and backward) in bf16 per row (<= 2^-7) against its plain
versions at four layers: 13a's routing from a seeded gate, the same
widths with skewed routing (an expert with no tile, one with half the
rows), DeepSeekMoE-16B's layer and the gated (swiglu) variant with
float32 biases, each with a planted fault (tile 0 computed as the next
expert's), two runs bit-equal and the sort path's two expert einsums as
the yardstick, plus float32 instances card vs CPU; and RMSNorm (K6) at llama3_8b width (16,384
rows of 4096, bf16, per row <= 2^-7, planted fault: the weight one
column off) beside ``torch.nn.functional.rms_norm``.

Prints a ``{"kernels": [...]}`` line before the last, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when no CUDA card is present.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
# bf16 kernel vs plain version, per output row (one query head of one
# token, over head_dim): ||out - ref|| / ||ref||.  Both sides round to
# bf16 in a few places (2^-9 relative each); a row over n keys has
# |o| ~ n^-1/2, so an absolute limit would be loose on the long rows,
# which a per-row relative limit holds as tightly as the short ones.
ROW_TOL = 2 ** -6
FAULT_KEYS = 64               # planted fault: each row loses its last 64 keys
# phase 3's K9 records and phases 13-14: the reference bench's MoE rung
# (bench.py:381-385: hidden 1024, FFN 1408, 8 layers, 8/8 heads, 8
# experts top-2, bf16) at its batch 16 x 512 and 10 timed steps
MOE_BATCH, MOE_SEQ, MOE_STEPS = 16, 512, 10
MOE_HEADS = 8
# flash attention (K1/K2) in phase 3: the training shape first (the one
# the kernels line reports), then llama3_8b widths, a ragged cross-length
# case whose first 300 rows see no key, a long sequence, 13a's MoE rung
# (every layer of its step launches K1, dq and dk/dv at this shape), and
# the head dims 64 and 256 at the training shape's batch and length:
# TinyLlama-1.1B's heads (its config.json: 32 q / 4 kv, head_dim 64;
# phase 15 trains it) and Gemma-2B's (8 q / 1 kv, head_dim 256), whose
# pairs x head_dim, and so whose operations, equal the training shape's
FLASH_SHAPES = (  # name, B, H, kvH, Sq, Sk, D
    ("train", 8, 16, 16, 2048, 2048, 128),
    ("llama3_8b", 1, 32, 8, 2048, 2048, 128),
    ("ragged", 2, 16, 4, 1000, 700, 128),
    ("long", 1, 16, 16, 8192, 8192, 128),
    ("moe_train", MOE_BATCH, MOE_HEADS, MOE_HEADS, MOE_SEQ, MOE_SEQ, 128),
    ("tinyllama_train", 8, 32, 4, 2048, 2048, 64),
    ("gemma2b_d256", 8, 8, 1, 2048, 2048, 256),
    # phase 22b's tp-split attention: llama3_8b's 32/8 heads over tp 2
    # (16/4 a rank, a group of 4) at a dp rank's 4 rows of 2048
    ("llama3_8b_tp2", 4, 16, 4, 2048, 2048, 128),
    # phase 24's: Ulysses' local attention in 24c (SEP_SHAPE's 32 heads
    # over sep 4, the whole 16384-long sequence) and DeepSeekMoE-16B's
    # attention in 24b (16/16 heads at its batch 8 x 512)
    ("ulysses_s16k", 1, 8, 8, 16384, 16384, 128),
    ("deepseek_moe", 8, 16, 16, 512, 512, 128),
)
# softmax's exponentials (one per visible pair and pass): at head_dim 64
# the MUFU rate, 16 a clock on each of the 132 SMs at the 1.98 GHz boost
# clock (NVIDIA's H100 SXM data sheet), weighs as much as the tensor
# cores; printed beside the bound, not folded into it
EXP_PER_S = 16 * 132 * 1.98e9
FAULT_SHARE = 0.99            # gradient rows the planted fault must fail
# the K8 backward and bias kernels in phase 3: SFT with key padding at
# llama3_8b widths (GQA), packed documents (non-causal, nvec 4) and an
# ALiBi bias that takes a gradient (dbias summed over the batch); then
# the head dims 64 and 256: SFT padding at TinyLlama-1.1B's heads and at
# Gemma-2B's, and ALiBi with dbias at both
K8_SHAPES = (  # name, B, H, kvH, S, causal, mask, D
    ("sft_padding", 4, 32, 8, 2048, True, "padding", 128),
    ("packed_docs", 1, 16, 16, 4096, False, "segments", 128),
    ("alibi_bias", 2, 16, 16, 2048, True, "alibi", 128),
    ("tinyllama_sft", 4, 32, 4, 2048, True, "padding", 64),
    ("alibi_d64", 2, 32, 4, 2048, True, "alibi", 64),
    ("alibi_d256", 2, 8, 1, 2048, True, "alibi", 256),
    ("gemma2b_sft", 4, 8, 1, 2048, True, "padding", 256),
)
SFT_LENGTHS = (1.0, 1900 / 2048, 1200 / 2048, 517 / 2048)   # of S
PACKED_DOCS = (0.25, 0.375, 0.375)                          # of S
# phase 10: the reference bench's long-context rung (bench.py:285-366)
LONGCTX_SEQ = 8192
LONGCTX_WINDOW = 1024            # 10c's flashmask_attention window
# the K8 forward, dq and dk/dv at 10c's mask in phase 3 (name, B, H, S):
# beside K1 and K2 at the same shape without it, to show that hidden
# tiles are skipped
WINDOW_SHAPE = ("window_8192", 1, 16, LONGCTX_SEQ)
LONGCTX_STEPS = 8                 # bench_longctx's own timed steps (bench.py:301)
TRAIN_STEPS = 10
# phase 7, card (f32 kernels, no TF32) vs CPU, ||card - cpu|| / ||cpu||
PARITY_TOL = 1e-4
# K4 / K5 in phase 3, bf16 per output row (one token over N): both the
# kernels and their plain versions round once, at the output; the rest
# is summation order over K
GEMV_ROW_TOL = 2 ** -7
# the llama3_8b projections (K, N): q/o, k/v, gate/up, down
PROJ_SHAPES = (("q/o", 4096, 4096), ("k/v", 4096, 1024),
               ("gate/up", 4096, 14336), ("down", 14336, 4096))
LORA_RANK, LORA_ALPHA = 16, 32.0
# phase 9: a request whose card and CPU tokens part must part at a tie:
# at the first differing token, |l_card - l_cpu| / std(l) of the CPU's
# f32 logits for the two picks.  int8 KV pages round every new k/v row
# to 1/127 of its absmax, so a last-bit difference between the card's
# and the CPU's f32 sums moves a row by a whole step now and then; a
# random model's top two logits can lie that close
TIE_TOL = 1e-3
LORA_IDX = (0, 1, 2, 3, 4, 1, 0, 2)
# phase 11: the reference bench's decode rungs (bench.py:451-525), batch 8
DECODE_PROMPT, DECODE_NEW = 128, 128
PAGED_PROMPT, PAGED_NEW = 2048, 64
PAGED_LENGTHS = (2048, 160, 96, 224, 128, 192, 96, 160)
LONG_PROMPT, LONG_NEW = 8064, 128       # 11c: T = 8192 at llama3_8b
# K9 in phase 3 (name, tokens, E, top_k, D, F, gated, routing): the bench
# layer with routing from a seeded gate, the same widths with skewed
# routing (expert 0 owns no tile, expert 1 half the rows), DeepSeekMoE-
# 16B's layer (deepseek_moe_16b: 4096 tokens, 64 experts top-6, hidden
# 2048, FFN 1408) and the gated (swiglu, 2F) variant at the bench widths
K9_SHAPES = (
    ("bench_layer", MOE_BATCH * MOE_SEQ, 8, 2, 1024, 1408, False, "gate"),
    ("bench_skewed", MOE_BATCH * MOE_SEQ, 8, 2, 1024, 1408, False,
     "skewed"),
    ("deepseek_16b", 4096, 64, 6, 2048, 1408, False, "gate"),
    ("bench_gated", MOE_BATCH * MOE_SEQ, 8, 2, 1024, 1408, True, "gate"),
)
# 13b's layers (name, tokens, E, top_k, D, F): 13a's and DeepSeekMoE-16B's
MOE_LAYER_SHAPES = (("bench_layer", MOE_BATCH * MOE_SEQ, 8, 2, 1024, 1408),
                    ("deepseek_16b", 4096, 64, 6, 2048, 1408))
# K9 bf16, kernel vs plain version per row: both round h and ds to bf16
# from f32 sums taken in another order (a last bit flips now and then)
# and round each output once
K9_ROW_TOL = 2 ** -7
# K6 at llama3_8b width (8 x 2048 rows of 4096, bf16), per row: both
# round once, at the output; the row's mean of squares in another order
RMS_ROWS, RMS_WIDTH = 8 * 2048, 4096
K6_ROW_TOL = 2 ** -7
# phase 14: a routing difference must sit at a tie, two of the CPU's f32
# probabilities of one token within this of each other
MOE_TIE_TOL = 1e-6


def padded_t(prompt, new):
    """The dense cache length ``generate`` allocates with K7 on."""
    return -(-(prompt + new) // 128) * 128


# K7 in phase 3: (a) the reference bench's decode shape (bench.py:424-436,
# T 256, pos ragged in 128..255), (b) the reference's own K7 measurement
# shape (decode_attention.py:9: B 8, 32/8 heads, T 8192) with a full
# row, a short row and pos 0, (c) 11b's dense cache at its last decode
# step (T 2176), (d) 11c's at its last step (every row full, T 8192),
# and the head dims and groups no shipped model runs: (e) TinyLlama-
# 1.1B's 32 q / 4 kv heads at head_dim 64 (its config.json), (f) head_dim
# 256 at 16/4 heads, (g) a group of 32 q heads on one kv head
K7_SHAPES = (  # name, B, nh, kvh, T, pos, D
    ("bench_decode", 8, 16, 16, padded_t(DECODE_PROMPT, DECODE_NEW),
     (128, 255, 140, 200, 173, 129, 254, 191), 128),
    ("reference_8k", 8, 32, 8, 8192, (8191, 8191, 100, 0, 4095, 4096, 8000,
                                      257), 128),
    ("bench_paged", 8, 16, 16, padded_t(PAGED_PROMPT, PAGED_NEW),
     tuple(n + PAGED_NEW - 1 for n in PAGED_LENGTHS), 128),
    ("long_decode", 8, 32, 8, padded_t(LONG_PROMPT, LONG_NEW),
     (LONG_PROMPT + LONG_NEW - 1,) * 8, 128),
    ("tinyllama_d64", 8, 32, 4, 2048, (2047, 1500, 1000, 777, 300, 64, 63,
                                       0), 64),
    ("d256", 8, 16, 4, 2048, (2047, 2047, 1024, 1000, 500, 257, 64, 5), 256),
    ("group32", 8, 32, 1, 2048, (2047, 1800, 1024, 999, 512, 100, 64, 0),
     128),
)
K7_F32_T = 512                     # the f32 instances, card vs CPU
K7_F32_TOL = 1e-5                  # f32 K7 card vs CPU, relative norm
# the generation path's new K4 widths at llama3_8b (K, N): fused q/k/v,
# fused gate/up and the quantized lm_head
GEN_PROJ_SHAPES = (("qkv_fused", 4096, 6144), ("gateup_fused", 4096, 28672),
                   ("lm_head", 4096, 128256))
# and the widths 11a's int8 decode runs on the bench model (hidden 2048,
# FFN 5632, vocab 32000), int8 only
BENCH_PROJ_SHAPES = (("bench_qkv_fused", 2048, 6144), ("bench_o", 2048, 2048),
                     ("bench_gateup_fused", 2048, 11264),
                     ("bench_down", 5632, 2048),
                     ("bench_lm_head", 2048, 32000))
# K3 in phase 3 (name, nh, kvh, page size, table width, lens, head_dim):
# phase 4's decode shape, then 11b's and 11c's paged caches at their last
# decode step (generate's pool: page 128, the prompt's pages at least),
# then the engine's pages (64) at the head dims and groups no shipped
# model runs: TinyLlama-1.1B's 32/4 heads at head_dim 64 (its config.json),
# head_dim 256 at 16/4, a group of 32, and llama_tiny's 4/2 heads at
# head_dim 32 (its table spans max_position_embeddings, 256, in pages of
# 16); then two of the instances whose shared-memory rows are padded
# instead of swizzled: head_dim 80 at 32/8 and 96 at a group of 32; then
# the CUDA-core body at two head dims no mma.sync instance serves: 8 (the
# reference's tensor-parallel test model, 8/8 heads) and 72 at 32/8
PAGED_SHAPES = (
    ("serve", 32, 8, 64, 128, (1, 64, 65, 300, 1000, 2047, 4096, 8192), 128),
    ("bench_paged", 16, 16, 128, -(-(max(PAGED_LENGTHS) + PAGED_NEW) // 128),
     tuple(n + PAGED_NEW for n in PAGED_LENGTHS), 128),
    ("long_decode", 32, 8, 128, (LONG_PROMPT + LONG_NEW) // 128,
     (LONG_PROMPT + LONG_NEW,) * 8, 128),
    ("tinyllama_d64", 32, 4, 64, 32, (2048, 1500, 1000, 777, 300, 65, 64, 1),
     64),
    ("d256", 16, 4, 64, 32, (2048, 2047, 1024, 1000, 500, 257, 64, 5), 256),
    ("group32", 32, 1, 64, 32, (2048, 1800, 1024, 999, 512, 100, 65, 1),
     128),
    ("llama_tiny_d32", 4, 2, 16, 16, (256, 200, 129, 100, 65, 64, 16, 1), 32),
    ("d80", 32, 8, 64, 32, (2048, 2047, 1024, 1000, 500, 257, 64, 5), 80),
    ("d96_group32", 32, 1, 64, 32, (2048, 1800, 1024, 999, 512, 100, 65, 1),
     96),
    ("d8", 8, 8, 64, 32, (2048, 2047, 1024, 1000, 500, 257, 64, 5), 8),
    ("d72", 32, 8, 64, 32, (2048, 2047, 1024, 1000, 500, 257, 64, 5), 72),
)
# the PAGED_SHAPES rows that the CUDA-core K3 body serves
PAGED_ANY_SHAPES = ("d8", "d72")
# phase 17's speculative engine: k drafts per slot, and the verify
# step's K3 record in phase 3 (8 slots at ragged positions, k + 1 rows
# each, lens pos + 1 ... pos + k + 1)
SPEC_K = 4
VERIFY_POS = (2047, 159, 94, 222, 127, 190, 63, 1500)
K3_F32_LEN = 512                   # the f32 instances' longest row
K3_F32_TOL = 1e-5                  # f32 K3 card vs CPU, relative norm
# the K8 forward in phase 3 (name, B, H, kvH, S, lengths, yardsticks, D):
# phase 4's prefill buckets (one prompt each), then the prompt prefills
# of 11a, 11b and 11c (at 11c's size the plain version's time is not
# taken, and the library call gets k/v repeated to the q heads), then
# phase 16's 2048 bucket (TinyLlama-1.1B, 32/4 heads, head_dim 64)
MASKED_SHAPES = (
    ("serve_512", 1, 32, 8, 512, (448,), True, 128),
    ("serve_2048", 1, 32, 8, 2048, (1900,), True, 128),
    ("serve_6144", 1, 32, 8, 6144, (5000,), True, 128),
    ("bench_decode", 8, 16, 16, DECODE_PROMPT, (DECODE_PROMPT,) * 8, True,
     128),
    ("bench_paged", 8, 16, 16, PAGED_PROMPT, PAGED_LENGTHS, True, 128),
    ("long_decode", 8, 32, 8, LONG_PROMPT, (LONG_PROMPT,) * 8, "library",
     128),
    ("tinyllama_2048", 1, 32, 4, 2048, (1900,), True, 64),
)
# the head dims of the K1/K2 and K8 kernels besides 128 (ROADMAP queue 2
# A1): phase 3's f32 rows and phase_routes run each
NEW_HEAD_DIMS = (64, 256)


# the kernels this slice redesigned (PR 14), by source and a mark of
# their (mangled) names: phase 2 prints their ptxas spill bytes
NEW_INSTANCES = {"lora_matmul": ("lora_shrink", "lora_expand"),
                 "grouped_ffn": ("4sm90",)}


def spill_bytes(log, marks):
    """{kernel: bytes of spill stores} from ptxas's -v output, for the
    kernels whose name holds one of ``marks``."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn and any(mark in fn for mark in marks):
            out[fn] = int(m.group(1))
    return out


def require(cond, what):
    """Fail the smoke test (a check that ``python -O`` keeps)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device milliseconds per call, CUDA events around a loop."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds per call: the summed duration of every
    kernel ``fn`` launches, from ``torch.profiler``.  For calls shorter
    than the host's launch work (K4/K5 at decode shapes), CUDA events
    around a loop measure the host, not the card."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters


def release():
    """Free what an earlier phase left (engines hold reference cycles, so
    a collection comes first) before the next phase measures memory."""
    gc.collect()
    torch.cuda.empty_cache()


def emit(obj):
    print(json.dumps(obj), flush=True)


class Laps:
    """Wall seconds of each phase, printed as each one ends."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()

    def __call__(self, phase):
        now = time.perf_counter()
        emit({"phase": phase, "phase_wall_s": now - self.t,
              "total_wall_s": now - self.t0,
              "allocated_bytes": torch.cuda.memory_allocated()})
        self.t = now


def row_rel_err(out, ref, floor=0.0):
    """Per-row ||out - ref|| / max(||ref||, floor) over the last dim; with
    no floor, a row whose reference is all zero (no visible key) must be
    exactly zero."""
    o, r = out.float(), ref.float()
    diff = (o - r).norm(dim=-1)
    norm = r.norm(dim=-1).clamp_min(floor)
    return torch.where(norm > 0, diff / norm.clamp_min(1e-30),
                       torch.where(diff > 0, math.inf, 0.0))


def grad_row_err(g, ref):
    """The per-row check for gradients.  A row's true gradient can be 0
    where its output is not (dq of a query that sees one key: ds = p (dp
    - delta) with delta = dp), so the denominator has a floor of 2^-6 x
    the RMS row norm of ``ref``: such a row is held to an absolute
    ||g|| <= 2^-12 x that RMS instead of an undefined ratio."""
    rms = ref.float().norm(dim=-1).square().mean().sqrt().item()
    return row_rel_err(g, ref, floor=2 ** -6 * rms)


def visible_pairs(sq, sk):
    """(query, key) pairs a causal, bottom-right aligned row set sees."""
    return int(np.clip(np.arange(sq) + (sk - sq) + 1, 0, sk).sum())


def is_k8_forward(low):
    """Whether a lower-cased device kernel name (as ``torch.profiler``
    gives it) is part of the K8 forward: the f32 WMMA instance, the tile
    table, or a ``flash_sm90::fwd_kernel`` in a K8 mode (K1's is mode 0,
    ``(flash::Mode)0``, at any head dim)."""
    return ("masked_fwd" in low or "tile_table_kernel" in low
            or ("flash_sm90::fwd_kernel<" in low
                and "(flash::mode)0," not in low))


def is_k8_backward(low):
    """Whether a lower-cased device kernel name is a K8 backward kernel:
    the f32 dq, dk/dv and dbias kernels, ``flash_sm90::dbias_kernel``, or
    a ``flash_sm90::dq_kernel`` / ``dkv_kernel`` in a K8 mode (K2's are
    mode 0).  The tile table the backward entries run first is
    :func:`is_k8_forward`'s."""
    return ("masked_bwd_" in low or "flash_sm90::dbias_kernel" in low
            or (("flash_sm90::dq_kernel<" in low
                 or "flash_sm90::dkv_kernel<" in low)
                and "(flash::mode)0," not in low))


def k8_part(low):
    """The part of a K8 call a lower-cased device kernel name belongs to:
    fwd, table, dq, dkv, dbias; K1/K2's kernels are "k1_k2"; anything
    else "other"."""
    if "tile_table_kernel" in low:
        return "table"
    if is_k8_forward(low):
        return "fwd"
    if is_k8_backward(low):
        return ("dbias" if "dbias" in low else
                "dkv" if "dkv_kernel" in low else "dq")
    if "flash_sm90::" in low or "flash_bwd_" in low or "flash_fwd_" in low:
        return "k1_k2"
    return "other"


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    bf16 operations over the tensor-core peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def paged_inputs(gen, B, nh, kvh, ps, W, lens, D, dev="cuda",
                 dt=torch.bfloat16):
    """q, pools, table and lens of one K3 shape: a table of width ``W``
    over one pool row per page, shuffled, padded with the dump page (the
    last row), as the engine's pool is."""
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    P = B * W + 1
    q = torch.randn(B, nh, D, device=dev, generator=gen).to(dt)
    kp = torch.randn(P, kvh, ps, D, device=dev, generator=gen).to(dt)
    vp = torch.randn(P, kvh, ps, D, device=dev, generator=gen).to(dt)
    perm = torch.randperm(B * W, device=dev, generator=gen).reshape(B, W)
    need = (lens + ps - 1) // ps
    table = torch.where(torch.arange(W, device=dev)[None] < need[:, None],
                        perm, P - 1).to(torch.int32).contiguous()
    return q, kp, vp, table, lens


def paged_bound(q, kvh, ps, lens):
    """(bound_ms, bound_by) of one K3 call: q and out, the visible K/V
    rows, their table entries and lens; ~4 flops per q head and key per
    head-dim element."""
    B, nh, D = q.shape
    toks = int(lens.sum())
    pages = int(((lens + ps - 1) // ps).sum())
    item = q.element_size()
    return bound(2 * q.numel() * item + 2 * toks * kvh * D * item
                 + 4 * (pages + B), 4 * toks * D * nh)


def phase_paged(PA, gen, name, nh, kvh, ps, W, lens, D):
    """K3 at one ``PAGED_SHAPES`` decode shape against its plain version
    (``paged_attention_xla``) in bf16, per output row; the planted fault
    (the kernel told lens - 64, so every long row loses its last 64
    keys) must fail every such row; one launch per call, and two calls
    give the same bits.  ``ms``, ``plain_ms`` are device time per call
    (``device_ms``); ``events_ms`` is CUDA events around back-to-back
    calls, which the host's per-call work sets at the short shapes."""
    q, kp, vp, table, lens = paged_inputs(gen, len(lens), nh, kvh, ps, W,
                                          lens, D)
    return paged_record(PA, name, q, kp, vp, table, lens)


def paged_record(PA, name, q, kp, vp, table, lens, bound_ms=None):
    """The phase-3 checks and times of K3 on prepared inputs (see
    :func:`phase_paged`); ``bound_ms`` overrides :func:`paged_bound`'s
    ``(bound_ms, bound_by)`` where rows share their keys."""
    B, nh, D = q.shape
    kvh, ps = kp.shape[1], kp.shape[2]
    W = table.shape[1]
    n0 = PA.paged_attention.launches
    out = PA.paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    require(PA.paged_attention.launches == n0 + 1,
            f"paged_attention {name}: one launch per call")
    require(torch.equal(out, PA.paged_attention(q, kp, vp, table, lens)),
            f"paged_attention {name}: two calls differ")
    ref = PA.paged_attention_xla(q, kp, vp, table, lens)
    err = (out.float() - ref.float()).abs().max().item()
    rows = row_rel_err(out, ref)                         # [B, nh]
    row_err = rows.max().item()
    worst_lens = int(lens[rows.amax(dim=1).argmax()])
    require(row_err <= ROW_TOL,
            f"paged_attention {name}: row error {row_err} > {ROW_TOL} "
            f"(worst row: lens {worst_lens})")
    # the check must catch a kernel that skips each row's last page
    short = torch.clamp(lens - FAULT_KEYS, min=1).to(torch.int32)
    fault = row_rel_err(PA.paged_attention(q, kp, vp, table, short),
                        ref)[lens > FAULT_KEYS]
    require(bool((fault > ROW_TOL).all()),
            f"planted fault (last {FAULT_KEYS} keys dropped) passed the "
            f"paged_attention check at {name}: min row error "
            f"{fault.min().item()}")
    ms = device_ms(lambda: PA.paged_attention(q, kp, vp, table, lens))
    events_ms = cuda_ms(lambda: PA.paged_attention(q, kp, vp, table, lens),
                        iters=50)
    plain_ms = device_ms(lambda: PA.paged_attention_xla(q, kp, vp, table,
                                                        lens), iters=5)
    bound_ms, bound_by = bound_ms or paged_bound(q, kvh, ps, lens)
    n_split = PA.launch_splits(B, nh, kvh, ps, W, D, q.dtype,
                               torch.cuda.get_device_properties(0)
                               .multi_processor_count)
    shape = {"kernel": "paged_attention", "shape": name,
             "body": PA._body(D),
             "dtype": "bfloat16", "B": B,
             "nh": nh, "kvh": kvh, "D": D, "page_size": ps, "W": W,
             "lens": lens.tolist(), "splits": n_split, "max_abs_err": err,
             "max_row_rel_err": row_err, "row_tol": ROW_TOL,
             "worst_row_lens": worst_lens,
             "fault_min_row_rel_err": fault.min().item(),
             "ms": ms, "events_ms": events_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    emit({"phase": 3, **shape})
    return shape


def phase_paged_verify(PA, DA, gen):
    """K3 at the speculative verify step's shape (phase 17's engine at
    llama3_8b heads: 32/8, head_dim 128, pages of 64): ``VERIFY_POS``
    slots x (k + 1) rows, each slot's rows sharing its table row, row j
    attending ``lens = pos + j + 1`` — held per row as
    :func:`phase_paged` holds the decode shapes, its planted fault
    failing every row, beside K7 on the same keys in a dense cache (no
    single PyTorch call computes a paged attention)."""
    m = SPEC_K + 1
    ps, nh, kvh, D = 64, 32, 8, 128
    last = [p + m for p in VERIFY_POS]
    W = -(-max(last) // ps)
    _, kp, vp, table, _ = paged_inputs(gen, len(last), nh, kvh, ps, W,
                                       last, D)
    table = table.repeat_interleave(m, dim=0).contiguous()
    lens = torch.tensor([p + j + 1 for p in VERIFY_POS for j in range(m)],
                        dtype=torch.int32, device="cuda")
    q = torch.randn(lens.numel(), nh, D, device="cuda",
                    generator=gen).to(torch.bfloat16)
    # a slot's rows read its keys once: the K/V bytes are each slot's
    # longest row's; the operations count every row's keys
    item = q.element_size()
    keys = sum(last)
    verify_bound = bound(2 * q.numel() * item + 2 * keys * kvh * D * item
                     + 4 * (sum(-(-n // ps) for n in last) + lens.numel()),
                     4 * int(lens.sum()) * D * nh)
    rec = paged_record(PA, f"verify_k{SPEC_K}", q, kp, vp, table, lens,
                       bound_ms=verify_bound)
    kd, vd = (PA.gather_kv_pages(p, table).transpose(1, 2).contiguous()
              for p in (kp, vp))
    pos = lens - 1
    rec["k7_same_keys_ms"] = device_ms(
        lambda: DA.decode_attention(q, kd, vd, pos))
    rec["slots"], rec["rows_per_slot"] = len(VERIFY_POS), m
    emit({"phase": 3, "kernel": "paged_attention", "shape": rec["shape"],
          "k7_same_keys_ms": rec["k7_same_keys_ms"]})
    return rec


def phase_paged_f32(PA, name, nh, kvh, ps, W, lens, D):
    """A float32 instance of a phase-3 K3 shape, its lens scaled to at
    most ``K3_F32_LEN`` and its table to match: the kernel on the card
    vs the plain version on the CPU from the same inputs made on the
    host, by relative norm."""
    top = max(lens)
    lens = [max(1, n * K3_F32_LEN // top) if top > K3_F32_LEN else n
            for n in lens]
    W = min(W, -(-max(lens) // ps) + 1)
    cpu = paged_inputs(torch.Generator().manual_seed(4), len(lens), nh, kvh,
                       ps, W, lens, D, dev="cpu", dt=torch.float32)
    want = PA.paged_attention_xla(*cpu)
    card = PA.paged_attention(*(x.cuda() for x in cpu))
    err = rel_norm(card, want)
    emit({"phase": 3, "kernel": "paged_attention", "shape": name,
          "dtype": "float32", "D": D, "page_size": ps, "W": W, "lens": lens,
          "card_vs_cpu_rel_err": err, "tol": K3_F32_TOL})
    require(err <= K3_F32_TOL, f"paged_attention f32 {name}: card vs CPU "
            f"{err} > {K3_F32_TOL}")


def phase_decode(DA, gen, name, B, nh, kvh, T, pos, D):
    """K7 against its plain version (``_xla_decode``) in bf16 at one
    phase-3 shape, per output row; the planted fault (the kernel told
    pos - 64, so every long row loses its last 64 keys) must fail every
    such row; one launch per call, and two calls give the same bits.
    ``ms``, ``plain_ms`` and ``library_ms`` are device time per call
    (``device_ms``; ``events_ms`` is CUDA events around back-to-back
    calls, which the host sets at the short shape); the library
    yardstick is scaled_dot_product_attention on q [B, nh, 1, D] with
    the bool mask t <= pos and ``enable_gqa``, never on the port's
    path."""
    dev, dt = "cuda", torch.bfloat16
    q = torch.randn(B, nh, D, device=dev, generator=gen).to(dt)
    k = torch.randn(B, kvh, T, D, device=dev, generator=gen).to(dt)
    v = torch.randn(B, kvh, T, D, device=dev, generator=gen).to(dt)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    n0 = DA.decode_attention.launches
    out = DA.decode_attention(q, k, v, pos_t)
    torch.cuda.synchronize()
    require(DA.decode_attention.launches == n0 + 1,
            f"decode_attention {name}: one launch per call")
    require(torch.equal(out, DA.decode_attention(q, k, v, pos_t)),
            f"decode_attention {name}: two calls differ")
    ref = DA._xla_decode(q, k, v, pos_t)
    rows = row_rel_err(out, ref)                          # [B, nh]
    row_err = rows.max().item()
    require(row_err <= ROW_TOL, f"decode_attention {name}: row error "
            f"{row_err} > {ROW_TOL}")
    short = torch.clamp(pos_t - FAULT_KEYS, min=0).to(torch.int32)
    fault = row_rel_err(DA.decode_attention(q, k, v, short),
                        ref)[pos_t >= FAULT_KEYS]
    require(bool((fault > ROW_TOL).all()),
            f"planted fault (last {FAULT_KEYS} keys dropped) passed the "
            f"decode_attention check at {name}: min row error "
            f"{fault.min().item()}")
    ms = device_ms(lambda: DA.decode_attention(q, k, v, pos_t))
    events_ms = cuda_ms(lambda: DA.decode_attention(q, k, v, pos_t),
                        iters=50)
    plain_ms = device_ms(lambda: DA._xla_decode(q, k, v, pos_t), iters=5)
    mask = (torch.arange(T, device=dev)[None, :] <= pos_t[:, None])[
        :, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4 = q[:, :, None, :]
    lib = sdpa(q4, k, v, attn_mask=mask, enable_gqa=kvh != nh)[:, :, 0]
    library_ms = device_ms(lambda: sdpa(q4, k, v, attn_mask=mask,
                                        enable_gqa=kvh != nh))
    visible = int(torch.clamp(pos_t + 1, max=T).sum())
    item = q.element_size()
    bound_ms, bound_by = bound(2 * visible * kvh * D * item
                               + 2 * q.numel() * item + 4 * B,
                               4 * visible * nh * D)
    n_split = DA._splits(B * kvh * -(-(nh // kvh) // 16), T,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count, D)[0]
    rec = {"kernel": "decode_attention", "shape": name, "dtype": "bfloat16",
           "B": B, "nh": nh, "kvh": kvh, "D": D, "T": T, "pos": list(pos),
           "splits": n_split,
           "max_abs_err": (out.float() - ref.float()).abs().max().item(),
           "max_row_rel_err": row_err, "row_tol": ROW_TOL,
           "fault_min_row_rel_err": fault.min().item(),
           "library_max_row_rel_err": row_rel_err(lib, ref).max().item(),
           "ms": ms, "events_ms": events_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
    emit({"phase": 3, **rec})
    return rec


def phase_decode_f32(DA, name, B, nh, kvh, T, pos, D):
    """A float32 instance of a phase-3 K7 shape at T ``K7_F32_T`` (pos
    scaled to it): the kernel on the card vs the plain version on the
    CPU from the same inputs made on the host, by relative norm."""
    t = K7_F32_T
    g = torch.Generator().manual_seed(4)
    q = torch.randn(B, nh, D, generator=g)
    k, v = (torch.randn(B, kvh, t, D, generator=g) for _ in range(2))
    pos_t = torch.tensor([p * t // T for p in pos], dtype=torch.int32)
    cpu = DA._xla_decode(q, k, v, pos_t)
    card = DA.decode_attention(*(x.cuda() for x in (q, k, v, pos_t)))
    err = rel_norm(card, cpu)
    emit({"phase": 3, "kernel": "decode_attention", "shape": name,
          "dtype": "float32", "T": t, "D": D, "pos": pos_t.tolist(),
          "card_vs_cpu_rel_err": err, "tol": K7_F32_TOL})
    require(err <= K7_F32_TOL, f"decode_attention f32 {name}: card vs CPU "
            f"{err} > {K7_F32_TOL}")


def phase_masked(FM, gen, name, B, H, kvh, S, lengths, yardsticks, D):
    """K8 forward at one ``MASKED_SHAPES`` prefill shape: B prompts
    right-padded to S with ``lengths`` real tokens, causal + key
    padding, q/k/v as the transposed [B, S, H, D] views the dispatcher
    passes.  The plain version runs one prompt at a time (its f32 score
    matrix is [H, S, S] then).  ``yardsticks`` True times the plain
    version and the library call; ``"library"`` the library call alone,
    with k/v repeated to the q heads outside the timed call, on the
    memory-efficient backend (with ``enable_gqa`` and a mask,
    ``scaled_dot_product_attention`` takes its math path, whose [B, H, S,
    S] scores do not fit at 11c's size).  Two calls must give the same
    bits."""
    dev, dt = "cuda", torch.bfloat16
    q = torch.randn(B, S, H, D, device=dev, generator=gen).to(dt)
    k = torch.randn(B, S, kvh, D, device=dev, generator=gen).to(dt)
    v = torch.randn(B, S, kvh, D, device=dev, generator=gen).to(dt)
    lens = torch.tensor(lengths, device=dev)
    cols = torch.arange(S, device=dev)[None]
    keep = cols < lens[:, None]
    vecs = FM.padding_mask_to_intervals(keep, S)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    scale = 1.0 / math.sqrt(D)
    out = FM.flash_mha_masked(qh, kh, vh, vecs, True, scale)
    torch.cuda.synchronize()
    ref = torch.cat([FM.flash_mha_masked_xla(qh[b:b + 1], kh[b:b + 1],
                                             vh[b:b + 1], vecs[b:b + 1],
                                             True, scale)
                     for b in range(B)])
    err = (out.float() - ref.float()).abs().max().item()
    rows = row_rel_err(out, ref).amax(dim=1)             # [B, S]
    row_err = rows.max().item()
    # query row i of prompt b sees keys <= i that are real
    wb, wi = divmod(int(rows.argmax()), S)
    worst_keys = min(wi + 1, lengths[wb])
    require(row_err <= ROW_TOL,
            f"flash_mha_masked {name}: row error {row_err} > {ROW_TOL} "
            f"(worst row sees {worst_keys} keys)")
    # the check must catch a kernel that drops the last K block: each
    # prompt's last 64 real keys, lost by every row from its length - 1 on
    short = FM.padding_mask_to_intervals(cols < lens[:, None] - FAULT_KEYS, S)
    fault = row_rel_err(FM.flash_mha_masked(qh, kh, vh, short, True, scale),
                        ref).transpose(1, 2)[cols >= lens[:, None] - 1]
    del ref
    require(bool((fault > ROW_TOL).all()),
            f"planted fault (last {FAULT_KEYS} keys dropped) passed the "
            f"flash_mha_masked check at {name}: min row error "
            f"{fault.min().item()}")
    require(torch.equal(out, FM.flash_mha_masked(qh, kh, vh, vecs, True,
                                                 scale)),
            f"flash_mha_masked {name}: two calls differ")
    ms = cuda_ms(lambda: FM.flash_mha_masked(qh, kh, vh, vecs, True, scale))
    plain_ms = library_ms = None
    if yardsticks:
        dense = (torch.ones(S, S, dtype=torch.bool, device=dev).tril()
                 [None] & keep[:, None, :])[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if yardsticks is True:
            plain_ms = cuda_ms(
                lambda: FM.flash_mha_masked_xla(qh, kh, vh, vecs, True,
                                                scale),
                iters=3, warmup=1)
            library_ms = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=dense,
                                              scale=scale, enable_gqa=True))
        else:
            from torch.nn.attention import SDPBackend, sdpa_kernel
            kr, vr = (t.repeat_interleave(H // kvh, dim=1) for t in (kh, vh))
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                library_ms = cuda_ms(lambda: sdpa(
                    qh, kr, vr, attn_mask=dense, scale=scale))
            del kr, vr
        del dense
    # visible (query, key) pairs: row i sees keys <= i that are real
    pairs = sum(int(np.minimum(np.arange(S) + 1, n).sum()) for n in lengths)
    item = q.element_size()
    bound_ms, bound_by = bound(
        (2 * q.numel() + k.numel() + v.numel()) * item + vecs.numel() * 4,
        4 * pairs * D * H)
    shape = {"kernel": "flash_mha_masked", "shape": name,
             "dtype": "bfloat16", "B": B, "H": H, "kvh": kvh, "D": D,
             "S": S, "lengths": list(lengths),
             "max_abs_err": err, "max_row_rel_err": row_err,
             "row_tol": ROW_TOL, "worst_row_keys": worst_keys,
             "fault_min_row_rel_err": fault.min().item(),
             "rerun_bit_equal": True, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms}
    emit({"phase": 3, **shape})
    return shape


def phase_window(FA, FM, gen, name, B, H, S):
    """The K8 forward (with lse, as 10c runs it), dq and dk/dv at 10c's
    mask, three packed documents and a 1024-token causal window (nvec
    4), against their plain versions per row with the planted fault
    (every row loses its last 64 keys: the kernels told 64 keys fewer),
    and timed beside K1 and K2 at the same shape without the mask: the
    tiles the intervals hide whole are skipped, so each must take well
    under its unmasked twin's time.  Prints how each kernel classes the
    tiles it reaches (:func:`window_backward`)."""
    dev, dt, D = "cuda", torch.bfloat16, 128
    scale = 1.0 / math.sqrt(D)
    q, k, v = (torch.randn(B, S, H, D, device=dev, generator=gen).to(dt)
               .transpose(1, 2) for _ in range(3))
    vecs = window_intervals(FM, B, S, dev)
    out, lse = FM._masked_fwd(q, k, v, vecs, None, True, scale, True)
    torch.cuda.synchronize()
    ref, ref_lse = FM._masked_fwd_xla(q, k, v, vecs, None, True, scale)
    require(bool((lse[ref_lse == FM.LSE_INVALID] == FM.LSE_INVALID).all()),
            f"K8 {name}: rows with no key must get LSE_INVALID")
    err = (out.float() - ref.float()).abs().max().item()
    row_err = row_rel_err(out, ref).max().item()
    require(row_err <= ROW_TOL, f"flash_mha_masked {name}: row error "
            f"{row_err} > {ROW_TOL}")
    n = S - FAULT_KEYS
    fault = row_rel_err(FM._masked_fwd(q, k[:, :, :n], v[:, :, :n],
                                       vecs[..., :n], None, True, scale,
                                       True)[0], ref)
    fault = fault[ref_lse != FM.LSE_INVALID]
    del ref, ref_lse
    require(bool((fault > ROW_TOL).all()), f"planted fault (last "
            f"{FAULT_KEYS} keys dropped) passed the flash_mha_masked check "
            f"at {name}: min row error {fault.min().item()}")
    ms = cuda_ms(lambda: FM._masked_fwd(q, k, v, vecs, None, True, scale,
                                        True))
    k1_ms = cuda_ms(lambda: FA._flash_fwd(q, k, v, True, scale))
    plain_ms = cuda_ms(lambda: FM._masked_fwd_xla(q, k, v, vecs, None, True,
                                                  scale), iters=3, warmup=1)
    dense = (FM.dense_mask_from_intervals(vecs, S, S)
             & torch.ones(S, S, dtype=torch.bool, device=dev).tril())
    library_ms = cuda_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(q, k, v,
                                                      attn_mask=dense,
                                                      scale=scale))
    pairs = int(dense.sum()) * H
    del dense
    # the tiles the forward reaches (the causal bound) by class
    cls = FM._tile_classes(FM._tile_table(vecs), S)
    reach = torch.ones(cls.shape[-2:], dtype=torch.bool, device=dev).tril()
    tiles = {c: int(((cls == i) & reach).sum()) * H
             for i, c in enumerate(("skip", "partial", "clean"))}
    nbytes = 4 * q.numel() * 2 + B * H * S * 4 + vecs.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4 * pairs * D)
    rec = {"kernel": "flash_mha_masked", "shape": name, "dtype": "bfloat16",
           "B": B, "H": H, "kvh": H, "D": D, "S": S, "causal": True,
           "nvec": vecs.shape[2], "window": LONGCTX_WINDOW,
           "visible_pairs": pairs, "tiles": tiles, "max_abs_err": err,
           "max_row_rel_err": row_err, "row_tol": ROW_TOL,
           "fault_min_row_rel_err": fault.min().item(), "ms": ms,
           "k1_unmasked_ms": k1_ms, "ms_over_k1": ms / k1_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms,
           "bwd": window_backward(FA, FM, gen, q, k, v, out, lse, vecs,
                                  pairs)}
    emit({"phase": 3, **rec})
    return rec


def window_backward(FA, FM, gen, q, k, v, out, lse, vecs, pairs):
    """phase_window's backward half: the K8 dq and dk/dv on the kernel
    forward's out and lse against their plain versions per row
    (grad_row_err), the planted fault (forward and backward told 64 keys
    fewer) failing >= FAULT_SHARE of the gradient rows; their times
    beside K2's dq and dk/dv at the shape without the mask, the plain
    versions, the bound and the library's forward + backward; and how
    each walk classes the tiles it reaches (dq: 128-row query blocks x
    64-key tiles; dk/dv: 64-row query tiles x 64-key blocks)."""
    B, H, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    do = (torch.randn(B, S, H, D, device=q.device, generator=gen)
          .to(q.dtype).transpose(1, 2))
    args = (vecs, None, True, scale)
    dq, delta = FM._masked_bwd_dq(q, k, v, out, lse, do, *args)
    dk, dv = FM._masked_bwd_dkv(q, k, v, lse, delta, do, *args)
    torch.cuda.synchronize()
    plain = (q, k, v, out, lse, do, *args)
    refs = {"dq": FM._masked_bwd_dq_xla(*plain)}
    refs["dk"], refs["dv"] = FM._masked_bwd_dkv_xla(*plain)
    got = {"dq": dq, "dk": dk, "dv": dv}
    errs = {key: (got[key].float() - ref.float()).abs().max().item()
            for key, ref in refs.items()}
    row_err = {key: grad_row_err(got[key], ref).max().item()
               for key, ref in refs.items()}
    for key, err in row_err.items():
        require(err <= ROW_TOL, f"K8 {key} kernel vs plain at window_8192: "
                f"row error {err} > {ROW_TOL}")
    n = S - FAULT_KEYS
    kf, vf, fvecs = k[:, :, :n], v[:, :, :n], vecs[..., :n]
    fout, flse = FM._masked_fwd(q, kf, vf, fvecs, None, True, scale, True)
    bad = {"dq": FM._masked_bwd_dq(q, kf, vf, fout, flse, do, fvecs, None,
                                   True, scale)}
    bad["dk"], bad["dv"] = FM._masked_bwd_dkv(q, kf, vf, flse, bad["dq"][1],
                                              do, fvecs, None, True, scale)
    bad["dq"] = bad["dq"][0]
    caught_share, fault = {}, {}
    for key, ref in refs.items():
        ref = ref if key == "dq" else ref[:, :, :n]
        caught_share[key], fault[key] = caught(grad_row_err(bad[key], ref),
                                               ref)
        require(caught_share[key] >= FAULT_SHARE, f"planted fault "
                f"({FAULT_KEYS} keys dropped) failed the K8 {key} check at "
                f"window_8192 on only {caught_share[key]:.4f} of the rows")
    del refs, bad, fout, flse, got
    calls = {
        "dq": (lambda: FM._masked_bwd_dq(q, k, v, out, lse, do, *args),
               lambda: FM._masked_bwd_dq_xla(*plain)),
        "dkv": (lambda: FM._masked_bwd_dkv(q, k, v, lse, delta, do, *args),
                lambda: FM._masked_bwd_dkv_xla(*plain))}
    ms = {key: cuda_ms(kern) for key, (kern, _) in calls.items()}
    plain_ms = {key: cuda_ms(fn, iters=2, warmup=1)
                for key, (_, fn) in calls.items()}
    k1_out, k1_lse = FA._flash_fwd(q, k, v, True, scale)
    _, k1_delta = FA._flash_bwd_dq(q, k, v, k1_out, k1_lse, do, True, scale)
    k2_ms = {"dq": cuda_ms(lambda: FA._flash_bwd_dq(
                 q, k, v, k1_out, k1_lse, do, True, scale)),
             "dkv": cuda_ms(lambda: FA._flash_bwd_dkv(
                 q, k, v, k1_lse, k1_delta, do, True, scale))}
    del k1_out, k1_lse, k1_delta
    dense = (FM.dense_mask_from_intervals(vecs, S, S)
             & torch.ones(S, S, dtype=torch.bool, device=q.device).tril())
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def lib_fwd_bwd():
        o = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=dense, scale=scale)
        torch.autograd.grad(o, leaves, do)

    library_ms = cuda_ms(lib_fwd_bwd, iters=5, warmup=1)
    del dense, leaves
    n_q, rows_f32 = B * H * S * D, B * H * S * 4
    extra = vecs.numel() * 4
    bounds = {"dq": bound(6 * n_q * 2 + 2 * rows_f32 + extra, 6 * pairs * D),
              "dkv": bound(6 * n_q * 2 + 2 * rows_f32 + extra,
                           8 * pairs * D)}
    table = FM._tile_table(vecs)
    tiles = {}
    for key, (rows, keys) in (("dq", FM.DQ_TILE), ("dkv", FM.DKV_TILE)):
        cls = FM._tile_classes(table, S, rows, keys)
        r = torch.arange(cls.shape[-2], device=q.device)[:, None] * rows
        c = torch.arange(cls.shape[-1], device=q.device)[None] * keys
        reach = c <= r + rows - 1            # causal: the tile has a pair
        tiles[key] = {name: int(((cls == i) & reach).sum()) * H
                      for i, name in enumerate(("skip", "partial", "clean"))}
    return {"max_abs_err": errs, "max_row_rel_err": row_err,
            "fault_rows_caught": caught_share,
            "fault_min_row_rel_err": fault, "ms": ms,
            "k2_unmasked_ms": k2_ms,
            "ms_over_k2": {key: ms[key] / k2_ms[key] for key in ms},
            "plain_ms": plain_ms, "library_fwd_bwd_ms": library_ms,
            "bound_ms": {key: b[0] for key, b in bounds.items()},
            "bound_by": {key: b[1] for key, b in bounds.items()},
            "tiles": tiles}


def phase_flash(FA, gen, name, B, H, kvh, sq, sk, D, causal=True):
    """K1 forward and the K2 dq and dk/dv kernels against their plain
    versions in bf16, causal unless told otherwise (BERT's attention is
    not), on [B, S, H, D] tensors passed as the transposed views ``sdpa``
    hands over.  The backward kernels and
    their plain versions take the same (q, k, v, out, lse, dout): the
    kernel forward's out and lse.  Two runs must give the same bits."""
    dev, dt = "cuda", torch.bfloat16
    scale = 1.0 / math.sqrt(D)
    q, k, v, do = (torch.randn(B, s, n, D, device=dev, generator=gen)
                   .to(dt).transpose(1, 2)
                   for s, n in ((sq, H), (sk, kvh), (sk, kvh), (sq, H)))
    out, lse = FA._flash_fwd(q, k, v, causal, scale)
    dq, delta = FA._flash_bwd_dq(q, k, v, out, lse, do, causal, scale)
    dk, dv = FA._flash_bwd_dkv(q, k, v, lse, delta, do, causal, scale)
    torch.cuda.synchronize()
    errs, rows = {}, {}
    ref, ref_lse = FA._flash_fwd_xla(q, k, v, causal, scale)
    live = ref_lse != FA.LSE_INVALID                 # rows that see a key
    require(bool((lse[~live] == FA.LSE_INVALID).all()),
            f"flash fwd {name}: rows with no key must get LSE_INVALID")
    rows["out"] = row_rel_err(out, ref)
    errs["out"] = (out.float() - ref.float()).abs().max().item()
    ref_dq = FA._flash_bwd_dq_xla(q, k, v, out, lse, do, causal, scale)
    rows["dq"] = grad_row_err(dq, ref_dq)
    errs["dq"] = (dq.float() - ref_dq.float()).abs().max().item()
    ref_dk, ref_dv = FA._flash_bwd_dkv_xla(q, k, v, out, lse, do, causal,
                                           scale)
    for key, got, want in (("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        rows[key] = grad_row_err(got, want)
        errs[key] = (got.float() - want.float()).abs().max().item()
    row_err = {key: r.max().item() for key, r in rows.items()}
    for key, err in row_err.items():
        require(err <= ROW_TOL, f"flash {key} kernel vs plain at {name}: "
                f"row error {err} > {ROW_TOL}")
    again = (*FA._flash_fwd(q, k, v, causal, scale),
             *FA._flash_bwd_dq(q, k, v, out, lse, do, causal, scale),
             *FA._flash_bwd_dkv(q, k, v, lse, delta, do, causal, scale))
    require(all(torch.equal(a, b) for a, b in zip(
        again, (out, lse, dq, delta, dk, dv))),
        f"flash kernels at {name}: two runs differ")
    del again
    # planted fault: every kernel told 64 keys fewer than there are.  Not
    # causal, the kept keys' probabilities move only through the lse, so
    # there the backward takes the faulty forward's out and lse (causal,
    # the shorter key axis moves every row's visible keys already)
    kf, vf = k[:, :, :-FAULT_KEYS], v[:, :, :-FAULT_KEYS]
    f_out, f_lse = FA._flash_fwd(q, kf, vf, causal, scale)
    b_out, b_lse = (out, lse) if causal else (f_out, f_lse)
    f_dq, f_delta = FA._flash_bwd_dq(q, kf, vf, b_out, b_lse, do, causal,
                                     scale)
    f_dk, f_dv = FA._flash_bwd_dkv(q, kf, vf, b_lse, f_delta, do, causal,
                                   scale)
    # a row that sees one key has dq = 0 (ds = p (dp - delta), delta =
    # dp): the dq check covers the rows that see two or more
    multi = (torch.arange(sq, device=dev) + (sk - sq) >= 1)[None, None]
    fault_rows = {
        "out": row_rel_err(f_out, ref)[live],
        "dq": grad_row_err(f_dq, ref_dq)[live & multi],
        "dk": grad_row_err(f_dk, ref_dk[:, :, :-FAULT_KEYS]),
        "dv": grad_row_err(f_dv, ref_dv[:, :, :-FAULT_KEYS])}
    fault = {key: r.min().item() for key, r in fault_rows.items()}
    caught = {key: (r > ROW_TOL).float().mean().item()
              for key, r in fault_rows.items()}
    del ref, ref_dq, ref_dk, ref_dv, f_out, f_lse, f_dq, f_dk, f_dv
    del fault_rows, b_out, b_lse
    # every output row must see the fault; a gradient row sums over all
    # the rows (or keys) it meets, so losing 64 of ~8000 terms moves a
    # few rows in 10^5 by less than the limit: 99 % of them must fail
    require(caught["out"] == 1.0, f"planted fault ({FAULT_KEYS} keys "
            f"dropped) passed the flash out check at {name} on some rows: "
            f"min row error {fault['out']}")
    for key in ("dq", "dk", "dv"):
        require(caught[key] >= FAULT_SHARE, f"planted fault ({FAULT_KEYS} "
                f"keys dropped) failed the flash {key} check at {name} on "
                f"only {caught[key]:.4f} of the rows (< {FAULT_SHARE})")

    ms = {"fwd": cuda_ms(lambda: FA._flash_fwd(q, k, v, causal, scale)),
          "dq": cuda_ms(lambda: FA._flash_bwd_dq(q, k, v, out, lse, do,
                                                 causal, scale)),
          "dkv": cuda_ms(lambda: FA._flash_bwd_dkv(q, k, v, lse, delta, do,
                                                   causal, scale))}
    plain = {"fwd": cuda_ms(lambda: FA._flash_fwd_xla(q, k, v, causal,
                                                      scale),
                            iters=3, warmup=1),
             "dq": cuda_ms(lambda: FA._flash_bwd_dq_xla(
                 q, k, v, out, lse, do, causal, scale), iters=3, warmup=1),
             "dkv": cuda_ms(lambda: FA._flash_bwd_dkv_xla(
                 q, k, v, out, lse, do, causal, scale), iters=3, warmup=1)}
    # yardstick: one scaled_dot_product_attention call (never on the
    # port's path), bottom-right causal where the row is; forward, and
    # forward + backward
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = None if sq == sk or not causal else torch.ones(
        sq, sk, dtype=torch.bool, device=dev).tril(sk - sq)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def lib_fwd():
        return sdpa(q, k, v, attn_mask=mask,
                    is_causal=causal and mask is None, scale=scale,
                    enable_gqa=kvh != H)

    def lib_fwd_bwd():
        o = sdpa(*leaves, attn_mask=mask, is_causal=causal and mask is None,
                 scale=scale, enable_gqa=kvh != H)
        torch.autograd.grad(o, leaves, do)

    library = {"fwd": cuda_ms(lib_fwd), "fwd_bwd": cuda_ms(lib_fwd_bwd)}
    pairs = (visible_pairs(sq, sk) if causal else sq * sk) * B * H
    item = 2
    n_q, n_kv = B * H * sq * D, B * kvh * sk * D
    rows_f32 = B * H * sq * 4                            # lse or delta
    bounds = {
        "fwd": bound((2 * n_q + 2 * n_kv) * item + rows_f32, 4 * pairs * D),
        "dq": bound((4 * n_q + 2 * n_kv) * item + 2 * rows_f32,
                    6 * pairs * D),
        "dkv": bound((2 * n_q + 4 * n_kv) * item + 2 * rows_f32,
                     8 * pairs * D)}
    shape = {"kernel": "flash_attention", "shape": name, "dtype": "bfloat16",
             "B": B, "H": H, "kvh": kvh, "D": D, "sq": sq, "sk": sk,
             "causal": causal, "dead_rows": int((~live).sum()),
             "max_abs_err": errs, "max_row_rel_err": row_err,
             "row_tol": ROW_TOL, "fault_min_row_rel_err": fault,
             "fault_rows_caught": caught, "rerun_bit_equal": True, "ms": ms,
             "plain_ms": plain, "library_ms": library,
             "bound_ms": {key: b[0] for key, b in bounds.items()},
             "bound_by": {key: b[1] for key, b in bounds.items()},
             "exp_count": pairs, "exp_ms_at_mufu_rate":
                 pairs / EXP_PER_S * 1e3}
    emit({"phase": 3, **shape})
    return shape


def alibi_bias(H, S, dev):
    """ALiBi (Press et al., the public recipe): head h = 1..H adds
    -m_h * (i - j) to the logit of query i and key j, m_h = 2^(-8h/H);
    [1, H, S, S] float32."""
    m = 2.0 ** (-8.0 * torch.arange(1, H + 1, device=dev) / H)
    pos = torch.arange(S, device=dev, dtype=torch.float32)
    return (-m[:, None, None] * (pos[:, None] - pos[None, :]))[None]


def k8_operands(FM, kind, B, H, S, dev):
    """(mask_vecs, bias) of one phase-3 K8 shape at length S: the SFT key
    padding (lengths SFT_LENGTHS scaled to S), the packed documents
    (PACKED_DOCS scaled to S, non-causal: nvec 4) or the ALiBi bias."""
    if kind == "padding":
        real = torch.tensor([max(1, round(x * S)) for x in SFT_LENGTHS],
                            device=dev)
        keep = torch.arange(S, device=dev)[None] < real[:B, None]
        return FM.padding_mask_to_intervals(keep, S), None
    if kind == "segments":
        sizes = [round(x * S) for x in PACKED_DOCS]
        sizes[-1] = S - sum(sizes[:-1])
        seg = torch.repeat_interleave(torch.arange(len(sizes), device=dev),
                                      torch.tensor(sizes, device=dev))
        return FM.segment_intervals(seg[None].expand(B, S), causal=False), \
            None
    return None, alibi_bias(H, S, dev)


def k8_fault(FM, kind, k, v, vecs, bias, S):
    """The planted fault: every query row loses its last FAULT_KEYS keys.
    Causal: the last 64 keys go, so bottom-right alignment moves every
    row's diagonal 64 keys left (and the padding ends 64 keys earlier);
    the packed documents: the last 64 keys of every document are masked
    for every row.  Returns (k, v, mask_vecs, bias, keys kept)."""
    if kind == "segments":
        lts = vecs[:, :, 0]                     # the column's document end
        drop = torch.arange(S, device=k.device) >= lts - FAULT_KEYS
        fv = vecs.clone()
        fv[:, :, 0] = torch.where(drop, 0, lts)
        return k, v, fv, None, S
    n = S - FAULT_KEYS
    kf, vf = k[:, :, :n], v[:, :, :n]
    if kind == "padding":
        real = vecs[:, 0, 0] == S               # key columns that are real
        keep = real[:, :n] & (torch.arange(n, device=k.device)[None]
                              < real.sum(-1, keepdim=True) - FAULT_KEYS)
        return kf, vf, FM.padding_mask_to_intervals(keep, S), None, n
    return kf, vf, None, bias[..., :n], n


def visible_count(FM, vecs, B, H, sq, sk, causal, dev):
    """(query, key) pairs the mask leaves visible, over batch and heads."""
    allowed = torch.ones(sq, sk, dtype=torch.bool, device=dev)
    if causal:
        allowed = allowed.tril(sk - sq)
    if vecs is None:
        return int(allowed.sum()) * B * H
    dense = FM.dense_mask_from_intervals(vecs, sq, sk) & allowed
    return int(dense.sum()) * (B // dense.shape[0]) * (H // dense.shape[1])


def bias_read_bytes(FM, vecs, bias, sq, sk, causal, dev):
    """Bytes of ``bias`` that a K8 kernel must read: each element at a
    (query, key) pair that some (batch, head) it serves sees (for a
    causal call, the lower triangle only)."""
    seen = torch.ones(sq, sk, dtype=torch.bool, device=dev)
    if causal:
        seen = seen.tril(sk - sq)
    if vecs is None:
        return int(seen.sum()) * bias.shape[0] * bias.shape[1] \
            * bias.element_size()
    seen = FM.dense_mask_from_intervals(vecs, sq, sk) & seen
    for dim in (0, 1):          # a bias broadcast over a dim the mask is not
        if bias.shape[dim] == 1 and seen.shape[dim] > 1:
            seen = seen.any(dim, keepdim=True)
    return (int(seen.sum()) * (bias.shape[0] // seen.shape[0])
            * (bias.shape[1] // seen.shape[1]) * bias.element_size())


def k8_run(FM, q, k, v, do, vecs, bias, causal, scale):
    """The K8 kernels once: forward with lse, dq (+ delta), dk/dv and, with
    a bias, dbias."""
    out, lse = FM._masked_fwd(q, k, v, vecs, bias, causal, scale, True)
    dq, delta = FM._masked_bwd_dq(q, k, v, out, lse, do, vecs, bias, causal,
                                  scale)
    dk, dv = FM._masked_bwd_dkv(q, k, v, lse, delta, do, vecs, bias, causal,
                                scale)
    dbias = (FM._masked_bwd_dbias(q, k, v, lse, delta, do, vecs, bias,
                                  causal, scale) if bias is not None else None)
    return {"out": out, "lse": lse, "delta": delta, "dq": dq, "dk": dk,
            "dv": dv, "dbias": dbias}


def caught(err, ref):
    """Share of rows that carry a gradient (||ref|| above grad_row_err's
    floor, where the check is relative) on which ``err`` exceeds the
    limit, and its smallest value there."""
    norm = ref.float().norm(dim=-1)
    floor = 2 ** -6 * norm.square().mean().sqrt()
    e = err[norm > floor]
    return (e > ROW_TOL).float().mean().item(), e.min().item()


def phase_k8(FM, gen, name, B, H, kvh, S, causal, kind, D):
    """The K8 forward (with lse), dq, dk/dv and (ALiBi) dbias kernels
    against their plain versions in bf16, per row, on the transposed
    [B, S, H, D] views ``sdpa`` passes; the planted fault (k8_fault) must
    fail every live out row and >= FAULT_SHARE of the gradient rows; two
    runs give the same bits; the times of kernel, plain version, bound
    and library."""
    dev, dt = "cuda", torch.bfloat16
    scale = 1.0 / math.sqrt(D)
    q, k, v, do = (torch.randn(B, S, n, D, device=dev, generator=gen)
                   .to(dt).transpose(1, 2) for n in (H, kvh, kvh, H))
    vecs, bias = k8_operands(FM, kind, B, H, S, dev)
    got = k8_run(FM, q, k, v, do, vecs, bias, causal, scale)
    torch.cuda.synchronize()
    plain = (q, k, v, got["out"], got["lse"], do, vecs, bias, causal, scale)
    ref_out, ref_lse = FM._masked_fwd_xla(q, k, v, vecs, bias, causal, scale)
    live = ref_lse != FM.LSE_INVALID
    require(bool((got["lse"][~live] == FM.LSE_INVALID).all()),
            f"K8 {name}: rows with no key must get LSE_INVALID")
    refs = {"out": ref_out, "dq": FM._masked_bwd_dq_xla(*plain)}
    refs["dk"], refs["dv"] = FM._masked_bwd_dkv_xla(*plain)
    if bias is not None:
        refs["dbias"] = FM._masked_bwd_dbias_xla(*plain)
    rows = {key: (row_rel_err if key == "out" else grad_row_err)(
        got[key], ref) for key, ref in refs.items()}
    errs = {key: (got[key].float() - ref.float()).abs().max().item()
            for key, ref in refs.items()}
    row_err = {key: r.max().item() for key, r in rows.items()}
    for key, err in row_err.items():
        require(err <= ROW_TOL, f"K8 {key} kernel vs plain at {name}: row "
                f"error {err} > {ROW_TOL}")
    again = k8_run(FM, q, k, v, do, vecs, bias, causal, scale)
    require(all(got[key] is None or torch.equal(got[key], again[key])
                for key in got), f"K8 kernels at {name}: two runs differ")
    del again
    kf, vf, fvecs, fbias, n = k8_fault(FM, kind, k, v, vecs, bias, S)
    bad = k8_run(FM, q, kf, vf, do, fvecs, fbias, causal, scale)
    fault_rows = {"out": row_rel_err(bad["out"], ref_out)[live]}
    caught_share = {"out": (fault_rows["out"] > ROW_TOL).float().mean()
                    .item()}
    fault = {"out": fault_rows["out"].min().item()}
    for key in refs:
        if key == "out":
            continue
        ref = refs[key][..., :n] if key == "dbias" else (
            refs[key][:, :, :n] if key in ("dk", "dv") else refs[key])
        caught_share[key], fault[key] = caught(grad_row_err(bad[key], ref),
                                               ref)
    del bad, refs, ref_out, rows
    require(caught_share["out"] == 1.0, f"planted fault ({FAULT_KEYS} keys "
            f"dropped) passed the K8 out check at {name} on some rows: min "
            f"row error {fault['out']}")
    for key, share in caught_share.items():
        require(share >= FAULT_SHARE, f"planted fault ({FAULT_KEYS} keys "
                f"dropped) failed the K8 {key} check at {name} on only "
                f"{share:.4f} of the rows (< {FAULT_SHARE})")

    out, lse, delta = got["out"], got["lse"], got["delta"]
    args = (vecs, bias, causal, scale)
    calls = {
        "fwd": (lambda: FM._masked_fwd(q, k, v, *args, True),
                lambda: FM._masked_fwd_xla(q, k, v, *args)),
        "dq": (lambda: FM._masked_bwd_dq(q, k, v, out, lse, do, *args),
               lambda: FM._masked_bwd_dq_xla(*plain)),
        "dkv": (lambda: FM._masked_bwd_dkv(q, k, v, lse, delta, do, *args),
                lambda: FM._masked_bwd_dkv_xla(*plain))}
    if bias is not None:
        calls["dbias"] = (
            lambda: FM._masked_bwd_dbias(q, k, v, lse, delta, do, *args),
            lambda: FM._masked_bwd_dbias_xla(*plain))
    ms = {key: cuda_ms(kern) for key, (kern, _) in calls.items()}
    plain_ms = {key: cuda_ms(fn, iters=3, warmup=1)
                for key, (_, fn) in calls.items()}
    # yardstick: scaled_dot_product_attention with the dense mask (bool,
    # or the bias with -inf right of the diagonal), forward and forward +
    # backward (the bias's gradient too, where there is one)
    tril = torch.ones(S, S, dtype=torch.bool, device=dev)
    if causal:
        tril = tril.tril()
    if bias is None:
        mask = FM.dense_mask_from_intervals(vecs, S, S) & tril
    else:                      # SDPA takes a float mask in q's dtype
        mask = bias.masked_fill(~tril, -math.inf).to(dt)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_mask = mask if bias is None else mask.detach().requires_grad_()

    def lib_fwd_bwd():
        o = sdpa(*leaves, attn_mask=lib_mask, scale=scale,
                 enable_gqa=kvh != H)
        wrt = leaves + ([lib_mask] if bias is not None else [])
        torch.autograd.grad(o, wrt, do)

    library = {"fwd": cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask,
                                           scale=scale, enable_gqa=kvh != H)),
               "fwd_bwd": cuda_ms(lib_fwd_bwd, iters=5, warmup=1)}
    del mask, lib_mask, leaves
    pairs = visible_count(FM, vecs, B, H, S, S, causal, dev)
    item = 2
    n_q, n_kv = B * H * S * D, B * kvh * S * D
    rows_f32 = B * H * S * 4                             # lse or delta
    extra = vecs.numel() * 4 if vecs is not None else 0   # intervals read
    if bias is not None:                 # the bias where some row sees it
        extra += bias_read_bytes(FM, vecs, bias, S, S, causal, dev)
    bounds = {
        "fwd": bound((2 * n_q + 2 * n_kv) * item + rows_f32 + extra,
                     4 * pairs * D),
        "dq": bound((4 * n_q + 2 * n_kv) * item + 2 * rows_f32 + extra,
                    6 * pairs * D),
        "dkv": bound((2 * n_q + 4 * n_kv) * item + 2 * rows_f32 + extra,
                     8 * pairs * D)}
    if bias is not None:                    # reads the bias, writes dbias
        bounds["dbias"] = bound((2 * n_q + 2 * n_kv) * item + 2 * rows_f32
                                + extra + bias.numel() * bias.element_size(),
                                4 * pairs * D)
    rec = {"kernel": "flash_mask_k8", "shape": name, "dtype": "bfloat16",
           "B": B, "H": H, "kvh": kvh, "D": D, "S": S, "causal": causal,
           "mask": kind, "nvec": vecs.shape[2] if vecs is not None else 0,
           "bias": list(bias.shape) if bias is not None else None,
           "visible_pairs": pairs, "dead_rows": int((~live).sum()),
           "max_abs_err": errs, "max_row_rel_err": row_err,
           "row_tol": ROW_TOL, "fault_min_row_rel_err": fault,
           "fault_rows_caught": caught_share, "rerun_bit_equal": True,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library,
           "bound_ms": {key: b[0] for key, b in bounds.items()},
           "bound_by": {key: b[1] for key, b in bounds.items()}}
    emit({"phase": 3, **rec})
    return rec


def phase_k8_f32(FM, name, B, H, kvh, causal, kind, D, S=512):
    """A float32 instance of a phase-3 K8 shape at S 512: the kernels on
    the card vs the plain versions on the CPU from the same inputs (made
    on the host from a seed), by relative norm (phase 7's limit)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(3)
    scale = 1.0 / math.sqrt(D)
    q, k, v, do = (torch.randn(B, S, n, D, generator=gen).transpose(1, 2)
                   for n in (H, kvh, kvh, H))
    vecs, bias = k8_operands(FM, kind, B, H, S, "cpu")
    res = {}
    for device in ("cuda", "cpu"):
        on = [None if t is None else t.to(device)
              for t in (q, k, v, do, vecs, bias)]
        out, lse = FM._masked_fwd(*on[:3], on[4], on[5], causal, scale, True)
        dq, dk, dv, dbias = FM._masked_bwd(*on[:3], out, lse, on[3], on[4],
                                           on[5], causal, scale,
                                           need_dbias=bias is not None)
        res[device] = {"out": out, "dq": dq, "dk": dk, "dv": dv,
                       "dbias": dbias}
    errs = {key: rel_norm(res["cuda"][key], res["cpu"][key])
            for key in res["cpu"] if res["cpu"][key] is not None}
    emit({"phase": 3, "kernel": "flash_mask_k8", "shape": name,
          "dtype": "float32", "S": S, "B": B, "H": H, "kvh": kvh, "D": D,
          "card_vs_cpu_rel_err": errs, "tol": PARITY_TOL})
    for key, err in errs.items():
        require(err <= PARITY_TOL, f"K8 f32 {key} at {name}: card vs CPU "
                f"{err} > {PARITY_TOL}")
    return errs


def phase_flash_f32(FA, D, B=2, H=8, kvh=2, S=512):
    """The float32 K1 forward and K2 dq and dk/dv at head dim ``D`` (B 2,
    8 q over 2 kv heads, S 512, causal): the kernels on the card vs the
    plain versions on the CPU from the same inputs (made on the host from
    a seed), by relative norm (phase 7's limit)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(4)
    scale = 1.0 / math.sqrt(D)
    q, k, v, do = (torch.randn(B, S, n, D, generator=gen).transpose(1, 2)
                   for n in (H, kvh, kvh, H))
    res = {}
    for device in ("cuda", "cpu"):
        on = [t.to(device) for t in (q, k, v, do)]
        out, lse = FA._flash_fwd(*on[:3], True, scale)
        grads = FA._flash_bwd(*on[:3], out, lse, on[3], True, scale)
        res[device] = dict(zip(("out", "dq", "dk", "dv"), (out, *grads)))
    errs = {key: rel_norm(res["cuda"][key], res["cpu"][key])
            for key in res["cpu"]}
    emit({"phase": 3, "kernel": "flash_attention", "shape": f"f32_d{D}",
          "dtype": "float32", "S": S, "B": B, "H": H, "kvh": kvh, "D": D,
          "card_vs_cpu_rel_err": errs, "tol": PARITY_TOL})
    for key, err in errs.items():
        require(err <= PARITY_TOL, f"K1/K2 f32 {key} at head_dim {D}: card "
                f"vs CPU {err} > {PARITY_TOL}")
    return errs


def phase_dbias_long(FM, gen):
    """The K8 dbias at 10d's shape (b 1, h 16, s 8192, causal, the f32
    ALiBi bias [1, 16, S, S]: one member per CTA, no read-back) in bf16:
    against its plain version per gradient row, the planted fault
    (k8_fault: the last 64 keys dropped) failing >= FAULT_SHARE of the
    rows, two calls bit-identical; its time beside phase_k8's dbias
    bound, the plain version's and one forward + backward of
    scaled_dot_product_attention with the bias's gradient."""
    dev, dt, D, B, H, S = "cuda", torch.bfloat16, 128, 1, 16, LONGCTX_SEQ
    name, scale = "alibi_8192", 1.0 / math.sqrt(D)
    q, k, v, do = (torch.randn(B, S, H, D, device=dev, generator=gen)
                   .to(dt).transpose(1, 2) for _ in range(4))
    bias = alibi_bias(H, S, dev)
    got = k8_run(FM, q, k, v, do, None, bias, True, scale)
    torch.cuda.synchronize()
    out, lse, delta, dbias = (got[key] for key in ("out", "lse", "delta",
                                                   "dbias"))
    del got
    args = (None, bias, True, scale)
    require(torch.equal(dbias, FM._masked_bwd_dbias(q, k, v, lse, delta, do,
                                                    *args)),
            f"dbias {name}: two calls differ")
    plain = (q, k, v, out, lse, do, None, bias, True, scale)
    ref = FM._masked_bwd_dbias_xla(*plain)
    row_err = grad_row_err(dbias, ref).max().item()
    err = (dbias.float() - ref.float()).abs().max().item()
    require(row_err <= ROW_TOL, f"K8 dbias kernel vs plain at {name}: row "
            f"error {row_err} > {ROW_TOL}")
    del dbias
    kf, vf, _, fbias, n = k8_fault(FM, "alibi", k, v, None, bias, S)
    bad = k8_run(FM, q, kf, vf, do, None, fbias, True, scale)["dbias"]
    share, fault = caught(grad_row_err(bad, ref[..., :n]), ref[..., :n])
    del bad, ref
    require(share >= FAULT_SHARE, f"planted fault ({FAULT_KEYS} keys "
            f"dropped) failed the K8 dbias check at {name} on only "
            f"{share:.4f} of the rows (< {FAULT_SHARE})")
    ms = cuda_ms(lambda: FM._masked_bwd_dbias(q, k, v, lse, delta, do,
                                              *args), iters=5, warmup=1)
    plain_ms = cuda_ms(lambda: FM._masked_bwd_dbias_xla(*plain), iters=2,
                       warmup=1)
    n_q = B * H * S * D
    bound_ms, bound_by = bound(
        4 * n_q * 2 + 2 * B * H * S * 4
        + bias_read_bytes(FM, None, bias, S, S, True, dev)
        + bias.numel() * bias.element_size(),
        4 * visible_count(FM, None, B, H, S, S, True, dev) * D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tril = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    lib_mask = bias.masked_fill(~tril, -math.inf).to(dt).requires_grad_()
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def lib_fwd_bwd():
        o = sdpa(*leaves, attn_mask=lib_mask, scale=scale)
        torch.autograd.grad(o, leaves + [lib_mask], do)

    library_ms = cuda_ms(lib_fwd_bwd, iters=3, warmup=1)
    rec = {"kernel": "flash_mask_bwd_dbias", "shape": name,
           "dtype": "bfloat16", "B": B, "H": H, "D": D, "S": S,
           "causal": True, "bias": list(bias.shape), "max_abs_err": err,
           "max_row_rel_err": row_err, "row_tol": ROW_TOL,
           "fault_min_row_rel_err": fault, "fault_rows_caught": share,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_fwd_bwd_ms": library_ms}
    emit({"phase": 3, **rec})
    return rec


# the head-dim routes on the card: llama_tiny's head_dim (32), outside the
# reference's kernel dims {64, 128, 256}
ROUTE_D = 32


def phase_routes(FA, FM, DA, PA, G, init_state, create_engine,
                 GenerationConfig):
    """The head-dim routes on the card, the reference's rule
    (flash_attention.py:264-269, decode_attention.py:164-172,
    paged_attention.py:58-61): at d 32, ``sdpa`` unmasked, with flashmask
    intervals and with a bias (each with its gradients) and
    ``decode_attention`` run the plain versions on CUDA, launch no kernel
    and agree with the CPU from the same inputs (f32, relative norm,
    phase 7's limit), and ``llama_tiny``'s greedy ``generate`` gives the
    CPU's tokens with no kernel launched; ``llama_tiny``'s engine (paged
    decode) launches K3 at d 32 and gives the CPU's tokens; at d 64 and
    256 the same three ``sdpa`` calls in bf16 (:func:`kernel_routes`)
    launch K1/K2 or K8, once each, and agree per row with the plain
    versions, and K3 launches at d 64 and agrees with its plain version
    per row (K7 runs d 64: phase 3's ``tinyllama_d64``).  Returns the
    launches of the d 64 and d 256 calls."""
    from paddle_tpu_torch.models import llama_tiny
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(5)
    B, S, H, kvh, D = 2, 256, 4, 2, ROUTE_D
    q, k, v, do = (torch.randn(B, S, n, D, generator=g)
                   for n in (H, kvh, kvh, H))
    keep = torch.arange(S)[None] < torch.tensor([S, 100])[:, None]
    tensors = (q, k, v, FM.padding_mask_to_intervals(keep, S),
               torch.randn(1, H, S, S, generator=g) * 0.5,
               torch.randn(B, H, D, generator=g),
               *(torch.randn(B, kvh, S, D, generator=g) for _ in range(2)),
               torch.tensor([S - 1, 77], dtype=torch.int32))
    calls = {
        "sdpa": lambda t: sq_loss_grads(
            lambda q, k, v: FA.sdpa(q, k, v, is_causal=True), t[:3]),
        "flashmask": lambda t: sq_loss_grads(
            lambda q, k, v: FA.sdpa(q, k, v, flashmask=t[3], is_causal=True),
            t[:3]),
        "bias": lambda t: sq_loss_grads(
            lambda q, k, v, b: FA.sdpa(q, k, v, attn_mask=b, is_causal=True),
            (*t[:3], t[4])),
        "decode": lambda t: (DA.decode_attention(*t[5:]), ())}
    res = {}
    for dev in ("cuda", "cpu"):
        on = tuple(t.to(dev) for t in tensors)
        zero_flash_counts(FA, FM)
        n7 = DA.decode_attention.launches
        res[dev] = {key: fn(on) for key, fn in calls.items()}
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = {k: n for k, n in k8_counts(FA, FM).items() if n}
            require(not launched and DA.decode_attention.launches == n7,
                    f"head_dim {D} launched kernels: {launched}, K7 "
                    f"{DA.decode_attention.launches - n7}")
    errs = {key: max(rel_norm(a, b) for a, b in zip(
        (res["cuda"][key][0], *res["cuda"][key][1]),
        (res["cpu"][key][0], *res["cpu"][key][1]))) for key in calls}
    for key, err in errs.items():
        require(err <= PARITY_TOL, f"head_dim {D} {key}: card vs CPU {err} "
                f"> {PARITY_TOL}")
    cfg = dataclasses.replace(llama_tiny(), dtype="float32")
    state = init_state(cfg, torch.Generator().manual_seed(6), device="cpu")
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 40))
    lengths = np.array([40, 17, 33], np.int32)
    tokens = {}
    for dev in ("cuda", "cpu"):
        zero_flash_counts(FA, FM)
        n7, n3 = DA.decode_attention.launches, PA.paged_attention.launches
        tokens[dev] = G.generate({k: t.to(dev) for k, t in state.items()},
                                 cfg, ids, max_new_tokens=16, lengths=lengths,
                                 device=dev)[:, 40:].tolist()
        require(not any(k8_counts(FA, FM).values())
                and DA.decode_attention.launches == n7
                and PA.paged_attention.launches == n3,
                f"llama_tiny generate on {dev} launched a kernel")
    require(tokens["cuda"] == tokens["cpu"], f"llama_tiny (head_dim "
            f"{cfg.head_dim}) greedy tokens card {tokens['cuda']} vs CPU "
            f"{tokens['cpu']}")
    engine_tokens, engine_k3 = {}, {}
    prompts = [ids[0, :40], ids[1, :17], ids[2, :33]]
    for dev in ("cuda", "cpu"):
        engine = create_engine(cfg, {k: t.to(dev) for k, t in state.items()},
                               device=dev, max_slots=2, page_size=8,
                               max_model_len=128)
        n3 = PA.paged_attention.launches
        reqs = [engine.submit(p, GenerationConfig(max_new_tokens=12))
                for p in prompts]
        engine.run_until_complete()
        engine_tokens[dev] = [r.output_tokens for r in reqs]
        engine_k3[dev] = PA.paged_attention.launches - n3
    require(engine_k3["cuda"] > 0 and engine_k3["cpu"] == 0,
            f"llama_tiny engine K3 launches {engine_k3}")
    require(engine_tokens["cuda"] == engine_tokens["cpu"],
            f"llama_tiny engine (head_dim {cfg.head_dim}, K3) tokens card "
            f"{engine_tokens['cuda']} vs CPU {engine_tokens['cpu']}")
    # the reference's tensor-parallel test model (head_dim 8): K3's
    # CUDA-core body in the engine's decode steps, the CPU's tokens
    cfg8 = dataclasses.replace(llama_tiny(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_attention_heads=8, num_key_value_heads=8), dtype="float32")
    state8 = init_state(cfg8, torch.Generator().manual_seed(23),
                        device="cpu")
    any_tokens, any_k3 = {}, {}
    for dev in ("cuda", "cpu"):
        engine = create_engine(cfg8, {k: t.to(dev) for k, t in
                                      state8.items()},
                               device=dev, max_slots=2, page_size=8,
                               max_model_len=64)
        n3 = PA.paged_attention.launches
        reqs = [engine.submit(p % cfg8.vocab_size,
                              GenerationConfig(max_new_tokens=8))
                for p in prompts]
        engine.run_until_complete()
        any_tokens[dev] = [r.output_tokens for r in reqs]
        any_k3[dev] = PA.paged_attention.launches - n3
    require(PA._body(cfg8.head_dim) == "any" and any_k3["cuda"] > 0
            and any_k3["cpu"] == 0, f"head_dim 8 engine K3 launches {any_k3}")
    require(any_tokens["cuda"] == any_tokens["cpu"],
            f"head_dim 8 engine (K3's CUDA-core body) tokens card "
            f"{any_tokens['cuda']} vs CPU {any_tokens['cpu']}")
    kernel_errs, kernel_launches = {}, {}
    for d in NEW_HEAD_DIMS:
        kernel_errs[d], kernel_launches[d] = kernel_routes(FA, FM, d)
    x = torch.randn(1, 128, 4, 64, device="cuda", dtype=torch.bfloat16)
    one = torch.ones(1, 1, dtype=torch.int32, device="cuda")
    pool = torch.randn(3, 2, 64, 64, device="cuda", dtype=torch.bfloat16)
    lens = torch.full((1,), 50, dtype=torch.int32, device="cuda")
    n3 = PA.paged_attention.launches
    paged = PA.paged_attention(x[:, 0], pool, pool, one, lens)
    require(PA.paged_attention.launches == n3 + 1, "paged_d64: no launch")
    paged_err = row_rel_err(paged, PA.paged_attention_xla(
        x[:, 0], pool, pool, one, lens)).max().item()
    require(paged_err <= ROW_TOL, f"paged_d64: row error {paged_err}")
    rec = {"phase": 3, "routes": {"head_dim": D, "card_vs_cpu_rel_err": errs,
                                  "tol": PARITY_TOL,
                                  "llama_tiny_tokens_equal": True,
                                  "llama_tiny_engine_tokens_equal": True,
                                  "llama_tiny_engine_k3_launches":
                                      engine_k3["cuda"],
                                  "d8_engine_tokens_equal": True,
                                  "d8_engine_k3_launches": any_k3["cuda"],
                                  "paged_d64_row_err": paged_err,
                                  "kernel_row_err": kernel_errs,
                                  "kernel_launches": kernel_launches}}
    emit(rec)
    kernel_launches["paged_any"] = any_k3["cuda"]
    return kernel_launches


def kernel_routes(FA, FM, D):
    """``sdpa`` at head dim ``D`` on the card in bf16 (B 2, S 256, 8 q
    over 2 kv heads, causal): unmasked, with flashmask key padding and
    with a float bias that takes a gradient, each with the gradients of
    sum(out.float() ** 2).  Each must launch its kernels once (K1 and K2;
    the K8 forward with lse, dq and dk/dv; the biased forward, dq, dk/dv
    and dbias) and agree per row with the plain versions fed the same
    inputs, the kernel forward's out and lse and the loss's cotangent
    (:func:`check_against_plain`).  Returns (worst row error per call,
    launches)."""
    g = torch.Generator(device="cuda").manual_seed(8)
    B, S, H, kvh, dt = 2, 256, 8, 2, torch.bfloat16
    q, k, v = (torch.randn(B, S, n, D, device="cuda", generator=g).to(dt)
               for n in (H, kvh, kvh))
    keep = (torch.arange(S, device="cuda")[None]
            < torch.tensor([S, 150], device="cuda")[:, None])
    vecs = FM.padding_mask_to_intervals(keep, S)
    bias = (torch.randn(1, H, S, S, device="cuda", generator=g)
            * 0.5).to(dt)
    calls = {
        "sdpa": (lambda: sq_loss_grads(
            lambda q, k, v: FA.sdpa(q, k, v, is_causal=True), (q, k, v)),
            None, None,
            {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
             "flash_attention_bwd_dkv": 1}),
        "flashmask": (lambda: sq_loss_grads(
            lambda q, k, v: FA.sdpa(q, k, v, flashmask=vecs, is_causal=True),
            (q, k, v)), vecs, None,
            {"flash_mha_masked": 1, "flash_mha_masked_lse": 1,
             "flash_mask_bwd_dq": 1, "flash_mask_bwd_dkv": 1}),
        "bias": (lambda: sq_loss_grads(
            lambda q, k, v, b: FA.sdpa(q, k, v, attn_mask=b, is_causal=True),
            (q, k, v, bias)), None, bias,
            {"flash_mha_biased": 1, "flash_mha_masked_lse": 1,
             "flash_mask_bwd_dq": 1, "flash_mask_bwd_dkv": 1,
             "flash_mask_bwd_dbias": 1})}
    errs, launches = {}, {}
    for key, (fn, mvecs, mbias, want) in calls.items():
        (out, grads), launches[key] = counted(
            FA, FM, fn, want, f"sdpa {key} at head_dim {D}")
        if key == "sdpa":
            rows = flash_against_plain(FA, f"sdpa d{D}", q, k, v, out, grads)
        else:
            rows = check_against_plain(FM, f"sdpa {key} d{D}", q, k, v, out,
                                       grads, mvecs, mbias, True)
        errs[key] = max(rows.values())
    return errs, launches


def flash_against_plain(FA, name, q, k, v, out, grads):
    """:func:`check_against_plain` for an unmasked causal ``sdpa`` run (K1
    and K2): out, dq, dk and dv per row against the plain versions fed
    the same q/k/v, the kernel forward's out and lse and the cotangent
    2 * out."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    o, lse = FA._flash_fwd(qh, kh, vh, True, scale)
    do = (2 * o.float()).to(o.dtype)
    ref_out, _ = FA._flash_fwd_xla(qh, kh, vh, True, scale)
    rows = {"out": row_rel_err(out.transpose(1, 2), ref_out).max().item()}
    refs = FA._flash_bwd_xla(qh, kh, vh, o, lse, do, True, scale)
    for key, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        rows[key] = grad_row_err(got.transpose(1, 2), ref).max().item()
    for key, err in rows.items():
        require(err <= ROW_TOL, f"{name} {key} vs plain: row error {err} > "
                f"{ROW_TOL}")
    return rows


def int8pack_ms(x, q, scale):
    """The library yardstick for K4 int8: ``torch._weight_int8pack_mm``
    (q transposed to [N, K] outside the timing), where the installed
    torch runs it on CUDA; else (None, why)."""
    qt = q.t().contiguous()
    sc = scale.to(x.dtype)
    try:
        torch._weight_int8pack_mm(x, qt, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, str(e).splitlines()[0][:120]
    return device_ms(lambda: torch._weight_int8pack_mm(x, qt, sc)), None


def phase_quant(QM, gen):
    """K4 int8 and int4 against the plain version (``_xla_fallback``) in
    bf16 at the llama3_8b decode shapes: M = 8 for every projection, M =
    1 and 64 at gate/up, and M = 8 at the generation path's fused q/k/v,
    fused gate/up and lm_head widths; int8 also at M = 8 at every width
    11a's int8 decode runs (``BENCH_PROJ_SHAPES``).  ``ms``, ``plain_ms`` and the library's
    time are device time per call (``device_ms``); ``events_ms`` is the
    CUDA-event time of back-to-back calls, which the host's per-call
    work sets at these sizes.  Returns one record per (kind, shape)."""
    dev, dt = "cuda", torch.bfloat16
    shapes = [(name, 8, k, n) for name, k, n in PROJ_SHAPES]
    shapes += [("gate/up", 1, 4096, 14336), ("gate/up", 64, 4096, 14336)]
    shapes += [(name, 8, k, n) for name, k, n in GEN_PROJ_SHAPES]
    records = []
    for kind in ("int8", "int4"):
        bound_q = 127 if kind == "int8" else 7
        bench = [(name, 8, k, n) for name, k, n in BENCH_PROJ_SHAPES]
        for name, m, k, n in shapes + (bench if kind == "int8" else []):
            x = torch.randn(m, k, device=dev, generator=gen).to(dt)
            q = torch.randint(-bound_q, bound_q + 1, (k, n), device=dev,
                              generator=gen).to(torch.int8)
            sc = torch.rand(n, device=dev, generator=gen) * 0.02 + 1e-3
            w = (QM.QuantizedWeight(QM.pack_int4(q), sc, "int4", k)
                 if kind == "int4" else QM.QuantizedWeight(q, sc))
            out = QM.weight_only_matmul(x, w)
            torch.cuda.synchronize()
            ref = QM._xla_fallback(x, w)
            rows = row_rel_err(out, ref)
            row_err = rows.max().item()
            require(row_err <= GEMV_ROW_TOL,
                    f"K4 {kind} {name} M={m}: row error {row_err} > "
                    f"{GEMV_ROW_TOL}")
            if kind == "int8":
                bad_q = w.q.clone()
                bad_q[-FAULT_KEYS:] = 0
                bad = QM.QuantizedWeight(bad_q, sc)
            else:
                u = w.q.view(torch.uint8)
                bad = QM.QuantizedWeight(((u >> 4) | (u << 4)).view(
                    torch.int8), sc, "int4", k)
            fault = row_rel_err(QM.weight_only_matmul(x, bad), ref)
            require(bool((fault > GEMV_ROW_TOL).all()),
                    f"planted fault passed the K4 {kind} check at {name} "
                    f"M={m}: min row error {fault.min().item()}")
            ms = device_ms(lambda: QM.weight_only_matmul(x, w))
            wall_ms = cuda_ms(lambda: QM.weight_only_matmul(x, w), iters=50)
            plain_ms = device_ms(lambda: QM._xla_fallback(x, w), iters=5)
            wq = w.q
            dense_w = torch.randn(k, n, device=dev, generator=gen).to(dt)
            dense_ms = device_ms(lambda: x @ dense_w)
            del dense_w
            lib_ms, lib_why = (int8pack_ms(x, q, sc) if kind == "int8"
                               else (None, "no single PyTorch call"))
            nbytes = (wq.numel() + 4 * n + 2 * x.numel() + 2 * m * n)
            bound_ms, bound_by = bound(nbytes, 2 * m * k * n)
            rec = {"kernel": f"weight_only_matmul_{kind}", "shape": name,
                   "M": m, "K": k, "N": n, "dtype": "bfloat16",
                   "max_abs_err": (out.float() - ref.float()).abs().max()
                   .item(), "max_row_rel_err": row_err,
                   "row_tol": GEMV_ROW_TOL,
                   "fault_min_row_rel_err": fault.min().item(),
                   "ms": ms, "events_ms": wall_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": lib_ms, "library_note": lib_why,
                   "dense_bf16_matmul_ms": dense_ms}
            emit({"phase": 3, **rec})
            records.append(rec)
    return records


def phase_lora(LM, gen):
    """K5 against the plain version (``_xla_gather_matmul``) at the
    decode shape: 8 slots, rank 16, a 5-row f32 bank (row 0 zero), idx
    (0, 1, 2, 3, 4, 1, 0, 2), bf16 x, at the four projection shapes."""
    dev, dt = "cuda", torch.bfloat16
    idx = torch.tensor(LORA_IDX, dtype=torch.int32, device=dev)
    zero = idx == 0
    records = []
    for name, k, m in PROJ_SHAPES:
        x = torch.randn(len(LORA_IDX), k, device=dev, generator=gen).to(dt)
        a = torch.randn(5, LORA_RANK, k, device=dev, generator=gen) / k ** .5
        b = torch.randn(5, LORA_RANK, m, device=dev, generator=gen) \
            / LORA_RANK ** .5
        a[0] = 0
        b[0] = 0
        sc = torch.rand(5, device=dev, generator=gen) + 0.5
        out = LM.lora_gather_matmul(x, a, b, sc, idx)
        again = LM.lora_gather_matmul(x, a, b, sc, idx)
        torch.cuda.synchronize()
        require(torch.equal(out, again),
                f"K5 {name}: two runs must be bit-equal")
        ref = LM._xla_gather_matmul(x, a, b, sc, idx)
        require(int(torch.count_nonzero(out[zero])) == 0,
                f"K5 {name}: rows with idx 0 must be exactly zero")
        rows = row_rel_err(out[~zero], ref[~zero])
        row_err = rows.max().item()
        require(row_err <= GEMV_ROW_TOL,
                f"K5 {name}: row error {row_err} > {GEMV_ROW_TOL}")
        nxt = torch.where(idx > 0, idx % 4 + 1, idx).to(torch.int32)
        fault = row_rel_err(LM.lora_gather_matmul(x, a, b, sc, nxt)[~zero],
                            ref[~zero])
        require(bool((fault > GEMV_ROW_TOL).all()),
                f"planted fault (next adapter) passed the K5 check at "
                f"{name}: min row error {fault.min().item()}")
        ms = device_ms(lambda: LM.lora_gather_matmul(x, a, b, sc, idx))
        wall_ms = cuda_ms(lambda: LM.lora_gather_matmul(x, a, b, sc, idx),
                          iters=50)
        plain_ms = device_ms(
            lambda: LM._xla_gather_matmul(x, a, b, sc, idx), iters=10)
        rows_named = len(set(LORA_IDX))
        nbytes = (rows_named * LORA_RANK * (k + m) * 4 + 2 * x.numel()
                  + 2 * len(LORA_IDX) * m + 4 * len(LORA_IDX) + 4 * 5)
        bound_ms, bound_by = bound(
            nbytes, 2 * len(LORA_IDX) * LORA_RANK * (k + m))
        rec = {"kernel": "lora_gather_matmul", "shape": name, "S": 8,
               "K": k, "M": m, "rank": LORA_RANK, "bank_rows": 5,
               "idx": list(LORA_IDX), "dtype": "bfloat16 x, float32 bank",
               "max_abs_err": (out.float() - ref.float()).abs().max().item(),
               "max_row_rel_err": row_err, "row_tol": GEMV_ROW_TOL,
               "fault_min_row_rel_err": fault.min().item(),
               "rerun_bit_equal": True, "ms": ms,
               "events_ms": wall_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None}
        emit({"phase": 3, **rec})
        records.append(rec)
    return records


def phase_serve(cfg, PA, FM, create_engine, init_state, GenerationConfig,
                phase=4):
    """The main path at full width and depth (phase 4: llama3_8b): 8
    requests of 128-2048 tokens + 64 (phase 16, TinyLlama-1.1B, whose
    2048 positions hold prompt and output: each prompt cut to 2048 - 64
    tokens, which leaves the 2048 prefill bucket).  Returns the kernels'
    launches and the printed record."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    state = init_state(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": phase, "layers": cfg.num_hidden_layers,
          "init_state_s": time.perf_counter() - t0,
          "weight_bytes": sum(t.numel() * t.element_size()
                              for t in state.values())})
    max_len = min(8192, cfg.max_position_embeddings)
    engine = create_engine(cfg, state, max_slots=8, page_size=64,
                           max_model_len=max_len, enable_prefix_cache=True,
                           sync_interval=8)
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator): one short request
    engine.submit(rng.integers(0, cfg.vocab_size, 100),
                  GenerationConfig(max_new_tokens=8)).result()
    torch.cuda.synchronize()

    shared = rng.integers(0, cfg.vocab_size, 1024)
    lens = [min(n, max_len - 64) for n in
            (128, 2048, 700, 1500, 333, 1024 + 500, 1024 + 300, 1900)]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    prompts[5] = np.concatenate([shared, prompts[5][1024:]])
    prompts[6] = np.concatenate([shared, prompts[6][1024:]])
    timings0 = dict(engine.timings)
    # counters over the engine's life; the window's are the differences
    stats0 = engine.stats()
    PA.paged_attention.launches = 0
    FM.flash_mha_masked.launches = 0
    t0 = time.perf_counter()
    reqs = [engine.submit(p, GenerationConfig(max_new_tokens=64))
            for p in prompts]
    engine.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": PA.paged_attention.launches,
                "flash_mha_masked": FM.flash_mha_masked.launches}
    stats = engine.stats()
    pool = engine.blocks.pool_accounting()
    for r in reqs:
        require(r.finish_reason == "length", (r, r.finish_reason))
        require(len(r.output_tokens) == 64, (r, len(r.output_tokens)))
        require(all(0 <= t < cfg.vocab_size for t in r.output_tokens),
                f"request {r.id}: token outside the vocabulary")
    require(launches["paged_attention"] > 0
            and launches["flash_mha_masked"] > 0, launches)
    require(stats["decode_traces"] == 1, stats["decode_traces"])
    require(pool["leak"] == 0 and stats["pages_in_use"] == 0, pool)
    require(stats["prefix_hits"] > stats0["prefix_hits"],
            "shared-prefix requests missed")
    ttft = [r.first_token_at - r.arrival_time for r in reqs]
    decode_s = (engine.timings["decode_s"] - timings0["decode_s"]
                + engine.timings["host_sync_s"] - timings0["host_sync_s"])
    decode_tokens = sum(len(r.output_tokens) - 1 for r in reqs)
    rec = {
    "phase": phase, "requests": len(reqs), "prompt_lens": lens,
    "max_new_tokens": 64, "finished_by_length": len(reqs),
    "wall_s": wall, "ttft_s_mean": float(np.mean(ttft)),
    "ttft_s_max": float(np.max(ttft)),
    "prefill_s": engine.timings["prefill_s"] - timings0["prefill_s"],
    "decode_s": decode_s, "decode_tokens": decode_tokens,
    "decode_tokens_per_s": decode_tokens / decode_s,
    **{k: stats[k] - stats0[k] for k in (
        "decode_steps", "host_syncs", "prefix_hits",
        "cached_tokens")},
    "decode_traces": stats["decode_traces"], "pool": pool,
    "launches": launches,
    "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(rec)
    profile_decode(engine, [rng.integers(0, cfg.vocab_size, n) for n in lens],
                   GenerationConfig, phase=phase)
    return launches, rec


def profile_decode(engine, prompts, GenerationConfig, steps=8, phase=4,
                   adapters=None, new=None, counters=None):
    """Where the decode time goes: ``torch.profiler`` over ``steps``
    lockstep decode steps of 8 fresh requests (their prefill runs before
    the window; ``adapters`` gives each request's adapter; ``new`` their
    new tokens, 2 x steps + 2 by default).  Device time is summed per
    kernel and grouped; the idle share is 1 - device busy time / the
    window's wall time.  ``counters()`` returns counts whose growth over
    the window is printed too."""
    from torch.profiler import ProfilerActivity, profile
    for i, p in enumerate(prompts):
        engine.submit(p, GenerationConfig(max_new_tokens=new or 2 * steps + 2),
                      adapter=adapters[i] if adapters else None)
    engine.step()                       # admission + prefill of all 8
    torch.cuda.synchronize()
    before = counters() if counters else {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    grown = {k: v - before[k] for k, v in counters().items()} \
        if counters else None
    engine.run_until_complete()
    per_kernel: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name] = (per_kernel.get(ev.name, 0.0)
                                   + ev.time_range.elapsed_us() / 1e3)
    groups = {"paged_attention": 0.0, "flash_mha_masked": 0.0,
              "weight_only_matmul": 0.0, "lora_gather_matmul": 0.0,
              "matmul": 0.0, "other": 0.0}
    for name, ms in per_kernel.items():
        key = group_kernel(name)
        groups[key] = groups.get(key, 0.0) + ms
    # host time of the collectives' spans (``collective:<op>``)
    host = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CPU
                and ev.name.startswith("collective:")):
            n_us = host.setdefault(ev.name, [0, 0.0])
            n_us[0] += 1
            n_us[1] += ev.time_range.elapsed_us()
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    rec = {"phase": phase, "profile": "decode", "steps": steps,
           "wall_ms_per_step": wall * 1e3 / steps,
           "device_ms_per_step": {k: v / steps for k, v in groups.items()},
           "device_busy_share": busy / (wall * 1e3) if wall else None,
           "kernels_seen": len(per_kernel),
           "top_kernels_ms_per_step": [[n[:80], ms / steps]
                                       for n, ms in top],
           "host_us_per_collective": {k: us / n for k, (n, us)
                                      in host.items()},
           "window_counts": grown}
    emit(rec)
    return rec


def phase_parity(cfg8b, create_engine, init_state, GenerationConfig,
                 phase=5):
    """2 layers at the widths of ``cfg8b`` (phase 5: llama3_8b; phase 16:
    TinyLlama-1.1B), f32, card vs CPU from one state."""
    cfg = dataclasses.replace(cfg8b, num_hidden_layers=2, dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    state_cpu = init_state(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    state_gpu = {k: v.to("cuda") for k, v in state_cpu.items()}
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 96)
    prompts = [rng.integers(0, cfg.vocab_size, 37),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 60)]),
               rng.integers(0, cfg.vocab_size, 200),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 9)])]
    outs = {}
    for device, state in (("cuda", state_gpu), ("cpu", state_cpu)):
        engine = create_engine(cfg, state, device=device, max_slots=4,
                               page_size=64, max_model_len=512,
                               enable_prefix_cache=True, sync_interval=4)
        reqs = [engine.submit(p, GenerationConfig(max_new_tokens=16))
                for p in prompts]
        engine.run_until_complete()
        outs[device] = [r.output_tokens for r in reqs]
    same = outs["cuda"] == outs["cpu"]
    emit({"phase": phase, "layers": 2, "dtype": "float32",
          "prompt_lens": [len(p) for p in prompts], "new_tokens": 16,
          "tokens_identical": same})
    require(same, outs)


def serve_prompts(vocab, seed=0):
    """Phase 4's traffic (rng seed 0: a warm-up prompt, the 1024-token
    shared prefix, 8 prompts of 128-2048 tokens, prompts 5 and 6 on the
    shared prefix) plus prompt 7 on the shared prefix too (phase 8)."""
    rng = np.random.default_rng(seed)
    warm = rng.integers(0, vocab, 100)
    shared = rng.integers(0, vocab, 1024)
    lens = [128, 2048, 700, 1500, 333, 1024 + 500, 1024 + 300, 1900]
    prompts = [rng.integers(0, vocab, n) for n in lens]
    for i in (5, 6, 7):
        prompts[i] = np.concatenate([shared, prompts[i][1024:]])
    return warm, prompts, rng


# phase 8a: prompts 5 and 6 (shared prefix) on one adapter, prompt 7 (the
# same prefix) on another, 0 and 1 dense
MODE_ADAPTERS = (None, None, "a0", "a1", "a2", "a3", "a3", "a0")


def mode_launches(QM, LM, PA, FM):
    return {"weight_only_matmul_int8": QM.weight_only_matmul.int8_launches,
            "weight_only_matmul_int4": QM.weight_only_matmul.int4_launches,
            "lora_gather_matmul": LM.lora_gather_matmul.launches,
            "paged_attention": PA.paged_attention.launches,
            "flash_mha_masked": FM.flash_mha_masked.launches}


def zero_launches(QM, LM, PA, FM):
    QM.weight_only_matmul.int8_launches = 0
    QM.weight_only_matmul.int4_launches = 0
    QM.weight_only_matmul.matmul_calls = 0
    LM.lora_gather_matmul.launches = 0
    PA.paged_attention.launches = 0
    FM.flash_mha_masked.launches = 0


def phase_modes(cfg, mods, name, quant, kv_quant, use_lora):
    """Phase 8: one serving mode at llama3_8b full width and depth, phase
    4's engine settings and traffic; the main path's launches, counted
    from 0 over the 8 requests."""
    (QM, LM, PA, FM, create_engine, init_state, GenerationConfig,
     AdapterStore, random_adapter) = mods
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    state = init_state(cfg, gen, device="cuda")
    store = None
    if use_lora:
        store = AdapterStore(cfg, capacity=4, rank=LORA_RANK)
        for i in range(4):
            store.register(f"a{i}", random_adapter(cfg, LORA_RANK, seed=i),
                           alpha=LORA_ALPHA)
    engine = create_engine(cfg, state, max_slots=8, page_size=64,
                           max_model_len=8192, enable_prefix_cache=True,
                           sync_interval=8, quant=quant, kv_quant=kv_quant,
                           lora=store)
    del state               # the engine holds the quantized state
    release()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    adapters = MODE_ADAPTERS if use_lora else (None,) * 8
    warm, prompts, rng = serve_prompts(cfg.vocab_size)
    engine.submit(warm, GenerationConfig(max_new_tokens=8)).result()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    timings0, stats0 = dict(engine.timings), engine.stats()
    zero_launches(QM, LM, PA, FM)
    t0 = time.perf_counter()
    reqs = [engine.submit(p, GenerationConfig(max_new_tokens=64),
                          adapter=a) for p, a in zip(prompts, adapters)]
    engine.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mode_launches(QM, LM, PA, FM)
    matmul_calls = QM.weight_only_matmul.matmul_calls
    stats = engine.stats()
    pool = engine.blocks.pool_accounting()
    for r in reqs:
        require(r.finish_reason == "length", (r, r.finish_reason))
        require(len(r.output_tokens) == 64, (r, len(r.output_tokens)))
        require(all(0 <= t < cfg.vocab_size for t in r.output_tokens),
                f"request {r.id}: token outside the vocabulary")
    steps = stats["decode_steps"] - stats0["decode_steps"]
    per_step = cfg.num_hidden_layers * 7
    kind = f"weight_only_matmul_{quant}"
    require(launches[kind] == per_step * steps,
            f"{name}: K4 {quant} launches {launches[kind]} != {per_step} x "
            f"{steps} decode steps")
    require(launches["lora_gather_matmul"]
            == (per_step * steps if use_lora else 0),
            f"{name}: K5 launches {launches['lora_gather_matmul']}")
    if kv_quant:
        require(launches["paged_attention"] == 0,
                f"{name}: int8 pages must not run K3")
    else:
        require(launches["paged_attention"] > 0, launches)
    require(launches["flash_mha_masked"] > 0, launches)
    require(stats["decode_traces"] == 1, stats["decode_traces"])
    require(pool["leak"] == 0 and stats["pages_in_use"] == 0, pool)
    cached = [r.num_cached_tokens for r in reqs]
    if use_lora:
        # 6 shares 5's prefix pages (one adapter); 7 has the same prefix
        # under another adapter and must not
        require(cached[6] >= 1024 and cached[7] == 0,
                f"{name}: cross-adapter prefix sharing, cached {cached}")
    ttft = [r.first_token_at - r.arrival_time for r in reqs]
    decode_s = (engine.timings["decode_s"] - timings0["decode_s"]
                + engine.timings["host_sync_s"] - timings0["host_sync_s"])
    decode_tokens = sum(len(r.output_tokens) - 1 for r in reqs)
    emit({"phase": 8, "mode": name, "quant": quant, "kv_quant": kv_quant,
          "lora": store.snapshot() if store else None,
          "adapters": list(adapters), "requests": len(reqs),
          "prompt_lens": [len(p) for p in prompts], "max_new_tokens": 64,
          "setup_s": setup_s, "wall_s": wall,
          "ttft_s_mean": float(np.mean(ttft)),
          "ttft_s_max": float(np.max(ttft)),
          "prefill_s": engine.timings["prefill_s"] - timings0["prefill_s"],
          "decode_s": decode_s, "decode_tokens": decode_tokens,
          "decode_tokens_per_s": decode_tokens / decode_s,
          "decode_steps": steps, "cached_tokens_per_request": cached,
          "prefix_hits": stats["prefix_hits"] - stats0["prefix_hits"],
          "launches": launches, "launches_per_decode_step": {
              k: v / steps for k, v in launches.items()},
          "dequant_matmul_calls": matmul_calls,
          "decode_traces": stats["decode_traces"], "pool": pool,
          "quant_snapshot": engine.quant_snapshot(),
          "resident_bytes": resident,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    profile_decode(engine, [rng.integers(0, cfg.vocab_size, n)
                            for n in (128, 2048, 700, 1500, 333, 1524, 1324,
                                      1900)],
                   GenerationConfig, phase=8, adapters=adapters)
    return launches


def record_logits(engine):
    """Hook a CPU engine (``emit_logits=True``, ``sync_interval=1``) to
    keep, per request id, the f32 logits row behind each emitted token:
    the prefill's from ``_pick_token``, each decode step's from the
    step's logits at the slot."""
    rows = {}
    pick, emit = engine._pick_token, engine._emit

    def pick_hook(req, logits):
        rows.setdefault(req.id, []).append(np.array(logits))
        return pick(req, logits)

    def emit_hook(slot, req, tok, now):
        seen = rows.setdefault(req.id, [])
        if len(seen) == len(req.output_tokens):        # a decode token
            seen.append(engine._last_logits[slot].numpy())
        return emit(slot, req, tok, now)

    engine._pick_token, engine._emit = pick_hook, emit_hook
    return rows


def phase_modes_parity(cfg8b, create_engine, init_state, GenerationConfig,
                       AdapterStore, random_adapter, quantize_state):
    """Phase 9: both phase-8 configurations at 2 layers of llama3_8b
    width in float32, card vs CPU, from one state quantized once on the
    host (the quantizer is not under test).  The greedy tokens must be
    identical, except that a request may part at a tie: at its first
    differing token the CPU's logits of the two picks differ by at most
    ``TIE_TOL`` x their std, and the rest of it is not compared."""
    cfg = dataclasses.replace(cfg8b, num_hidden_layers=2, dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dense = init_state(cfg, torch.Generator().manual_seed(2), device="cpu")
    adapters = {f"a{i}": random_adapter(cfg, LORA_RANK, seed=10 + i)
                for i in range(2)}
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, cfg.vocab_size, 96)
    prompts = [rng.integers(0, cfg.vocab_size, 37),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 60)]),
               rng.integers(0, cfg.vocab_size, 200),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 9)]),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 30)])]
    result = {}
    for name, quant, kv_quant, names in (
            ("int8+lora", "int8", False, (None, "a0", "a1", "a0", "a1")),
            ("int4+kv_quant", "int4", True, (None,) * 5)):
        qstate = quantize_state(dense, kind=quant)
        outs, rows = {}, None
        for device in ("cuda", "cpu"):
            store = None
            if names[1] is not None:
                store = AdapterStore(cfg, capacity=2, rank=LORA_RANK)
                for a, w in adapters.items():
                    store.register(a, w, alpha=LORA_ALPHA)
            engine = create_engine(
                cfg, {k: v.to(device) for k, v in qstate.items()},
                device=device, max_slots=4, page_size=64, max_model_len=512,
                enable_prefix_cache=True,
                sync_interval=4 if device == "cuda" else 1,
                emit_logits=device == "cpu", quant=quant,
                kv_quant=kv_quant, lora=store)
            if device == "cpu":
                rows = record_logits(engine)
            reqs = [engine.submit(p, GenerationConfig(max_new_tokens=16),
                                  adapter=a)
                    for p, a in zip(prompts, names)]
            engine.run_until_complete()
            outs[device] = [r.output_tokens for r in reqs]
            ids = [r.id for r in reqs]
        parts = []
        for i, (card, cpu) in enumerate(zip(outs["cuda"], outs["cpu"])):
            t = next((j for j, (a, b) in enumerate(zip(card, cpu))
                      if a != b), None)
            if t is None:
                continue
            lg = rows[ids[i]][t]
            margin = float(abs(lg[card[t]] - lg[cpu[t]]) / lg.std())
            parts.append({"request": i, "token": t, "card": card[t],
                          "cpu": cpu[t], "margin_over_std": margin})
        same = outs["cuda"] == outs["cpu"]
        result[name] = same
        emit({"phase": 9, "mode": name, "layers": 2, "dtype": "float32",
              "prompt_lens": [len(p) for p in prompts], "adapters": names,
              "new_tokens": 16, "tokens_identical": same,
              "parted_at_tie": parts, "tie_tol": TIE_TOL})
        require(all(p["margin_over_std"] <= TIE_TOL for p in parts),
                (name, parts, outs))
    return result


# ------------------------------------------ phases 17-19: the serving engine
# phase 17: 8 requests of random prompts, 512-2048 tokens, + 128 new
# tokens each.  Random weights never repeat themselves nor copy, so the
# n-gram drafter finds almost nothing to draft (a repeated 64-token span
# gave no proposal in 1,016 tokens, random prompts or prompts drawn from
# the model's own outputs one: PERF.md §6); the verify path is also
# driven with drafts replayed from recorded runs (:class:`ReplayProposer`).
SPEC_NEW = 128
SPEC_LENS = (512, 2048, 768, 1536, 1024, 1280, 640, 1792)
SPEC_VOCAB = 512     # phase 19's speculation case: llama3_8b width, 2 layers
# phase 19's spec_replay case: f32 logits rows, card vs CPU (relative L2)
F32_LOGITS_TOL = 1e-4
# two bf16 runs of the same prefix, one rounded apart from the other (a
# verify row at M = slots x (k + 1), a resumed request's re-prefilled
# tail), must give logits rows this close (relative L2); rows of
# unrelated prefixes are ~2^0.5 apart.  Random weights amplify rounding
# over a request's tokens: 0.035-0.054 after up to 128 tokens on an H100
# (PERF.md §6), where the runs part at logits 0-4 bf16 ulps apart.  A
# gross fault (k and v swapped) reads ~1.41, but a verify step one key
# short read 0.060: this limit cannot see it, phase 19's f32 check does.
BF16_LOGITS_TOL = 2 ** -3
# phase 18: six priority-0 requests of 2048 tokens fill a pool sized for
# them; two priority-1 requests of 512 arrive after PREEMPT_AFTER steps
PREEMPT_LO, PREEMPT_HI, PREEMPT_NEW, PREEMPT_AFTER = 2048, 512, 64, 8


def stash_logits(engine, RequestState):
    """Keep, by ``(request id, token index)``, the f32 logits row behind
    each token the engine emits: the first token's from ``_pick_token``,
    each plain decode step's row at the request's slot, and each verify
    step's k + 1 rows (a later step's row replaces a rejected one).  The
    rows stay on the card; no launch is added to the steps."""
    rows = {}
    runner, seen = engine.runner, {}
    layers, step, verify = runner._layers, runner.decode_step, \
        runner.verify_step
    pick = engine._pick_token

    def at():
        """Token index each active slot's next row produces: emitted
        tokens + the request's unsynced ring rows."""
        pending = {}
        for _, entries, _ in engine._pending:
            for _, r in entries:
                pending[r.id] = pending.get(r.id, 0) + 1
        return {slot: (r.id, r.num_generated + pending.get(r.id, 0))
                for slot, r in enumerate(engine.scheduler.slots)
                if r is not None and r.state == RequestState.DECODE}

    def layers_hook(*a):
        seen["logits"] = layers(*a)
        return seen["logits"]

    def step_hook():
        idx = at()
        out = step()
        for slot, key in idx.items():
            rows[key] = seen["logits"][slot]
        return out

    def verify_hook(draft, dlen):
        idx = at()
        verify(draft, dlen)
        m = draft.shape[1] + 1
        for slot, (rid, t) in idx.items():
            for j in range(m):
                rows[(rid, t + j)] = seen["logits"][slot * m + j]

    def pick_hook(req, logits):
        if not req.num_generated:
            rows[(req.id, 0)] = torch.as_tensor(logits)
        return pick(req, logits)

    runner._layers, runner.decode_step = layers_hook, step_hook
    runner.verify_step, engine._pick_token = verify_hook, pick_hook
    return rows


def compare_runs(got, want, got_rows, want_rows):
    """Hold two runs of the same requests token for token: where a
    request of ``got`` first parts from ``want`` (the rest of it is not
    compared), and the two runs' logits rows per request at every
    token up to that one, ||got - want|| / ||want|| (the rows are one
    function of one prefix, rounded apart in bf16).  Each parting also
    carries phase 9's tie margin: ``want``'s gap between the two picks
    over its row's std, and in bf16 units of the last place."""
    out, worst = [], 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        require(len(g.output_tokens) == len(w.output_tokens),
                f"request {i}: {len(g.output_tokens)} tokens against "
                f"{len(w.output_tokens)}")
        t = next((j for j, (a, b) in enumerate(zip(g.output_tokens,
                                                   w.output_tokens))
                  if a != b), None)
        last = len(w.output_tokens) - 1 if t is None else t
        err = max(row_rel_err(got_rows[(g.id, j)][None].float(),
                              want_rows[(w.id, j)][None].float().to(
                                  got_rows[(g.id, j)].device)).item()
                  for j in range(last + 1))
        worst = max(worst, err)
        rec = {"request": i, "max_row_rel_err": err}
        if t is not None:
            lg = want_rows[(w.id, t)].float().cpu()
            a, b = g.output_tokens[t], w.output_tokens[t]
            top = max(abs(lg[a].item()), abs(lg[b].item()), 1e-30)
            rec.update(token=t, got=a, want=b,
                       tie_margin_over_std=float(abs(lg[a] - lg[b])
                                                 / lg.std()),
                       # the gap in units of bf16's last place there
                       tie_bf16_ulps=float(abs(lg[a] - lg[b]) / 2.0 ** (
                           math.floor(math.log2(top)) - 7)))
        out.append(rec)
    return out, worst


def serve_window(engine, PA, FM, submit, GenerationConfig):
    """Zero the kernels' counters, run ``submit(engine)``'s requests to
    the end, and read what the window used: its requests, wall s,
    launches, and ``stats()`` / ``timings`` before and after."""
    torch.cuda.synchronize()
    timings0, stats0 = dict(engine.timings), engine.stats()
    PA.paged_attention.launches = 0
    FM.flash_mha_masked.launches = 0
    t0 = time.perf_counter()
    reqs = submit(engine)
    engine.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": PA.paged_attention.launches,
                "flash_mha_masked": FM.flash_mha_masked.launches}
    stats = engine.stats()
    decode_s = (engine.timings["decode_s"] - timings0["decode_s"]
                + engine.timings["host_sync_s"] - timings0["host_sync_s"])
    decode_tokens = sum(len(r.output_tokens) - 1 for r in reqs)
    grown = {k: v - stats0[k] for k, v in stats.items()
             if isinstance(v, (int, float)) and not isinstance(v, bool)
             and k in stats0}
    pool = engine.blocks.pool_accounting()
    require(pool["leak"] == 0 and stats["pages_in_use"] == 0, pool)
    return {"reqs": reqs, "wall_s": wall, "launches": launches,
            "stats": stats, "grown": grown, "decode_s": decode_s,
            "decode_tokens": decode_tokens,
            "decode_tokens_per_s": decode_tokens / decode_s,
            "ttft_s": [r.first_token_at - r.arrival_time for r in reqs]}


class ReplayProposer:
    """A perfect draft model for phase 17: drafts each request's next
    tokens from a recorded run of the same traffic (``records``: each
    prompt with the tokens that run gave it), behind the engine's
    drafter hooks (``register`` / ``extend`` / ``propose`` / ``drop``).
    A prompt it has no record of gets no draft; drafts stay the recorded
    ones after a run parts from its record, and verify rejects them."""

    def __init__(self, k, records):
        self.k = k
        self.future = {np.asarray(p, np.int32).tobytes(): list(t)
                       for p, t in records}
        self.live = {}

    def register(self, req_id, tokens):
        key = np.asarray(tokens, np.int32).tobytes()
        self.live[req_id] = [self.future.get(key, []), 0]

    def extend(self, req_id, token):
        self.live[req_id][1] += 1       # tokens emitted so far

    def propose(self, req_id, max_tokens=None):
        future, done = self.live[req_id]
        n = self.k if max_tokens is None else min(self.k, max_tokens)
        return future[done:done + n]

    def drop(self, req_id):
        self.live.pop(req_id, None)


def phase_spec(cfg, state, PA, FM, create_engine, GenerationConfig,
               RequestState):
    """Phase 17: speculative serving at full width and depth (8 slots,
    pages of 64, prefix cache, ``sync_interval=8``): the traffic at
    ``spec_k=0``, at ``SPEC_K`` with the engine's n-gram drafter, at
    ``SPEC_K`` with drafts replayed from the plain run
    (:class:`ReplayProposer`), and at ``SPEC_K`` with drafts replayed
    from that replay run (a perfect draft model: its verify rows round
    as the recorded ones did, so only a change of step pattern can part
    the two), all on the same engine settings.  K3 must launch L times
    per decode step, a verify
    step included (it runs the paged layers once, at slots x (k + 1)
    rows).  Each spec run's tokens are held to the plain run's up to
    each request's first parting, and their logits rows up to it within
    ``BF16_LOGITS_TOL`` (each verify row is a product at M = slots x
    (k + 1), rounded apart in bf16 from the plain step's M = slots)."""
    L = cfg.num_hidden_layers
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SPEC_LENS]
    warm = rng.integers(0, cfg.vocab_size, min(SPEC_LENS) // 2)
    kw = dict(max_slots=8, page_size=64,
              max_model_len=max(SPEC_LENS) + SPEC_NEW,
              enable_prefix_cache=True, sync_interval=8)
    runs = {}
    for name, k, record in (("plain", 0, None), ("ngram", SPEC_K, None),
                            ("replay", SPEC_K, "plain"),
                            ("self_replay", SPEC_K, "replay")):
        engine = create_engine(cfg, state, spec_k=k, **kw)
        # warm-up (cuBLAS handles, the verify path): one short request
        engine.submit(warm, GenerationConfig(max_new_tokens=16)).result()
        rows = stash_logits(engine, RequestState)

        if record:
            engine._proposer = ReplayProposer(SPEC_K, [
                (r.prompt, r.output_tokens) for r in runs[record]["reqs"]])
        run = runs[name] = serve_window(engine, PA, FM, lambda e: [
            e.submit(p, GenerationConfig(max_new_tokens=SPEC_NEW))
            for p in prompts], GenerationConfig)
        run["rows"] = rows
        g, st = run["grown"], run["stats"]
        for r in run["reqs"]:
            require(r.finish_reason == "length"
                    and len(r.output_tokens) == SPEC_NEW, r)
        require(run["launches"]["paged_attention"]
                == L * g["decode_steps"],
                f"{name}: K3 launches {run['launches']} != {L} x "
                f"{g['decode_steps']} decode steps")
        rec = {"phase": 17, "run": name, "spec_k": k,
               "prompt_lens": list(SPEC_LENS), "new_tokens": SPEC_NEW,
               "wall_s": run["wall_s"], "decode_s": run["decode_s"],
               "decode_tokens": run["decode_tokens"],
               "decode_tokens_per_s": run["decode_tokens_per_s"],
               "decode_steps": g["decode_steps"],
               "tokens_per_decode_step": (run["decode_tokens"]
                                          / g["decode_steps"]),
               "host_syncs": g["host_syncs"],
               "ttft_s_mean": float(np.mean(run["ttft_s"])),
               "launches": run["launches"],
               "decode_traces": st["decode_traces"],
               "verify_traces": st["verify_traces"]}
        if k:
            rec.update(
                verify_steps=g["spec_verify_steps"],
                spec_proposed=g["spec_proposed"],
                spec_accepted=g["spec_accepted"],
                acceptance_rate=(g["spec_accepted"] / g["spec_proposed"]
                                 if g["spec_proposed"] else None),
                # accepted + 1 per drafted slot, summed over a step
                committed_per_verify_step=(
                    g["spec_committed_tokens"] / g["spec_verify_steps"]
                    if g["spec_verify_steps"] else None),
                verify_k3_launches=L * g["spec_verify_steps"])
        if name == "self_replay":
            require(g["spec_proposed"] > 0 and g["spec_verify_steps"] > 0,
                    f"{name}: nothing drafted or verified: {g}")
            require(st["decode_traces"] == 2 and st["verify_traces"] == 1,
                    st)
            # the same traffic again (its prefill from the prefix cache):
            # where a verify step's time goes
            rec["profile"] = profile_decode(
                engine, prompts, GenerationConfig, steps=6, phase=17,
                new=SPEC_NEW, counters=lambda: {
                    "decode_steps": engine.decode_steps,
                    "verify_steps": engine.stats()["spec_verify_steps"],
                    "paged_attention": PA.paged_attention.launches})
        emit(rec)
        del engine
        release()
    for name in ("ngram", "replay", "self_replay"):
        parts, err = compare_runs(runs[name]["reqs"], runs["plain"]["reqs"],
                                  runs[name]["rows"], runs["plain"]["rows"])
        emit({"phase": 17, "run": name,
              "tokens_identical": all("token" not in p for p in parts),
              "requests": parts, "max_logits_row_rel_err": err,
              "logits_tol": BF16_LOGITS_TOL,
              "speedup_decode_tokens_per_s": (
                  runs[name]["decode_tokens_per_s"]
                  / runs["plain"]["decode_tokens_per_s"])})
        require(err <= BF16_LOGITS_TOL,
                f"{name} vs plain logits rows {err} > {BF16_LOGITS_TOL}: "
                f"{parts}")
    launches = {k: sum(runs[n]["launches"][k]
                       for n in ("ngram", "replay", "self_replay"))
                for k in runs["plain"]["launches"]}
    del runs
    release()
    return launches


def time_pages(runner):
    """Wall seconds of each ``read_page`` / ``write_page`` call (a
    synchronize on both sides: each moves one page pair across PCIe)."""
    times = {"read_page": [], "write_page": []}
    for name, acc in times.items():
        def timed(*a, _fn=getattr(runner, name), _acc=acc):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a)
            torch.cuda.synchronize()
            _acc.append(time.perf_counter() - t0)
            return out
        setattr(runner, name, timed)
    return times


def phase_preempt(cfg, state, create_engine, GenerationConfig, RequestState,
                  PA, FM):
    """Phase 18: preempt -> spill -> resume at full width and depth: 8
    slots, a pool of pages for the six 2048-token priority-0 requests
    (+ 2), which the two 512-token priority-1 arrivals cannot get
    without a preemption.  Dense pages, then int8 pages (their f32
    scales spill with them); each with ``preempt=False`` first (the
    uninterrupted run: its tokens, logits and the priority-1 TTFT when
    the arrivals wait) and ``preempt=True``.  Every request but the
    victim must give the uninterrupted run's tokens and logits bit for
    bit; the victim's tokens are held to them up to its first parting,
    and its logits rows up to it within ``BF16_LOGITS_TOL`` (the resume
    re-prefills its partial last page, rounded apart in bf16 from the
    decode steps that wrote it); with dense pages a third run, whose
    restore swaps k and v (a planted fault), must fail that check."""
    rng = np.random.default_rng(18)
    lo = [rng.integers(0, cfg.vocab_size, PREEMPT_LO) for _ in range(6)]
    hi = [rng.integers(0, cfg.vocab_size, PREEMPT_HI) for _ in range(2)]
    warm = rng.integers(0, cfg.vocab_size, 100)
    ps = 64
    num_pages = 6 * -(-(PREEMPT_LO + PREEMPT_NEW) // ps) + 2

    def traffic(engine):
        reqs = [engine.submit(p, GenerationConfig(
            max_new_tokens=PREEMPT_NEW)) for p in lo]
        for _ in range(PREEMPT_AFTER):
            engine.step()
        return reqs + [engine.submit(p, GenerationConfig(
            max_new_tokens=PREEMPT_NEW), priority=1) for p in hi]

    def run_once(kv_quant, preempt, fault=False):
        engine = create_engine(
            cfg, state, max_slots=8, page_size=ps, num_pages=num_pages,
            max_model_len=PREEMPT_LO + PREEMPT_NEW, sync_interval=8,
            preempt=preempt, kv_quant=kv_quant)
        engine.submit(warm, GenerationConfig(max_new_tokens=8)).result()
        rows = stash_logits(engine, RequestState)
        times = time_pages(engine.runner)
        if fault:
            write = engine.runner.write_page
            engine.runner.write_page = \
                lambda page, k, v, *sc: write(page, v, k, *sc)
        run = serve_window(engine, PA, FM, traffic, GenerationConfig)
        run.update(rows=rows, times=times, page_bytes=engine._page_bytes())
        for r in run["reqs"]:
            require(r.finish_reason == "length"
                    and len(r.output_tokens) == PREEMPT_NEW, r)
        del engine
        release()
        return run

    out = {}
    for kv_quant in (False, True):
        runs = {p: run_once(kv_quant, p) for p in (False, True)}
        if not kv_quant:        # the planted fault, once
            runs["fault"] = run_once(kv_quant, True, fault=True)
        g = runs[True]["grown"]
        require(g["preemptions"] >= 1 and g["spilled_pages"] >= 1
                and g["restored_pages"] >= 1, g)
        require(runs[False]["grown"]["preemptions"] == 0,
                runs[False]["grown"])
        require(g["spill_bytes"] == g["spilled_pages"]
                * runs[True]["page_bytes"], (g, runs[True]["page_bytes"]))
        victims = [i for i, r in enumerate(runs[True]["reqs"])
                   if r.preemptions]
        parts, _ = compare_runs(runs[True]["reqs"], runs[False]["reqs"],
                                runs[True]["rows"], runs[False]["rows"])
        times = runs[True]["times"]
        name = "int8_pages" if kv_quant else "dense"
        rec = {"phase": 18, "mode": name, "kv_quant": kv_quant,
               "num_pages": num_pages, "lo": [6, PREEMPT_LO],
               "hi": [2, PREEMPT_HI], "new_tokens": PREEMPT_NEW,
               "arrive_after_steps": PREEMPT_AFTER,
               **{k: g[k] for k in ("preemptions", "spill_aborts",
                                    "spilled_pages", "restored_pages",
                                    "spill_bytes")},
               "page_bytes": runs[True]["page_bytes"], "victims": victims,
               "read_page_ms": 1e3 * float(np.mean(times["read_page"])),
               "write_page_ms": 1e3 * float(np.mean(times["write_page"])),
               "pages_read": len(times["read_page"]),
               "pages_written": len(times["write_page"]),
               "hi_ttft_s_preempt": runs[True]["ttft_s"][6:],
               "hi_ttft_s_no_preempt": runs[False]["ttft_s"][6:],
               "decode_tokens_per_s_preempt":
                   runs[True]["decode_tokens_per_s"],
               "decode_tokens_per_s_no_preempt":
                   runs[False]["decode_tokens_per_s"],
               "tokens_identical": all("token" not in p for p in parts),
               "requests": parts}
        rec["victim_logits_row_rel_err"] = max(
            parts[i]["max_row_rel_err"] for i in victims)
        rec["logits_tol"] = BF16_LOGITS_TOL
        fparts = None
        if "fault" in runs:
            fparts, _ = compare_runs(runs["fault"]["reqs"],
                                     runs[False]["reqs"],
                                     runs["fault"]["rows"],
                                     runs[False]["rows"])
            rec["fault_victim_logits_row_rel_err"] = min(
                fparts[i]["max_row_rel_err"]
                for i, r in enumerate(runs["fault"]["reqs"])
                if r.preemptions)
        out[name] = g
        del runs
        emit(rec)
        others = [p for i, p in enumerate(parts) if i not in victims]
        require(all("token" not in p and p["max_row_rel_err"] == 0.0
                    for p in others),
                f"{name}: a request that was not preempted changed: {parts}")
        require(rec["victim_logits_row_rel_err"] <= BF16_LOGITS_TOL,
                f"{name}: the victims' logits rows part from the "
                f"uninterrupted run's: {rec}")
        require(fparts is None
                or rec["fault_victim_logits_row_rel_err"] > BF16_LOGITS_TOL,
                f"{name}: planted fault (k and v swapped on restore) passed "
                f"the resume check: {fparts}")
    # int8 pages park their values and f32 scales: (hd + 4) / (item hd)
    # of the checkpoint-dtype pages' bytes (bf16: item 2), page for page
    hd = cfg.head_dim
    item = state["llama.embed_tokens.weight"].element_size()
    per_page = {k: g["spill_bytes"] / g["spilled_pages"]
                for k, g in out.items()}
    require(per_page["int8_pages"] * item * hd
            == per_page["dense"] * (hd + 4), per_page)
    return out


def verify_key_short(G, verify_rows):
    """Plant a fault in the verify step: its batch (``verify_rows``
    rows) attends one key short of each row's prefix, the kind of
    off-by-one a verify ``lens`` can carry.  Returns the undo."""
    select = G.select_paged_attention

    def faulty(tp_axis=None):
        attend = select(tp_axis=tp_axis)

        def call(q, kpool, vpool, table, lens):
            if q.shape[0] == verify_rows:
                lens = (lens - 1).clamp_min(1)
            return attend(q, kpool, vpool, table, lens)
        return call

    G.select_paged_attention = faulty
    return lambda: setattr(G, "select_paged_attention", select)


def phase_serving_parity(cfg8b, create_engine, init_state, GenerationConfig,
                         EngineSupervisor, FaultPlan, RequestState, G):
    """Phase 19: 2 layers at llama3_8b width in float32, card (kernels)
    vs CPU (plain versions) from one state — identical tokens and
    counters in each case:

    - ``spec_replay``: ``spec_k=SPEC_K`` with drafts replayed from the
      CPU engine's own plain run (:class:`ReplayProposer`), so that
      verify accepts them: pos advancing by acc + 1, the token taken
      from the accepted row, multi-token ring rows.  Drafts must be
      accepted (more than one a verify step), the tokens must equal the
      plain run's, and every logits row, card vs CPU, must agree within
      ``F32_LOGITS_TOL``; a planted fault (verify rows one key short,
      :func:`verify_key_short`) must fail that check;
    - ``spec_ngram``: ``spec_k=SPEC_K`` with the engine's n-gram
      drafter, on random prompts over a vocabulary cut to
      ``SPEC_VOCAB`` (so that random weights repeat tokens the drafter
      can look up);
    - ``preempt``: a preempt -> spill -> resume;
    - ``step_raise``: a ``step_raise`` at decode step 3 recovered
      through ``EngineSupervisor``."""
    cfg = dataclasses.replace(cfg8b, num_hidden_layers=2, dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    state_cpu = init_state(cfg, torch.Generator().manual_seed(19),
                           device="cpu")
    state_gpu = {k: v.to("cuda") for k, v in state_cpu.items()}
    rng = np.random.default_rng(19)
    lows = [rng.integers(0, cfg.vocab_size, 100) for _ in range(2)]
    high = rng.integers(0, cfg.vocab_size, 70)
    spec_cfg = dataclasses.replace(cfg, vocab_size=SPEC_VOCAB)
    spec_cpu = init_state(spec_cfg, torch.Generator().manual_seed(19),
                          device="cpu")
    spec_states = {"cuda": {k: v.to("cuda") for k, v in spec_cpu.items()},
                   "cpu": spec_cpu}
    spec_prompts = [rng.integers(0, SPEC_VOCAB, n) for n in (120, 60)]
    replay_prompts = [rng.integers(0, cfg.vocab_size, n) for n in (120, 60)]
    slots, new = 2, 16
    kw = dict(max_slots=slots, page_size=64, max_model_len=512)
    spec_kw = dict(enable_prefix_cache=True, sync_interval=4)

    # the drafts: the CPU engine's own plain run of the replayed traffic
    plain = create_engine(cfg, state_cpu, device="cpu", spec_k=0,
                          **spec_kw, **kw)
    plain_reqs = [plain.submit(p, GenerationConfig(max_new_tokens=new))
                  for p in replay_prompts]
    plain.run_until_complete()
    records = [(r.prompt, r.output_tokens) for r in plain_reqs]
    del plain

    def replay(engine):
        engine._proposer = ReplayProposer(SPEC_K, records)
        rows = stash_logits(engine, RequestState)
        return [engine.submit(p, GenerationConfig(max_new_tokens=new))
                for p in replay_prompts], rows

    def spec(engine):
        return [engine.submit(p, GenerationConfig(max_new_tokens=new))
                for p in spec_prompts], None

    def preempt(engine):
        reqs = [engine.submit(p, GenerationConfig(max_new_tokens=12))
                for p in lows]
        for _ in range(4):
            engine.step()
        return reqs + [engine.submit(high, GenerationConfig(
            max_new_tokens=12), priority=1)], None

    def poisoned(engine):
        sup = EngineSupervisor(engine, max_recoveries=3)
        reqs = [engine.submit(p, GenerationConfig(max_new_tokens=12))
                for p in lows]
        while not all(r.is_finished() for r in reqs):
            sup.step()
        return reqs, None

    spec_keys = ("spec_proposed", "spec_accepted", "spec_verify_steps",
                 "spec_committed_tokens", "decode_steps")
    cases = (
        ("spec_replay", replay, dict(spec_kw, spec_k=SPEC_K), spec_keys),
        ("spec_ngram", spec, dict(spec_kw, spec_k=SPEC_K), spec_keys),
        ("preempt", preempt, dict(preempt=True),
         ("preemptions", "spilled_pages", "restored_pages", "spill_bytes",
          "decode_steps")),
        ("step_raise", poisoned, dict(enable_prefix_cache=True),
         ("recoveries", "replayed_requests", "quarantines",
          "faults_injected", "decode_steps")))

    def run(name, script, device, engine_kw):
        faults = (FaultPlan(seed=0).add("step_raise", at=1, step=3)
                  if name == "step_raise" else None)
        ngram = name == "spec_ngram"
        engine = create_engine(
            spec_cfg if ngram else cfg,
            spec_states[device] if ngram else
            (state_gpu if device == "cuda" else state_cpu),
            device=device, faults=faults, **engine_kw, **kw)
        reqs, rows = script(engine)
        engine.run_until_complete()
        require(all(r.finish_reason == "length" for r in reqs),
                (name, device, [r.finish_reason for r in reqs]))
        return reqs, rows, engine.stats()

    result = {}
    for name, script, engine_kw, keys in cases:
        runs = {d: run(name, script, d, engine_kw) for d in ("cuda", "cpu")}
        outs = {d: [r.output_tokens for r in v[0]] for d, v in runs.items()}
        stats = {d: {k: v[2][k] for k in keys} for d, v in runs.items()}
        result[name] = stats["cuda"]
        rec = {"phase": 19, "case": name, "layers": 2, "dtype": "float32",
               "tokens_identical": outs["cuda"] == outs["cpu"],
               "stats_card": stats["cuda"], "stats_cpu": stats["cpu"]}
        if name == "spec_replay":
            _, err = compare_runs(runs["cuda"][0], runs["cpu"][0],
                                  runs["cuda"][1], runs["cpu"][1])
            # the planted fault: the card's verify rows one key short
            undo = verify_key_short(G, slots * (SPEC_K + 1))
            try:
                faulty = run(name, script, "cuda", engine_kw)
            finally:
                undo()
            fparts, ferr = compare_runs(faulty[0], runs["cpu"][0],
                                        faulty[1], runs["cpu"][1])
            rec.update(tokens_equal_plain=outs["cpu"] == [
                           t for _, t in records],
                       max_logits_row_rel_err=err,
                       logits_tol=F32_LOGITS_TOL,
                       fault_max_logits_row_rel_err=ferr,
                       fault_tokens_identical=all("token" not in p
                                                  for p in fparts))
        emit(rec)
        require(outs["cuda"] == outs["cpu"] and stats["cuda"] == stats["cpu"],
                (name, outs, stats))
        if name == "spec_replay":
            require(rec["tokens_equal_plain"], (outs, records))
            require(err <= F32_LOGITS_TOL, rec)
            require(ferr > F32_LOGITS_TOL,
                    f"planted fault (verify rows one key short) passed the "
                    f"logits check: {rec}")
        del runs
        release()
    st = result["spec_replay"]
    require(st["spec_verify_steps"] > 0
            and st["spec_accepted"] > st["spec_verify_steps"], st)
    require(result["spec_ngram"]["spec_verify_steps"] > 0, result)
    require(result["preempt"]["preemptions"] == 1
            and result["preempt"]["restored_pages"] >= 1, result)
    require(result["step_raise"]["recoveries"] == 1, result)
    return result


# ----------------------------------------- phases 20-21: the HTTP front end
HTTP_NEW_TOKENS = 64
HTTP_TIMEOUT_S = 600.0


def http_counters(client):
    """Counter samples of a ``/metrics`` scrape: {(name, labels): value}."""
    counters, out = set(), {}
    for line in client.metrics_text().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            if kind == "counter":
                counters.add(name)
        elif line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            name = key.split("{", 1)[0]
            if name in counters:
                out[(name, key[len(name):])] = float(value)
    return out


def in_process_window(engine, prompts, GenerationConfig, new):
    """Phase 4's measurement on ``engine``: every prompt submitted at
    once through ``Engine.submit`` and run to completion in-process;
    TTFT on the engine clock, decode tokens/s over the engine's decode
    and host-sync seconds."""
    timings0, stats0 = dict(engine.timings), engine.stats()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, GenerationConfig(max_new_tokens=new))
            for p in prompts]
    engine.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = engine.stats()
    ttft = [r.first_token_at - r.arrival_time for r in reqs]
    decode_s = (engine.timings["decode_s"] - timings0["decode_s"]
                + engine.timings["host_sync_s"] - timings0["host_sync_s"])
    decode_tokens = sum(len(r.output_tokens) - 1 for r in reqs)
    for r in reqs:
        require(r.finish_reason == "length"
                and len(r.output_tokens) == new, r)
    return {"wall_s": wall, "decode_steps": stats["decode_steps"]
            - stats0["decode_steps"], "ttft_s_mean": float(np.mean(ttft)),
            "ttft_s_max": float(np.max(ttft)),
            "decode_tokens_per_s": decode_tokens / decode_s,
            "tokens": [list(r.output_tokens) for r in reqs]}


def http_request(client, obs, prompt, new, stream, **kw):
    """One completion over HTTP under its own trace (a root span whose
    context the client sends as ``traceparent``); client-side TTFT for a
    stream (send -> first token event) and wall seconds."""
    with obs.tracer().start_span("smoke.client") as span:
        t0 = time.perf_counter()
        ttft = None
        if not stream:
            out = client.completion(prompt, max_tokens=new, **kw)
            choice = out["choices"][0]
            tokens, final, usage = (choice["token_ids"],
                                    choice["finish_reason"], out["usage"])
        else:
            tokens, final, usage = [], None, None
            for ev in client.completion(prompt, max_tokens=new,
                                        stream=True, **kw):
                got = ev["choices"][0]["token_ids"]
                if got and ttft is None:
                    ttft = time.perf_counter() - t0
                tokens.extend(got)
                if ev["choices"][0]["finish_reason"] is not None:
                    final, usage = (ev["choices"][0]["finish_reason"],
                                    ev["usage"])
        return {"tokens": tokens, "finish": final, "usage": usage,
                "ttft_s": ttft, "wall_s": time.perf_counter() - t0,
                "trace_id": span.trace_id, "stream": stream}


def http_burst(client, obs, prompts, new):
    """All ``prompts`` at once from one thread each: the first half
    blocking, the second half streamed.  Returns the results in prompt
    order; a thread's exception is re-raised here."""
    results = [None] * len(prompts)
    half = len(prompts) // 2

    def one(i):
        try:
            results[i] = http_request(client, obs, prompts[i], new,
                                      stream=i >= half)
        except BaseException as e:      # re-raised below, on this thread
            results[i] = e

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT_S)
        require(not t.is_alive(), "an HTTP request never returned")
    for r in results:
        if isinstance(r, BaseException):
            raise r
    return results


def phase_http(cfg, state, PA, FA, FM, serve, ServingClient,
               ServingHTTPError, obs, GenerationConfig, card, phase4):
    """Phase 20: llama3_8b at full width and depth behind the HTTP server
    (``serve(config, state)`` on the card: 8 slots, pages of 64, prefix
    cache).  Phase 4's traffic (``serve_prompts``) runs first in-process
    on the server's engine (phase 4's measurement), then, with the prefix
    cache flushed, over HTTP from 8 threads at once through
    ``ServingClient``: four blocking, four streamed, each under its own
    trace.  Then a drain with one stream in flight.  ``phase4`` is phase
    4's record, printed beside."""
    warm, prompts, _ = serve_prompts(cfg.vocab_size)
    new = HTTP_NEW_TOKENS
    server = serve(cfg, state, max_slots=8, page_size=64,
                   enable_prefix_cache=True, start=False)
    stopped = False
    try:
        engine = server.worker.engine
        engine.submit(warm, GenerationConfig(max_new_tokens=8)).result()
        torch.cuda.synchronize()
        inproc = in_process_window(engine, prompts, GenerationConfig, new)
        engine.blocks.flush_prefix_cache()
        server.start()
        client = ServingClient(server.address, timeout=HTTP_TIMEOUT_S)
        require(client.healthz()["status"] == "ok", "healthz")
        before = http_counters(client)
        timings0, stats0 = dict(engine.timings), engine.stats()
        PA.paged_attention.launches = 0
        FM.flash_mha_masked.launches = 0
        plain, restore = count_plain_calls(FA, FM, PA)
        try:
            t0 = time.perf_counter()
            results = http_burst(client, obs, prompts, new)
            wall = time.perf_counter() - t0
        finally:
            restore()
        launches = {"paged_attention": PA.paged_attention.launches,
                    "flash_mha_masked": FM.flash_mha_masked.launches}
        delta = {k: v - before.get(k, 0.0)
                 for k, v in http_counters(client).items()}
        stats = engine.stats()
        health = client.healthz()
        spans = client.request("GET", "/debug/trace")["traceEvents"]
        for i, r in enumerate(results):
            require(r["finish"] == "length" and len(r["tokens"]) == new,
                    (i, r["finish"], len(r["tokens"])))
            require(r["usage"]["completion_tokens"] == len(r["tokens"]),
                    (i, r["usage"]))
            require(all(0 <= t < cfg.vocab_size for t in r["tokens"]),
                    f"request {i}: token outside the vocabulary")
            roots = [e for e in spans if e["name"] == "request"
                     and e["args"].get("trace_id") == r["trace_id"]]
            require(len(roots) == 1, (i, r["trace_id"], len(roots)))
        sent = sum(len(r["tokens"]) for r in results)
        require(delta.get(("serving_tokens_total", ""), 0) == sent,
                (delta.get(("serving_tokens_total", "")), sent))
        require(delta.get(("serving_http_requests_total",
                           '{route="/v1/completions",code="200"}')) == 8,
                delta)
        require(health["status"] == "ok", health)
        require(launches["paged_attention"] > 0
                and launches["flash_mha_masked"] > 0, launches)
        # no plain version of a kernel on the path ran; the cached-suffix
        # prefill's [1, 1, S, T] bool mask takes plain attention, as it
        # takes XLA in the reference: once per layer per cached request
        cached = sum(1 for r in results
                     if r["usage"]["prompt_tokens_cached"] > 0)
        require(all(v == 0 for k, v in plain.items() if k != "_xla_sdpa"),
                plain)
        require(plain["_xla_sdpa"] == cfg.num_hidden_layers * cached,
                (plain, cached))
        require(stats["prefix_hits"] > stats0["prefix_hits"],
                "shared-prefix requests missed over HTTP")
        decode_s = (engine.timings["decode_s"] - timings0["decode_s"]
                    + engine.timings["host_sync_s"]
                    - timings0["host_sync_s"])
        decode_tokens = sum(len(r["tokens"]) - 1 for r in results)
        with server.worker.lock:
            server_ttft = [q.first_token_at - q.arrival_time
                           for q in list(server.worker.requests)[-8:]]
        stream_ttft = [r["ttft_s"] for r in results if r["stream"]]
        http = {"wall_s": wall, "decode_steps": stats["decode_steps"]
                - stats0["decode_steps"],
                "client_stream_ttft_s_mean": float(np.mean(stream_ttft)),
                "client_stream_ttft_s_max": float(np.max(stream_ttft)),
                "client_blocking_e2e_s_mean": float(np.mean(
                    [r["wall_s"] for r in results if not r["stream"]])),
                "server_ttft_s_mean": float(np.mean(server_ttft)),
                "server_ttft_s_max": float(np.max(server_ttft)),
                "decode_tokens_per_s": decode_tokens / decode_s,
                "client_tokens_per_s": sent / wall}
        emit({"phase": 20, "card": card, "layers": cfg.num_hidden_layers,
              "prompt_lens": [len(p) for p in prompts],
              "max_new_tokens": new, "requests": len(results),
              "streamed": len(stream_ttft), "http": http,
              "in_process": {k: v for k, v in inproc.items()
                             if k != "tokens"},
              "http_cost": {
                  "ttft_s_mean": http["client_stream_ttft_s_mean"]
                  - inproc["ttft_s_mean"],
                  "wall_s": wall - inproc["wall_s"],
                  "decode_tokens_per_s": http["decode_tokens_per_s"]
                  - inproc["decode_tokens_per_s"]},
              "phase4": {k: phase4.get(k) for k in (
                  "ttft_s_mean", "ttft_s_max", "decode_tokens_per_s",
                  "wall_s")},
              "same_tokens_as_in_process": [r["tokens"] for r in results]
              == inproc["tokens"],
              "launches": launches, "plain_calls": dict(plain),
              "cached_suffix_prefills": cached,
              "prefix_hits": stats["prefix_hits"] - stats0["prefix_hits"],
              "traces": len(results)})

        # drain: one stream in flight, then stop(); a request that comes
        # while the drain runs gets 503.  The engine holds after each step
        # (its lock released) while the stream is in flight and that
        # request has no answer yet, so the stream is still in flight
        # then however fast it decodes; the hold adds no device work
        streamed = {}
        first, probed = threading.Event(), threading.Event()
        step = engine.step

        def held_step():
            out = step()
            deadline = time.monotonic() + 60.0
            while (engine.scheduler.active_count and not probed.is_set()
                   and time.monotonic() < deadline):
                server.worker._wake.wait(0.01)
            return out

        def stream_one():
            toks, final = [], None
            for ev in client.completion(prompts[0], max_tokens=new,
                                        stream=True):
                toks.extend(ev["choices"][0]["token_ids"])
                first.set()
                final = ev["choices"][0]["finish_reason"] or final
            streamed.update(tokens=toks, finish=final)

        engine.step = held_step
        t = threading.Thread(target=stream_one, daemon=True)
        t.start()
        require(first.wait(HTTP_TIMEOUT_S), "drain stream never started")
        stopper = threading.Thread(
            target=lambda: server.stop(drain_timeout=HTTP_TIMEOUT_S),
            daemon=True)
        stopper.start()
        stopped = True
        deadline = time.monotonic() + 60.0
        while not server.worker.draining:
            require(time.monotonic() < deadline, "drain never began")
            time.sleep(0.001)
        try:
            client.completion(prompts[1], max_tokens=4)
            status = 200
        except ServingHTTPError as e:
            status = e.status
        finally:
            probed.set()
        t.join(timeout=HTTP_TIMEOUT_S)
        stopper.join(timeout=HTTP_TIMEOUT_S)
        del engine.step
        require(not t.is_alive() and not stopper.is_alive(),
                "drain did not finish")
        emit({"phase": 20, "drain": {"stream_tokens": len(
            streamed.get("tokens", [])), "finish": streamed.get("finish"),
            "status_after_drain_began": status}})
        require(streamed.get("finish") == "length"
                and len(streamed["tokens"]) == new, streamed)
        require(status == 503, f"a request during the drain got {status}")
    finally:
        if not stopped:
            server.stop(drain_timeout=60.0)
    return launches


def phase_http_parity(cfg8b, serve, create_engine, init_state,
                      GenerationConfig, AdapterStore, random_adapter,
                      Router, ServingClient, usage_json, card):
    """Phase 21: 2 layers of llama3_8b width in float32 behind the HTTP
    server on the card, against the port's engine on the CPU from one
    state: 8 prompts (some on a shared prefix), half naming one of two
    rank-16 adapters in the body, sent one at a time.  Tokens, finish
    reasons and usage blocks equal the CPU's (``queue_ms`` aside; a
    request may part only at a tie, phase 9's rule); a ``Router`` over
    two more card servers on the same state dict gives the card
    server's tokens, at a prefix hit rate no worse than its."""
    cfg = dataclasses.replace(cfg8b, num_hidden_layers=2, dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    state_cpu = init_state(cfg, torch.Generator().manual_seed(21),
                           device="cpu")
    state_gpu = {k: v.to("cuda") for k, v in state_cpu.items()}
    adapters = {f"a{i}": random_adapter(cfg, LORA_RANK, seed=20 + i)
                for i in range(2)}

    def store():
        s = AdapterStore(cfg, capacity=2, rank=LORA_RANK)
        for a, w in adapters.items():
            s.register(a, w, alpha=LORA_ALPHA)
        return s

    rng = np.random.default_rng(21)
    prefix = rng.integers(0, cfg.vocab_size, 96)
    prompts = [rng.integers(0, cfg.vocab_size, 37),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 60)]),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 9)]),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 30)]),
               rng.integers(0, cfg.vocab_size, 200),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 45)]),
               rng.integers(0, cfg.vocab_size, 70),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 20)])]
    names = (None, "a0", "a0", None, "a1", None, "a1", "a0")
    new = 16
    kw = dict(max_slots=4, page_size=64, max_model_len=512,
              enable_prefix_cache=True)

    def untimed(usage):
        return {k: v for k, v in usage.items() if k != "queue_ms"}

    engine = create_engine(cfg, state_cpu, device="cpu", emit_logits=True,
                           sync_interval=1, lora=store(), **kw)
    rows = record_logits(engine)
    cpu = []
    for p, a in zip(prompts, names):
        r = engine.submit(p, GenerationConfig(max_new_tokens=new),
                          adapter=a)
        engine.run_until_complete()
        cpu.append({"tokens": list(r.output_tokens),
                    "finish": {"length": "length", "eos": "stop"}.get(
                        r.finish_reason, r.finish_reason),
                    "usage": untimed(usage_json(r)), "id": r.id})
    del engine

    def send(client):
        out = []
        for p, a in zip(prompts, names):
            res = client.completion([int(t) for t in p], max_tokens=new,
                                    adapter=a)
            out.append({"tokens": res["choices"][0]["token_ids"],
                        "finish": res["choices"][0]["finish_reason"],
                        "usage": untimed(res["usage"])})
        return out

    def hit_rate(servers, before):
        hits = sum(s.worker.stats()["prefix_hits"] for s in servers) \
            - before[0]
        miss = sum(s.worker.stats()["prefix_misses"] for s in servers) \
            - before[1]
        return hits / (hits + miss)

    def counts(servers):
        return (sum(s.worker.stats()["prefix_hits"] for s in servers),
                sum(s.worker.stats()["prefix_misses"] for s in servers))

    servers = [serve(cfg, state_gpu, lora=store(), sync_interval=4, **kw)
               for _ in range(3)]
    proxy = None
    try:
        single, pair = servers[0], servers[1:]
        c0 = counts([single])
        on_card = send(ServingClient(single.address,
                                     timeout=HTTP_TIMEOUT_S))
        single_rate = hit_rate([single], c0)
        router = Router([s.address for s in pair], page_size=64,
                        request_timeout_s=HTTP_TIMEOUT_S)
        proxy = router.serve()
        c1 = counts(pair)
        routed = send(ServingClient(proxy.address,
                                    timeout=HTTP_TIMEOUT_S))
        pair_rate = hit_rate(pair, c1)
        replicas_hit = sum(s.worker.stats()["prefix_hits"] > 0
                           for s in pair)
    finally:
        if proxy is not None:
            proxy.stop()
        for s in servers:
            s.stop(drain_timeout=60.0)
    parts = []
    for i, (got, want) in enumerate(zip(on_card, cpu)):
        t = next((j for j, (a, b) in enumerate(zip(got["tokens"],
                                                    want["tokens"]))
                  if a != b), None)
        if t is None:
            continue
        lg = rows[want["id"]][t]
        parts.append({"request": i, "token": t, "card": got["tokens"][t],
                      "cpu": want["tokens"][t], "margin_over_std": float(
                          abs(lg[got["tokens"][t]] - lg[want["tokens"][t]])
                          / lg.std())})
    same = [g["tokens"] for g in on_card] == [w["tokens"] for w in cpu]
    emit({"phase": 21, "card": card,
          "layers": 2, "dtype": "float32",
          "prompt_lens": [len(p) for p in prompts], "adapters": names,
          "new_tokens": new, "tokens_identical": same,
          "parted_at_tie": parts, "tie_tol": TIE_TOL,
          "usage_equal": [g["usage"] for g in on_card]
          == [w["usage"] for w in cpu],
          "finish_equal": [g["finish"] for g in on_card]
          == [w["finish"] for w in cpu],
          "router_tokens_equal": [r["tokens"] for r in routed]
          == [g["tokens"] for g in on_card],
          "prefix_hit_rate": {"single": single_rate, "router": pair_rate},
          "router_replicas_hit": replicas_hit})
    require(all(p["margin_over_std"] <= TIE_TOL for p in parts), parts)
    require([g["finish"] for g in on_card] == [w["finish"] for w in cpu],
            (on_card, cpu))
    require([g["usage"] for g in on_card] == [w["usage"] for w in cpu],
            ([g["usage"] for g in on_card], [w["usage"] for w in cpu]))
    require([r["tokens"] for r in routed] == [g["tokens"] for g in on_card],
            "the router's tokens differ from the single server's")
    require(single_rate > 0 and pair_rate >= single_rate - 1e-9,
            (single_rate, pair_rate))


def gemv_entry(name, src, replaces, records, launches, rep):
    """A kernels-line entry: times at ``rep``, the record of the main
    path's largest projection (gate/up at M = 8), errors over every
    shape of phase 3."""
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in records),
            "max_row_rel_err": max(x["max_row_rel_err"] for x in records),
            "shape": rep["shape"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"]}


def bench_config(LlamaConfig, **kw):
    """The reference bench's one-chip training rung (bench.py:148-153)."""
    cfg = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
               num_hidden_layers=16, num_attention_heads=16,
               num_key_value_heads=16, max_position_embeddings=2048,
               dtype="bfloat16")
    cfg.update(kw)
    return LlamaConfig(**cfg)


def phase_train(cfg, TH, FA, batch=8, seq=2048, steps=TRAIN_STEPS, phase=6,
                plain=None):
    """The training path at full width and depth: setup -> step, as
    bench.py's _llama_throughput drives the reference (one warm-up step,
    then timed steps on one batch).  ``plain``: the calls of the
    attention plain versions (:func:`count_plain_calls`), which the timed
    steps must not make."""
    t0 = time.perf_counter()
    params, opt = TH.setup(cfg, seed=0, dtype=torch.bfloat16)
    step = TH.build_train_step(cfg, remat=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq + 1), device="cuda",
                        generator=gen)
    n_params = sum(t.numel() for t in TH.tree_leaves(params))
    loss, params, opt = step(params, opt, ids)                 # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()   # params + AdamW state
    FA.flash_mha.fwd_launches = 0
    FA.flash_mha.dq_launches = 0
    FA.flash_mha.dkv_launches = 0
    plain0 = dict(plain or {})
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        loss, params, opt = step(params, opt, ids)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": FA.flash_mha.fwd_launches,
                "flash_attention_bwd_dq": FA.flash_mha.dq_launches,
                "flash_attention_bwd_dkv": FA.flash_mha.dkv_launches}
    plain_calls = {k: n - plain0[k] for k, n in (plain or {}).items()}
    require(not any(plain_calls.values()),
            f"the timed steps called plain attention: {plain_calls}")
    losses = [float(x) for x in losses]
    layers = cfg.num_hidden_layers
    require(all(math.isfinite(x) for x in losses), f"loss {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = {"flash_attention_fwd": 2 * layers * steps,
            "flash_attention_bwd_dq": layers * steps,
            "flash_attention_bwd_dkv": layers * steps}
    require(launches == want, f"flash launches {launches} != {want}")
    tps = batch * seq * steps / wall
    attn_flops = 12 * layers * cfg.hidden_size * seq
    mfu = tps * (6 * n_params + attn_flops) / BF16_FLOPS_PER_S
    emit({"phase": phase, "params": n_params, "batch": batch, "seq": seq,
          "steps": steps, "remat": True, "setup_and_warmup_s": setup_s,
          "wall_s": wall, "s_per_step": wall / steps,
          "tokens_per_s": tps, "mfu": mfu, "loss_first": losses[0],
          "loss_last": losses[-1], "losses": losses, "launches": launches,
          "plain_attention_calls": plain_calls, "resident_bytes": resident,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    profile_train(step, params, opt, ids, phase)
    return launches


def count_plain_calls(FA, FM, PA=None):
    """Wrap the attention plain versions (K1/K2's, K8's, the XLA-path
    ``_xla_sdpa`` and, given its module, K3's) so that each call is
    counted: returns (the counts by name, a function that puts the
    originals back).  The wrappers look their plain versions up by
    module name, so the counts see every call."""
    counts, saved = {}, []
    mods = [(FA, ("_flash_fwd_xla", "_flash_bwd_xla", "_xla_sdpa")),
            (FM, ("_masked_fwd_xla", "_masked_bwd_dq_xla",
                  "_masked_bwd_dkv_xla", "_masked_bwd_dbias_xla"))]
    if PA is not None:
        mods.append((PA, ("paged_attention_xla",)))
    for mod, names in mods:
        for name in names:
            fn = getattr(mod, name)
            counts[name] = 0

            def counting(*args, _fn=fn, _name=name, **kw):
                counts[_name] += 1
                return _fn(*args, **kw)

            setattr(mod, name, counting)
            saved.append((mod, name, fn))

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return counts, restore


def tinyllama_config(LlamaConfig, **kw):
    """TinyLlama-1.1B (TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-
    3T, its config.json): the bench rung's widths (vocab 32000, hidden
    2048, FFN 5632, 2048 positions) with 22 layers, 32 q / 4 kv heads
    (head_dim 64) and rms eps 1e-5."""
    cfg = dict(num_hidden_layers=22, num_attention_heads=32,
               num_key_value_heads=4, rms_norm_eps=1e-5)
    cfg.update(kw)
    return bench_config(LlamaConfig, **cfg)


def profile_train(step, params, opt, ids, phase=6):
    """Where one training step's time goes: ``torch.profiler`` over one
    step, device time per kernel grouped, idle share = 1 - device busy
    time / the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, ids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name] = (per_kernel.get(ev.name, 0.0)
                                   + ev.time_range.elapsed_us() / 1e3)
    groups = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
              "matmul": 0.0, "other": 0.0}
    # K1/K2 by kernel name: the bf16 kernels of flash_sm90.cuh, the f32
    # ones of flash_attention.cu ("sm90" alone marks a cuBLAS GEMM)
    flash = {"flash_fwd": ("flash_sm90::fwd_kernel", "flash_fwd_kernel"),
             "flash_bwd_dq": ("flash_sm90::dq_kernel",
                              "flash_bwd_dq_kernel"),
             "flash_bwd_dkv": ("flash_sm90::dkv_kernel",
                               "flash_bwd_dkv_kernel")}
    for name, ms in per_kernel.items():
        low = name.lower()
        if is_k8_forward(low) or is_k8_backward(low):
            key = "flash_mha_masked" if is_k8_forward(low) else \
                "flash_mask_bwd"
            groups[key] = groups.get(key, 0.0) + ms
            continue
        for key, marks in flash.items():
            if any(m in low for m in marks):
                groups[key] += ms
                break
        else:
            if any(m in low for m in ("gemm", "gemv", "cutlass", "xmma",
                                      "sm90", "cublas", "nvjet")):
                groups["matmul"] += ms
            else:
                groups["other"] += ms
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    emit({"phase": phase, "profile": "train_step", "wall_ms": wall * 1e3,
          "device_ms": groups, "device_busy_ms": busy,
          "device_idle_share": 1 - busy / (wall * 1e3),
          "kernels_seen": len(per_kernel),
          "top_kernels_ms": [[n[:80], ms] for n, ms in top]})


def rel_norm(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-300)).item()


def phase_train_parity(cfg, TH, seq=256, phase=7, remat=True, mesh=None):
    """One f32 training step, card (kernels) vs CPU (plain versions),
    from one set of params: loss, every grad, every param after it
    (``mesh``: phase 22a's one-rank mesh, which both runs take)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    params_cpu, _ = TH.setup(cfg, seed=1, dtype=torch.float32, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, seq + 1)).astype(np.int64))
    res = {}
    for device in ("cuda", "cpu"):
        params = TH.tree_map(lambda t: t.to(device, copy=True), params_cpu)
        t0 = time.perf_counter()
        loss, grads = TH.value_and_grad(params, ids.to(device), cfg, mesh,
                                        remat=remat)
        step = TH.build_train_step(cfg, mesh, remat=remat, device=device)
        _, params, _ = step(params, TH.init_adamw(params), ids)
        if device == "cuda":
            torch.cuda.synchronize()
        res[device] = (loss, TH.tree_leaves(grads), TH.tree_leaves(params),
                       time.perf_counter() - t0)
    (gl, gg, gp, gs), (cl, cg, cp, cs) = res["cuda"], res["cpu"]
    # on the card, in float64: at llama3_8b's width the CPU's norms of
    # the 128256-row embedding and head would take longer than the step
    errs = {"loss": rel_norm(gl, cl),
            "grads": max(dev_rel_norm(a, b.cuda()) for a, b in zip(gg, cg)),
            "params": max(dev_rel_norm(a, b.cuda()) for a, b in zip(gp, cp))}
    emit({"phase": phase, "layers": cfg.num_hidden_layers,
          "dtype": "float32", "remat": remat,
          "seq": seq, "loss_cuda": float(gl), "loss_cpu": float(cl),
          "rel_err": errs, "tol": PARITY_TOL, "cuda_s": gs, "cpu_s": cs})
    for key, err in errs.items():
        require(err <= PARITY_TOL, f"training parity {key}: {err} > "
                f"{PARITY_TOL}")


def k8_counts(FA, FM):
    """Every flash launch counter, K1/K2 and K8."""
    return {"flash_attention_fwd": FA.flash_mha.fwd_launches,
            "flash_attention_bwd_dq": FA.flash_mha.dq_launches,
            "flash_attention_bwd_dkv": FA.flash_mha.dkv_launches,
            "flash_mha_masked": FM.flash_mha_masked.launches,
            "flash_mha_biased": FM.flash_mha_biased.launches,
            "flash_mha_masked_lse": FM.flash_mha_masked.lse_launches,
            "flash_mask_bwd_dq": FM.flash_mha_masked.dq_launches,
            "flash_mask_bwd_dkv": FM.flash_mha_masked.dkv_launches,
            "flash_mask_bwd_dbias": FM.flash_mha_masked.dbias_launches}


def zero_flash_counts(FA, FM):
    FA.flash_mha.fwd_launches = FA.flash_mha.dq_launches = 0
    FA.flash_mha.dkv_launches = 0
    FM.flash_mha_masked.launches = FM.flash_mha_biased.launches = 0
    FM.flash_mha_masked.lse_launches = FM.flash_mha_masked.dq_launches = 0
    FM.flash_mha_masked.dkv_launches = 0
    FM.flash_mha_masked.dbias_launches = 0


def counted(FA, FM, fn, want, what):
    """Run ``fn`` once between zeroed and read launch counters; every
    counter must be as ``want`` says (0 where it is not named)."""
    zero_flash_counts(FA, FM)
    res = fn()
    torch.cuda.synchronize()
    got = k8_counts(FA, FM)
    require(got == {k: want.get(k, 0) for k in got},
            f"{what}: launches {got}, want {want}")
    return res, got


def sq_loss_grads(fn, tensors):
    """out = fn(*leaves) and the gradient of sum(out.float() ** 2) w.r.t.
    each leaf (bench_longctx_masked's loss)."""
    leaves = [t.detach().requires_grad_() for t in tensors]
    out = fn(*leaves)
    return out, torch.autograd.grad(out.float().square().sum(), leaves)


def check_against_plain(FM, name, q, k, v, out, grads, vecs, bias, causal):
    """Per-row check of an autograd run (out, dq, dk, dv and dbias) of the
    K8 Function on [B, S, H, D] tensors against the plain versions fed
    the same q/k/v, the kernel forward's out and lse, and the loss's
    cotangent 2 * out."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    o, lse = FM._masked_fwd(qh, kh, vh, vecs, bias, causal, scale, True)
    do = (2 * o.float()).to(o.dtype)
    plain = (qh, kh, vh, o, lse, do, vecs, bias, causal, scale)
    ref_out, _ = FM._masked_fwd_xla(qh, kh, vh, vecs, bias, causal, scale)
    rows = {"out": row_rel_err(out.transpose(1, 2), ref_out).max().item()}
    del ref_out
    rows["dq"] = grad_row_err(grads[0].transpose(1, 2),
                              FM._masked_bwd_dq_xla(*plain)).max().item()
    ref_dk, ref_dv = FM._masked_bwd_dkv_xla(*plain)
    rows["dk"] = grad_row_err(grads[1].transpose(1, 2), ref_dk).max().item()
    rows["dv"] = grad_row_err(grads[2].transpose(1, 2), ref_dv).max().item()
    del ref_dk, ref_dv
    if bias is not None:
        rows["dbias"] = grad_row_err(
            grads[3], FM._masked_bwd_dbias_xla(*plain)).max().item()
    for key, err in rows.items():
        require(err <= ROW_TOL, f"{name} {key} vs plain: row error {err} > "
                f"{ROW_TOL}")
    return rows


def k8_split(fn, iters=3):
    """Where a call of ``fn`` spends its device time, by part of the K8
    call (:func:`k8_part`: forward, tile table, dq, dk/dv, dbias, K1/K2,
    other): ``torch.profiler`` over ``iters`` calls after one warm-up
    step of its schedule (a window opened on the call itself lost its
    first kernels), device ms per call."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=iters,
                                   repeat=1)) as prof:
        for _ in range(1 + iters):
            fn()
            torch.cuda.synchronize()
            prof.step()
    split = dict.fromkeys(("fwd", "table", "dq", "dkv", "dbias", "k1_k2",
                           "other"), 0.0)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            split[k8_part(ev.name.lower())] += \
                ev.time_range.elapsed_us() / 1e3 / iters
    return {"device_ms": split, "device_busy_ms": sum(split.values())}


def longctx_segments(B, S, dev):
    """bench_longctx_masked's three packed documents, [B, S] ids."""
    seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
    seg[:, S // 3:2 * S // 3] = 1
    seg[:, 2 * S // 3:] = 2
    return seg


def window_intervals(FM, B, S, dev):
    """10c's intervals: the three packed documents and a causal
    LONGCTX_WINDOW-token window, [B, 1, 4, S]."""
    docs = FM.segment_intervals(longctx_segments(B, S, dev), causal=True)
    return torch.cat([docs, FM.sliding_window_intervals(
        S, LONGCTX_WINDOW, B, device=dev)], dim=2)


def phase_longctx_masked(FA, FM):
    """10b, bench_longctx_masked (bench.py:323-366) through the port: the
    gradient of sum(sdpa(q, k, v, flashmask=vecs, is_causal=True)
    .float() ** 2) w.r.t. q, k and v, three packed documents, next to the
    same without the flashmask; launches per call, times, their ratio,
    and the masked run against the plain versions per row."""
    dev, dt = "cuda", torch.bfloat16
    B, S, H, D = 1, LONGCTX_SEQ, 16, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = ((torch.randn(B, S, H, D, device=dev, generator=gen) * 0.3)
               .to(dt) for _ in range(3))
    vecs = FM.segment_intervals(longctx_segments(B, S, dev), causal=True)

    def masked():
        return sq_loss_grads(lambda *t: FA.sdpa(*t, flashmask=vecs,
                                                is_causal=True), (q, k, v))

    def unmasked():
        return sq_loss_grads(lambda *t: FA.sdpa(*t, is_causal=True),
                             (q, k, v))

    (out, grads), masked_counts = counted(
        FA, FM, masked, {"flash_mha_masked": 1, "flash_mha_masked_lse": 1,
                         "flash_mask_bwd_dq": 1, "flash_mask_bwd_dkv": 1},
        "10b masked")
    _, unmasked_counts = counted(
        FA, FM, unmasked, {"flash_attention_fwd": 1,
                           "flash_attention_bwd_dq": 1,
                           "flash_attention_bwd_dkv": 1}, "10b unmasked")
    masked_ms = cuda_ms(masked, iters=5, warmup=1)
    unmasked_ms = cuda_ms(unmasked, iters=5, warmup=1)
    profiles = {"masked": k8_split(masked), "unmasked": k8_split(unmasked)}
    rows = check_against_plain(FM, "10b", q, k, v, out, grads, vecs, None,
                               True)
    # the streamed K8 backward's bound (phase 3's operation counts on the
    # visible pairs: forward 4, dq 6, dk/dv 8 x pairs x D) and the
    # library's fwd+bwd of the same loss: scaled_dot_product_attention
    # with the dense bool mask of the three documents
    pairs = visible_count(FM, vecs, B, H, S, S, True, dev)
    n, rows_f32, extra = B * H * S * D, B * H * S * 4, vecs.numel() * 4
    bwd_bound = bound(12 * n * 2 + 4 * rows_f32 + 2 * extra,
                      14 * pairs * D)
    fwd_bwd_bound = bound(16 * n * 2 + 5 * rows_f32 + 3 * extra,
                          18 * pairs * D)
    dense = (FM.dense_mask_from_intervals(vecs, S, S)
             & torch.ones(S, S, dtype=torch.bool, device=dev).tril())
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sq_loss_grads(lambda *t: sdpa(
            *(x.transpose(1, 2) for x in t), attn_mask=dense).transpose(
                1, 2), (q, k, v))

    library_ms = cuda_ms(library, iters=5, warmup=1)
    del dense
    emit({"phase": "10b", "name": "bench_longctx_masked", "B": B, "S": S,
          "H": H, "D": D, "dtype": "bfloat16", "documents": 3,
          "nvec": vecs.shape[2], "masked_ms": masked_ms,
          "unmasked_ms": unmasked_ms,
          "longctx8k_masked_attn_relative_mfu": unmasked_ms / masked_ms,
          "reference_gate_on_tpu": 0.9,
          "launches_masked_call": masked_counts,
          "launches_unmasked_call": unmasked_counts,
          "visible_pairs": pairs, "bwd_bound_ms": bwd_bound[0],
          "bwd_bound_by": bwd_bound[1],
          "fwd_bwd_bound_ms": fwd_bwd_bound[0],
          "fwd_bwd_bound_by": fwd_bwd_bound[1],
          "library_fwd_bwd_ms": library_ms, "profile": profiles,
          "max_row_rel_err": rows, "row_tol": ROW_TOL})
    return (q, k, v), masked_counts


def phase_longctx_window(FA, FM, qkv):
    """10c: flashmask_attention(causal=True, window_size=1024) at 10b's
    shape — the documents as 2-column start/end row indices, the window
    adding two more (nvec 4) — forward and backward against the plain
    versions per row."""
    from paddle_tpu_torch.nn.functional_extra2 import flashmask_attention
    q, k, v = qkv
    B, S = q.shape[0], q.shape[1]
    window = LONGCTX_WINDOW
    vecs = window_intervals(FM, B, S, q.device)
    startend = vecs[:, :, :2].movedim(2, -1).contiguous()  # [B, 1, S, 2]

    def call():
        return sq_loss_grads(
            lambda *t: flashmask_attention(*t, startend, causal=True,
                                           window_size=window), (q, k, v))

    (out, grads), counts = counted(
        FA, FM, call, {"flash_mha_masked": 1, "flash_mha_masked_lse": 1,
                       "flash_mask_bwd_dq": 1, "flash_mask_bwd_dkv": 1},
        "10c")
    ms = cuda_ms(call, iters=5, warmup=1)
    profile = k8_split(call)
    rows = check_against_plain(FM, "10c", q, k, v, out, grads, vecs, None,
                               True)
    emit({"phase": "10c", "name": "flashmask_attention", "S": S,
          "window_size": window, "nvec": vecs.shape[2], "fwd_bwd_ms": ms,
          "launches": counts, "profile": profile, "max_row_rel_err": rows,
          "row_tol": ROW_TOL})
    return counts


def phase_longctx_bias(FA, FM, qkv):
    """10d: the dense-bias route at 10b's shape (not a rung of the
    reference bench: it puts the K8 bias forward and the dbias kernel on
    the long-context path) — sdpa with a float [1, H, S, S] ALiBi
    attn_mask that requires grad; one biased forward with lse, one dq,
    dk/dv and dbias; against the plain versions per row."""
    q, k, v = qkv
    H, S = q.shape[2], q.shape[1]
    bias = alibi_bias(H, S, q.device)
    (out, grads), counts = counted(
        FA, FM, lambda: sq_loss_grads(
            lambda q, k, v, b: FA.sdpa(q, k, v, attn_mask=b, is_causal=True),
            (q, k, v, bias)),
        {"flash_mha_biased": 1, "flash_mha_masked_lse": 1,
         "flash_mask_bwd_dq": 1, "flash_mask_bwd_dkv": 1,
         "flash_mask_bwd_dbias": 1}, "10d")
    def call():
        return sq_loss_grads(lambda q, k, v, b: FA.sdpa(
            q, k, v, attn_mask=b, is_causal=True), (q, k, v, bias))

    ms = cuda_ms(call, iters=3, warmup=1)
    profile = k8_split(call)
    rows = check_against_plain(FM, "10d", q, k, v, out, grads, None, bias,
                               True)
    emit({"phase": "10d", "name": "alibi_bias_route", "S": S, "H": H,
          "bias": list(bias.shape), "fwd_bwd_ms": ms, "launches": counts,
          "profile": profile, "max_row_rel_err": rows, "row_tol": ROW_TOL})
    return counts


def gen_counts(mods):
    """Phase 8's launch counters and K7's."""
    return {**mode_launches(mods["QM"], mods["LM"], mods["PA"], mods["FM"]),
            "decode_attention": mods["DA"].decode_attention.launches}


def zero_gen_counts(mods):
    zero_launches(mods["QM"], mods["LM"], mods["PA"], mods["FM"])
    mods["DA"].decode_attention.launches = 0


def gen_call(mods, state, cfg, ids, new, k7=True, **kw):
    """One ``generate`` call with K7 on or off (``PALLAS_DECODE``), the
    counters zeroed just before and read just after; the wall time ends
    with a host fetch of the last token, as the bench's does.  Returns
    (ids, wall_s, launches)."""
    mods["DA"].PALLAS_DECODE = k7
    zero_gen_counts(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = mods["G"].generate(state, cfg, ids, max_new_tokens=new, **kw)
    int(out[0, -1])
    wall = time.perf_counter() - t0
    mods["DA"].PALLAS_DECODE = True
    counts = gen_counts(mods)
    require(tuple(out.shape) == (ids.shape[0], ids.shape[1] + new)
            and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            f"generate {kw}: output {tuple(out.shape)} or tokens outside "
            "the vocabulary")
    return out, wall, counts


def group_kernel(name):
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    if is_k8_forward(low):
        return "flash_mha_masked"
    if is_k8_backward(low):
        return "flash_mask_bwd"
    # K7, K3, K4, K5 and K9: the bf16 and f32 kernels (and the kernels of
    # older checkouts, which tools/flash_ab.py may time)
    for key, marks in (("decode_attention", ("decode_mma", "decode_f32",
                                             "decode_partial",
                                             "decode_combine")),
                       ("paged_attention", ("paged_mma", "paged_f32",
                                            "paged_any",
                                            "paged_attention")),
                       ("weight_only_matmul", ("wo_mma", "wo_gemv",
                                               "splitk_reduce")),
                       ("lora_gather_matmul", ("lora_gather", "lora_shrink",
                                               "lora_expand")),
                       ("grouped_ffn", ("::sm90::", "fwd_act_kernel",
                                        "fwd_out_kernel", "bwd_act_kernel",
                                        "bwd_dx_kernel", "bwd_dw_kernel",
                                        "colsum_kernel")),
                       ("matmul", ("gemm", "gemv", "cutlass", "xmma", "sm90",
                                   "cublas", "nvjet"))):
        if any(m in low for m in marks):
            return key
    return "other"


def device_kernels(fn):
    """(wall_ms, {kernel: device ms}) of one ``fn()`` under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per_kernel: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name] = (per_kernel.get(ev.name, 0.0)
                                   + ev.time_range.elapsed_us() / 1e3)
    return wall, per_kernel


def profile_generate_step(mods, state, cfg, ids, phase, name, n1=2, n2=10,
                          **kw):
    """Where one decode step's time goes: two profiled ``generate`` calls
    that differ only in their new tokens (``n1``, ``n2``; both run the
    same prefill), differenced per kernel and divided by ``n2 - n1``.
    The same two calls unprofiled give the step's wall time (the
    profiler adds host time of its own); the busy share is device busy
    time over that wall time."""
    runs = [device_kernels(lambda n=n: gen_call(mods, state, cfg, ids, n,
                                                **kw)) for n in (n1, n2)]
    steps = n2 - n1
    (w1, k1), (w2, k2) = runs
    plain_wall = (gen_call(mods, state, cfg, ids, n2, **kw)[1]
                  - gen_call(mods, state, cfg, ids, n1, **kw)[1]) * 1e3 / steps
    per_kernel = {n: (k2.get(n, 0.0) - k1.get(n, 0.0)) / steps
                  for n in set(k1) | set(k2)}
    groups: dict[str, float] = {}
    for n, ms in per_kernel.items():
        groups[group_kernel(n)] = groups.get(group_kernel(n), 0.0) + ms
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    rec = {"phase": phase, "profile": "decode_step", "mode": name,
           "wall_ms_per_step": plain_wall,
           "profiled_wall_ms_per_step": (w2 - w1) / steps,
           "device_ms_per_step": groups, "device_busy_ms_per_step": busy,
           "device_busy_share": busy / plain_wall,
           "top_kernels_ms_per_step": [[n[:80], ms] for n, ms in top]}
    emit(rec)
    return rec


def bench_model(mods, cfg):
    """The bench decode model (bench.py:424-436) with random bf16 weights
    from seed 0; (state, resident bytes)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = mods["init_state"](cfg, gen, device="cuda")
    torch.cuda.synchronize()
    return state, torch.cuda.memory_allocated()


def phase_bench_decode(mods, cfg):
    """11a, ``bench_decode`` (bench.py:451-482) through the port: batch
    8, prompt 128, 128 new tokens, greedy, dense bf16 and
    ``weight_quant="int8"``, each with K7 on and off; tokens/s = batch x
    new / wall, best of 2 after a warm-up call.  Launches per call: K7
    16 x 128 on and 0 off, the K8 forward 16 (the prefill), K4 int8 (4 x
    16 + 1) per decode step plus the prefill's lm_head row."""
    state, resident = bench_model(mods, cfg)
    L = cfg.num_hidden_layers
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, DECODE_PROMPT))).cuda()
    runs, outs = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for quant in (None, "int8"):
        kw = {"weight_quant": quant} if quant else {}
        for k7 in (True, False):
            name = f"{quant or 'dense'}_k7_{'on' if k7 else 'off'}"
            gen_call(mods, state, cfg, ids, DECODE_NEW, k7, **kw)
            best, counts = 0.0, None
            for _ in range(2):
                out, wall, counts = gen_call(mods, state, cfg, ids,
                                             DECODE_NEW, k7, **kw)
                best = max(best, 8 * DECODE_NEW / wall)
            want = {"decode_attention": L * DECODE_NEW if k7 else 0,
                    "paged_attention": 0, "flash_mha_masked": L,
                    "weight_only_matmul_int8": (
                        (4 * L + 1) * DECODE_NEW + 1 if quant else 0),
                    "weight_only_matmul_int4": 0, "lora_gather_matmul": 0}
            require(counts == want, f"11a {name}: launches {counts}, want "
                    f"{want}")
            runs[name] = {"tokens_per_s": best, "launches": counts,
                          "k4_launches_per_decode_step": (
                              counts["weight_only_matmul_int8"] - 1)
                          / DECODE_NEW if quant else 0}
            outs[name] = out
    rec = {"phase": "11a", "name": "bench_decode", "layers": L,
           "batch": 8, "prompt": DECODE_PROMPT, "new_tokens": DECODE_NEW,
           "runs": runs,
           "int8_over_dense_k7_on": runs["int8_k7_on"]["tokens_per_s"]
           / runs["dense_k7_on"]["tokens_per_s"],
           "int8_over_dense_k7_off": runs["int8_k7_off"]["tokens_per_s"]
           / runs["dense_k7_off"]["tokens_per_s"],
           "tokens_equal_k7_on_off": {
               q: bool((outs[f"{q}_k7_on"] == outs[f"{q}_k7_off"]).all())
               for q in ("dense", "int8")},
           "resident_bytes": resident,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(rec)
    for name, kw in (("dense_k7_on", {}), ("dense_k7_off", {"k7": False}),
                     ("int8_k7_on", {"weight_quant": "int8"})):
        profile_generate_step(mods, state, cfg, ids, "11a", name, **kw)
    return runs["dense_k7_on"]["launches"]


def phase_bench_paged(mods, cfg):
    """11b, ``bench_paged`` (bench.py:485-525): the same model, prompt
    2048 right-padded with lengths ``PAGED_LENGTHS``, 64 new tokens;
    dense with K7 on and off vs ``cache="paged", page_size=128`` (K3);
    one warm-up and one timed call each, as the bench does.  Launches per
    call: the K8 forward 16 (the prefill); K3 16 x 64 in the paged call
    and K7 16 x 64 in the dense call with K7 on, each 0 elsewhere."""
    state, _ = bench_model(mods, cfg)
    L = cfg.num_hidden_layers
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, PAGED_PROMPT))).cuda()
    lengths = np.array(PAGED_LENGTHS, np.int32)
    runs = {}
    for name, k7, kw in (("dense_k7_on", True, {}),
                         ("dense_k7_off", False, {}),
                         ("paged", True, {"cache": "paged",
                                          "page_size": 128})):
        gen_call(mods, state, cfg, ids, PAGED_NEW, k7, lengths=lengths,
                 **kw)
        torch.cuda.reset_peak_memory_stats()
        _, wall, counts = gen_call(mods, state, cfg, ids, PAGED_NEW, k7,
                                   lengths=lengths, **kw)
        want = {"weight_only_matmul_int8": 0, "weight_only_matmul_int4": 0,
                "lora_gather_matmul": 0, "flash_mha_masked": L,
                "paged_attention": L * PAGED_NEW if name == "paged" else 0,
                "decode_attention": (L * PAGED_NEW if name == "dense_k7_on"
                                     else 0)}
        require(counts == want, f"11b {name}: launches {counts}, want "
                f"{want}")
        runs[name] = {"tokens_per_s": 8 * PAGED_NEW / wall, "wall_s": wall,
                      "launches": counts,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit({"phase": "11b", "name": "bench_paged",
          "layers": cfg.num_hidden_layers, "batch": 8,
          "prompt": PAGED_PROMPT, "lengths": list(PAGED_LENGTHS),
          "new_tokens": PAGED_NEW, "runs": runs,
          "paged_over_dense_k7_on": runs["paged"]["tokens_per_s"]
          / runs["dense_k7_on"]["tokens_per_s"],
          "paged_over_dense_k7_off": runs["paged"]["tokens_per_s"]
          / runs["dense_k7_off"]["tokens_per_s"]})


def phase_long_decode(mods, cfg):
    """11c: llama3_8b at full width and depth, batch 8, every prompt
    ``LONG_PROMPT`` tokens and ``LONG_NEW`` new, so T = 8192 (the shape
    behind the reference's K7-off default): dense with K7 on, off, and
    paged.  One untimed, profiled warm-up call with 2 new tokens gives
    K7's device ms per decode step; then per mode the tokens/s of one
    call, the wall time of a ``max_new_tokens=1`` call (prefill + one
    token), the launches and the peak memory."""
    state, resident = bench_model(mods, cfg)
    L = cfg.num_hidden_layers
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (8, LONG_PROMPT))).cuda()
    _, kernels = device_kernels(
        lambda: gen_call(mods, state, cfg, ids, 2))
    k7_ms = sum(ms for n, ms in kernels.items()
                if group_kernel(n) == "decode_attention") / 2
    runs = {}
    for name, k7, kw in (("dense_k7_on", True, {}),
                         ("dense_k7_off", False, {}),
                         ("paged", True, {"cache": "paged",
                                          "page_size": 128})):
        torch.cuda.reset_peak_memory_stats()
        _, wall, counts = gen_call(mods, state, cfg, ids, LONG_NEW, k7, **kw)
        peak = torch.cuda.max_memory_allocated()
        _, wall1, _ = gen_call(mods, state, cfg, ids, 1, k7, **kw)
        want = {"weight_only_matmul_int8": 0, "weight_only_matmul_int4": 0,
                "lora_gather_matmul": 0, "flash_mha_masked": L,
                "paged_attention": L * LONG_NEW if name == "paged" else 0,
                "decode_attention": (L * LONG_NEW if name == "dense_k7_on"
                                     else 0)}
        require(counts == want, f"11c {name}: launches {counts}, want "
                f"{want}")
        runs[name] = {"tokens_per_s": 8 * LONG_NEW / wall, "wall_s": wall,
                      "wall_s_one_new_token": wall1,
                      "decode_ms_per_step": (wall - wall1) * 1e3
                      / (LONG_NEW - 1),
                      "launches": counts, "peak_mem_bytes": peak}
        release()
    emit({"phase": "11c", "name": "llama3_8b_long_decode", "layers": L,
          "batch": 8, "prompt": LONG_PROMPT, "new_tokens": LONG_NEW,
          "T": mods["G"]._cache_len(LONG_PROMPT, LONG_NEW),
          "k7_device_ms_per_step": k7_ms,
          "k7_device_ms_per_layer": k7_ms / L, "runs": runs,
          "resident_bytes": resident})


def first_part(card, cpu):
    """Index of the first differing token, or None."""
    return next((j for j, (a, b) in enumerate(zip(card, cpu)) if a != b),
                None)


def phase_generate_parity(mods, cfg8b):
    """Phase 12: generation at 2 layers of llama3_8b width in float32,
    card (kernels) vs CPU (plain versions), one state made on the host
    and carried to both.  Four ragged prompts up to 300 tokens, 16 new
    tokens: greedy tokens identical for dense (K7), paged (K3), int8 and
    int4 weight_quant and 4 beams with an eos id, except that a request
    may part where the CPU's top two scores tie (within ``TIE_TOL`` of
    their std; for beams, any two of the step's top K + 1 candidates),
    uncompared after that.  Then sampling on the card."""
    G = mods["G"]
    cfg = dataclasses.replace(cfg8b, num_hidden_layers=2, dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    state_cpu = mods["init_state"](cfg, torch.Generator().manual_seed(3),
                                   device="cpu")
    state_gpu = {k: v.to("cuda") for k, v in state_cpu.items()}
    rng = np.random.default_rng(3)
    lengths = np.array([300, 37, 201, 128], np.int32)
    ids = rng.integers(0, cfg.vocab_size, (4, 300))
    new = 16
    eos = None
    result = {}
    for name, kw in (("dense", {}), ("paged", {"cache": "paged"}),
                     ("int8", {"weight_quant": "int8"}),
                     ("int4", {"weight_quant": "int4"}),
                     ("beam4", {"num_beams": 4})):
        if name == "beam4":
            kw["eos_token_id"] = eos
        scores = []
        hook = "_top_k" if name == "beam4" else "_sample"
        orig = getattr(G, hook)

        def record(x, *a, orig=orig):
            scores.append(x.float().clone())
            return orig(x, *a)

        outs = {}
        for device, state in (("cuda", state_gpu), ("cpu", state_cpu)):
            setattr(G, hook, record if device == "cpu" else orig)
            t0 = time.perf_counter()
            outs[device] = G.generate(state, cfg, ids, max_new_tokens=new,
                                      lengths=lengths, device=device,
                                      **kw)[:, 300:].tolist()
            outs[device + "_s"] = time.perf_counter() - t0
        setattr(G, hook, orig)
        if eos is None:        # an eos the greedy decode reaches
            eos = int(outs["cpu"][0][4])
        parts = []
        for i, (card, cpu) in enumerate(zip(outs["cuda"], outs["cpu"])):
            t = first_part(card, cpu)
            if t is None:
                continue
            if hook == "_sample":
                lg = scores[t][i]
                margin = float((lg[card[t]] - lg[cpu[t]]).abs() / lg.std())
            else:   # beams: the closest pair among a step's top K + 1
                margin = math.inf
                for x in scores[:t + 1]:
                    row = x[i][x[i] > -1e8]
                    top = torch.sort(row, descending=True).values[:5]
                    margin = min(margin, float(
                        (top[:-1] - top[1:]).min() / row.std()))
            parts.append({"request": i, "token": t, "card": card[t],
                          "cpu": cpu[t], "margin_over_std": margin})
        same = outs["cuda"] == outs["cpu"]
        result[name] = same
        emit({"phase": 12, "mode": name, "layers": 2, "dtype": "float32",
              "prompt_lens": lengths.tolist(), "new_tokens": new,
              "eos_token_id": kw.get("eos_token_id"),
              "tokens_identical": same, "parted_at_tie": parts,
              "tie_tol": TIE_TOL, "cuda_s": outs["cuda_s"],
              "cpu_s": outs["cpu_s"]})
        require(all(p["margin_over_std"] <= TIE_TOL for p in parts),
                (name, parts, outs["cuda"], outs["cpu"]))
    greedy = G.generate(state_gpu, cfg, ids, max_new_tokens=new,
                        lengths=lengths)
    top1 = G.generate(state_gpu, cfg, ids, max_new_tokens=new,
                      lengths=lengths, do_sample=True, top_k=1, seed=5)
    draws = []
    orig = G._sample

    def record_draws(logits, generator, gen):
        tok = orig(logits, generator, gen)
        draws.append((logits.float().clone(), tok.clone(), gen))
        return tok

    G._sample = record_draws
    s1 = G.generate(state_gpu, cfg, ids, max_new_tokens=new,
                    lengths=lengths, do_sample=True, top_k=8, top_p=0.9,
                    seed=7)
    G._sample = orig
    s2 = G.generate(state_gpu, cfg, ids, max_new_tokens=new,
                    lengths=lengths, do_sample=True, top_k=8, top_p=0.9,
                    seed=7)
    outside = sum(int((~torch.isfinite(G._filter_logits(lg, gen)).gather(
        1, tok[:, None])).sum()) for lg, tok, gen in draws)
    support = [int(torch.isfinite(G._filter_logits(lg, gen)).sum(-1)
                   .max()) for lg, _, gen in draws]
    rec = {"phase": 12, "mode": "sampling",
           "top_k_1_equals_greedy": bool((top1 == greedy).all()),
           "same_seed_same_tokens": bool((s1 == s2).all()),
           "draws": len(draws) * len(lengths), "draws_outside_support":
           outside, "max_support": max(support),
           "distinct_sampled_vs_greedy": bool((s1 != greedy).any())}
    emit(rec)
    require(rec["top_k_1_equals_greedy"] and rec["same_seed_same_tokens"]
            and outside == 0 and rec["distinct_sampled_vs_greedy"], rec)
    result["sampling"] = rec
    return result


def decode_entry(records, launches):
    """The K7 entry of the kernels line: times at the bench decode shape
    (11a's), errors over every phase-3 shape, launches from 11a."""
    rep = records[0]
    return {"name": "decode_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/decode_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/decode_attention.py:87",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in records),
            "max_row_rel_err": max(r["max_row_rel_err"] for r in records),
            "shape": rep["shape"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"]}


def k8_entries(k8, launches):
    """The kernels-line entries of the K8 bias forward and backward: times
    at the phase-3 shape that runs each on the main path's kind of work
    (dq, dk/dv: SFT with padding; the bias forward and dbias: ALiBi),
    errors over every phase-3 K8 shape; launches from phase 10.  The
    backward entries' library time is one forward + backward of
    scaled_dot_product_attention with the dense mask.  The bf16 bias
    forward, dq, dk/dv and dbias are flash_sm90.cuh's kernels."""
    by = {r["shape"]: r for r in k8}
    sm90 = "paddle_tpu_torch/csrc/flash_sm90.cuh"
    ref = "paddle_tpu/ops/pallas/flash_mask.py"
    out = []
    for name, part, line, rep, lib, src in (
            ("flash_mha_biased", "fwd", 193, "alibi_bias", "fwd", sm90),
            ("flash_mask_bwd_dq", "dq", 927, "sft_padding", "fwd_bwd", sm90),
            ("flash_mask_bwd_dkv", "dkv", 954, "sft_padding", "fwd_bwd",
             sm90),
            ("flash_mask_bwd_dbias", "dbias", 976, "alibi_bias", "fwd_bwd",
             sm90)):
        keys = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv"),
                "dbias": ("dbias",)}[part]
        recs = [r for r in k8 if all(k in r["max_abs_err"] for k in keys)]
        r = by[rep]
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"{ref}:{line}", "launches": launches[name],
            "shape": rep,
            "max_abs_err": max(x["max_abs_err"][e] for x in recs
                               for e in keys),
            "max_row_rel_err": max(x["max_row_rel_err"][e] for x in recs
                                   for e in keys),
            "ms": r["ms"][part], "plain_ms": r["plain_ms"][part],
            "bound_ms": r["bound_ms"][part], "bound_by": r["bound_by"][part],
            "library_ms": r["library_ms"][lib]})
    return out


def flash_entries(flash, launches):
    """The K1 / K2 entries of the kernels line: times at the training
    shape (flash[0], the main path's), errors over all phase-3 shapes.
    The K2 entries' library time is one forward + backward of
    scaled_dot_product_attention (it computes dq, dk and dv together)."""
    train = flash[0]
    src = "paddle_tpu_torch/csrc/flash_sm90.cuh"     # the bf16 kernels
    ref = "paddle_tpu/ops/pallas/flash_attention.py"
    out = []
    for name, part, line, errs, lib in (
            ("flash_attention_fwd", "fwd", 576, ("out",), "fwd"),
            ("flash_attention_bwd_dq", "dq", 1036, ("dq",), "fwd_bwd"),
            ("flash_attention_bwd_dkv", "dkv", 1053, ("dk", "dv"),
             "fwd_bwd")):
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"{ref}:{line}", "launches": launches[name],
            "max_abs_err": max(f["max_abs_err"][e] for f in flash
                               for e in errs),
            "max_row_rel_err": max(f["max_row_rel_err"][e] for f in flash
                                   for e in errs),
            "ms": train["ms"][part], "plain_ms": train["plain_ms"][part],
            "bound_ms": train["bound_ms"][part],
            "bound_by": train["bound_by"][part],
            "library_ms": train["library_ms"][lib]})
    return out


def head_dim_entries(flash, k8, masked, routes, train15, serve16):
    """The kernels-line entries of the K1/K2 and K8 instances at head dims
    64 and 256: times and errors from their phase-3 records (K1/K2:
    ``tinyllama_train``, ``gemma2b_d256``; the K8 forward under intervals:
    the ``tinyllama_2048`` prefill and ``gemma2b_sft``; dq and dk/dv under
    intervals: ``tinyllama_sft``, ``gemma2b_sft``; the biased forward and
    dbias: ``alibi_d64``, ``alibi_d256``); launches from the main paths
    that run them (phases 15 and 25a's training for K1/K2 at d 64, 16's
    prefills for the K8 forward at d 64), else from phase 3's ``sdpa``
    calls at that head dim (``kernel_routes``).  Library times as in
    :func:`flash_entries` and :func:`k8_entries`."""
    sm90 = "paddle_tpu_torch/csrc/flash_sm90.cuh"
    fa_ref = "paddle_tpu/ops/pallas/flash_attention.py"
    fm_ref = "paddle_tpu/ops/pallas/flash_mask.py"
    recs = {r["shape"]: r for r in (*flash, *k8)}
    by_mask = {m["shape"]: m for m in masked}
    out = []

    def entry(name, replaces, rec, part, errs, lib, launches):
        out.append({
            "name": name, "route": "cuda", "source": sm90,
            "replaces": replaces, "launches": launches, "shape": rec["shape"],
            "max_abs_err": max(rec["max_abs_err"][e] for e in errs),
            "max_row_rel_err": max(rec["max_row_rel_err"][e] for e in errs),
            "ms": rec["ms"][part], "plain_ms": rec["plain_ms"][part],
            "bound_ms": rec["bound_ms"][part],
            "bound_by": rec["bound_by"][part],
            "library_ms": rec["library_ms"][lib]})

    for d, shape, train in ((64, "tinyllama_train", train15),
                            (256, "gemma2b_d256", None)):
        for name, part, line, errs, lib in (
                ("flash_attention_fwd", "fwd", 576, ("out",), "fwd"),
                ("flash_attention_bwd_dq", "dq", 1036, ("dq",), "fwd_bwd"),
                ("flash_attention_bwd_dkv", "dkv", 1053, ("dk", "dv"),
                 "fwd_bwd")):
            n = train[name] if train else routes[d]["sdpa"][name]
            entry(f"{name}_d{d}", f"{fa_ref}:{line}", recs[shape], part,
                  errs, lib, n)
    rep = by_mask["tinyllama_2048"]
    out.append({"name": "flash_mha_masked_d64", "route": "cuda",
                "source": sm90, "replaces": f"{fm_ref}:193",
                "launches": serve16["flash_mha_masked"],
                "shape": rep["shape"], "max_abs_err": rep["max_abs_err"],
                "max_row_rel_err": rep["max_row_rel_err"],
                **{k: rep[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}})
    entry("flash_mha_masked_d256", f"{fm_ref}:193", recs["gemma2b_sft"],
          "fwd", ("out",), "fwd", routes[256]["flashmask"]["flash_mha_masked"])
    for d, sft, alibi in ((64, "tinyllama_sft", "alibi_d64"),
                          (256, "gemma2b_sft", "alibi_d256")):
        mask, bias = routes[d]["flashmask"], routes[d]["bias"]
        entry(f"flash_mha_biased_d{d}", f"{fm_ref}:193", recs[alibi], "fwd",
              ("out",), "fwd", bias["flash_mha_biased"])
        entry(f"flash_mask_bwd_dq_d{d}", f"{fm_ref}:927", recs[sft], "dq",
              ("dq",), "fwd_bwd", mask["flash_mask_bwd_dq"])
        entry(f"flash_mask_bwd_dkv_d{d}", f"{fm_ref}:954", recs[sft], "dkv",
              ("dk", "dv"), "fwd_bwd", mask["flash_mask_bwd_dkv"])
        entry(f"flash_mask_bwd_dbias_d{d}", f"{fm_ref}:976", recs[alibi],
              "dbias", ("dbias",), "fwd_bwd", bias["flash_mask_bwd_dbias"])
    return out


def bert_flash_entries(rec, launches):
    """The kernels-line entries of K1/K2 at d 64, not causal: times and
    errors from phase 3's ``bert_base`` record, launches from 26c's timed
    BERT-base steps."""
    ref = "paddle_tpu/ops/pallas/flash_attention.py"
    return [{"name": f"{name}_d64_noncausal", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/flash_sm90.cuh",
             "replaces": f"{ref}:{line}", "launches": launches[name],
             "shape": rec["shape"],
             "max_abs_err": max(rec["max_abs_err"][e] for e in errs),
             "max_row_rel_err": max(rec["max_row_rel_err"][e]
                                    for e in errs),
             "ms": rec["ms"][part], "plain_ms": rec["plain_ms"][part],
             "bound_ms": rec["bound_ms"][part],
             "bound_by": rec["bound_by"][part],
             "library_ms": rec["library_ms"][lib]}
            for name, part, line, errs, lib in (
                ("flash_attention_fwd", "fwd", 576, ("out",), "fwd"),
                ("flash_attention_bwd_dq", "dq", 1036, ("dq",), "fwd_bwd"),
                ("flash_attention_bwd_dkv", "dkv", 1053, ("dk", "dv"),
                 "fwd_bwd"))]


# ------------------------------------------------- K9, K6 and the MoE rung
def moe_routing(TM, gen, tokens, E, k, D, routing):
    """(x [tokens, D] bf16, expert ids, gate values) from a seeded gate;
    ``"skewed"``: expert 0 is never chosen and expert 1 is every token's
    first choice (half the entries)."""
    x = torch.randn(tokens, D, device="cuda", generator=gen).bfloat16()
    gate = torch.randn(D, E, device="cuda", generator=gen) / D ** 0.5
    logits = x.float() @ gate
    if routing == "skewed":
        logits[:, 0] -= 30.0
        logits[:, 1] += 8.0
    idx, gv, _ = TM._topk_choices(logits, k, False, None)
    return x, idx, gv


def k9_operands(TM, gen, x, idx, gv, E, F, gated, bdt, dt=torch.bfloat16):
    """The tile-aligned buffer of ``grouped_dispatch_ffn`` for this routing
    and random expert weights: (x_buf, w1, b1, w2, b2), emap, dy, the
    real entry count and the per-expert entry counts."""
    D = x.shape[1]
    n, _, _, _, svalid, ft_slot, _, emap = TM._tile_layout(idx, gv, E, dt)
    x_buf = torch.where(svalid[:, None], x[ft_slot], 0).to(dt)
    f2 = 2 * F if gated else F

    def rnd(*shape, scale, dtype=dt):
        return (torch.randn(*shape, device=x.device, generator=gen)
                * scale).to(dtype)

    args = (x_buf, rnd(E, D, f2, scale=D ** -0.5), rnd(E, f2, scale=0.1,
                                                        dtype=bdt),
            rnd(E, F, D, scale=F ** -0.5), rnd(E, D, scale=0.1, dtype=bdt))
    dy = rnd(x_buf.shape[0], D, scale=1.0)
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    return args, emap, dy, n, counts


K9_OUTPUTS = ("out", "dx", "dw1", "db1", "dw2", "db2")


def k9_kernel(GF, args, emap, dy, gated):
    """(out, dx, dw1, db1, dw2, db2) through the kernels, under autograd."""
    leaves = [t.detach().requires_grad_() for t in args]
    out = GF.grouped_ffn(*leaves, emap, gated)
    return [out.detach(), *torch.autograd.grad(out, leaves, dy)]


def k9_plain(GF, args, emap, dy, gated):
    x_buf, w1, b1, w2, b2 = args
    return [GF.grouped_ffn_xla(*args, emap, gated),
            *GF._plain_bwd(x_buf, dy, w1, b1, w2, b2.dtype, emap, gated)]


def k9_row_errs(got, want):
    """Per-row errors of each output: out by ``row_rel_err``, the
    gradients by ``grad_row_err``; each weight gradient's rows are its
    [E * in, out] rows, the bias gradients one row per expert."""
    errs = {}
    for name, g, w in zip(K9_OUTPUTS, got, want):
        g2, w2 = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
        errs[name] = (row_rel_err(g2, w2) if name == "out"
                      else grad_row_err(g2, w2)).reshape(g.shape[:-1])
    return errs


def k9_yardstick(TM, gen, tokens, E, k, F, gated, args):
    """(capacity, {"fwd", "fwd_bwd": device ms}) of the sort path's expert
    FFN (two einsums, cuBLAS) on the capacity buffer this routing gives
    at capacity_factor 1.25, with K9's weights."""
    _, w1, b1, w2, b2 = args
    D = w1.shape[1]
    cap = TM._capacity(tokens, k, 1.25, E, None)
    xe = torch.randn(E, cap, D, device="cuda", generator=gen).bfloat16()
    ys = [t.detach().clone().bfloat16().requires_grad_()
          for t in (xe, w1, b1, w2, b2)]

    def einsums():
        h = torch.einsum("ecm,emf->ecf", ys[0], ys[1]) + ys[2][:, None, :]
        h = (torch.nn.functional.silu(h[..., :F]) * h[..., F:] if gated
             else torch.nn.functional.silu(h))
        return torch.einsum("ecf,efm->ecm", h, ys[3]) + ys[4][:, None, :]

    def einsums_fwd_bwd():
        out = einsums()
        torch.autograd.grad(out, ys, torch.ones_like(out))

    with torch.no_grad():
        yard = {"fwd": device_ms(einsums)}
    yard["fwd_bwd"] = device_ms(einsums_fwd_bwd)
    return cap, yard


def k9_bounds(args, emap, dy, n, F):
    """{"fwd", "bwd": (bound ms, "bytes" or "operations")} of K9 at these
    operands, counting the ``n`` real (token, expert) rows' operations;
    each input read once, each output written once (the bwd writes a
    gradient of each of x_buf, w1, b1, w2, b2 and reads all but b2)."""
    x_buf, w1, _, _, b2 = args
    R, D = x_buf.shape
    f2 = w1.shape[2]
    flops = {"fwd": 2 * n * D * f2 + 2 * n * F * D,
             "bwd": 6 * n * D * f2 + 4 * n * F * D}
    arg_bytes = sum(t.numel() * t.element_size() for t in args)
    nbytes = {"fwd": arg_bytes + emap.numel() * 4 + R * D * 2,
              "bwd": 2 * arg_bytes - b2.numel() * b2.element_size()
              + dy.numel() * 2 + emap.numel() * 4}
    return {p: bound(nbytes[p], flops[p]) for p in ("fwd", "bwd")}


def phase_k9(GF, TM, gen, name, tokens, E, k, D, F, gated, routing):
    """K9 forward and backward against their plain versions at one MoE
    layer's routing, bf16 (float32 biases in the gated record), per row
    (``K9_ROW_TOL``), with the planted fault: tile 0 pointed at the next
    expert must fail that tile's rows of out and dx and the gradient
    rows of both experts.  Times the kernels, the plain versions and the
    sort path's two expert einsums at its capacity (1.25) as the cuBLAS
    yardstick, both by device time (the yardstick's eager autograd call
    is shorter than its host work); the bound counts the real (token,
    expert) rows."""
    bdt = torch.float32 if gated else torch.bfloat16
    x, idx, gv = moe_routing(TM, gen, tokens, E, k, D, routing)
    args, emap, dy, n, counts = k9_operands(TM, gen, x, idx, gv, E, F,
                                            gated, bdt)
    del x
    R = args[0].shape[0]
    f0, b0 = GF.grouped_ffn.fwd_launches, GF.grouped_ffn.bwd_launches
    got = k9_kernel(GF, args, emap, dy, gated)
    torch.cuda.synchronize()
    require((GF.grouped_ffn.fwd_launches - f0,
             GF.grouped_ffn.bwd_launches - b0) == (1, 1),
            f"K9 {name}: one forward and one backward launch")
    again = k9_kernel(GF, args, emap, dy, gated)
    require(all(torch.equal(g, h) for g, h in zip(got, again)),
            f"K9 {name}: two runs must be bit-equal")
    del again
    want = k9_plain(GF, args, emap, dy, gated)
    errs = k9_row_errs(got, want)
    row_err = {o: errs[o].max().item() for o in K9_OUTPUTS}
    abs_err = {o: (g.float() - w.float()).abs().max().item()
               for o, g, w in zip(K9_OUTPUTS, got, want)}
    for o, err in row_err.items():
        require(err <= K9_ROW_TOL, f"K9 {name} {o}: row error {err} > "
                f"{K9_ROW_TOL}")
    unvisited = [e for e in range(E) if not bool((emap == e).any())]
    for e in unvisited:
        for o, g in zip(K9_OUTPUTS[2:], got[2:]):
            require(not bool(g[e].float().abs().any()),
                    f"K9 {name}: expert {e} owns no tile, {o} must be 0")
    # planted fault: tile 0 computed (and reduced) as the next expert's
    e0 = int(emap[0])
    bad = emap.clone()
    bad[0] = e0 + 1
    ferr = k9_row_errs(k9_kernel(GF, args, bad, dy, gated), want)
    fault = {o: ferr[o][:GF.TILE].min().item() for o in ("out", "dx")}
    for o in ("out", "dx"):
        require(fault[o] > K9_ROW_TOL, f"planted fault passed the K9 check "
                f"at {name}: tile 0's {o} min row error {fault[o]}")
    for o in K9_OUTPUTS[2:]:
        rows = ferr[o][e0:e0 + 2].reshape(-1)
        share = (rows > K9_ROW_TOL).float().mean().item()
        fault[o] = share
        require(share >= FAULT_SHARE, f"planted fault passed the K9 check "
                f"at {name}: {o} of experts {e0}, {e0 + 1}: only {share} "
                "of the rows fail")
    del got, want, ferr
    x_buf, w1, b1, w2, b2 = args
    ms = {"fwd": device_ms(lambda: GF._kernel_fwd(*args, emap, gated)),
          "bwd": device_ms(lambda: GF._kernel_bwd(x_buf, dy, w1, b1, w2,
                                                  b2, emap, gated))}
    plain_ms = {"fwd": cuda_ms(lambda: GF.grouped_ffn_xla(*args, emap,
                                                          gated),
                               iters=3, warmup=1),
                "bwd": cuda_ms(lambda: GF._plain_bwd(x_buf, dy, w1, b1, w2,
                                                     b2.dtype, emap, gated),
                               iters=3, warmup=1)}
    cap, yard = k9_yardstick(TM, gen, tokens, E, k, F, gated, args)
    bounds = k9_bounds(args, emap, dy, n, F)
    rec = {"kernel": "grouped_ffn", "shape": name, "tokens": tokens, "E": E,
           "top_k": k, "D": D, "F": F, "gated": gated,
           "bias_dtype": str(bdt).split(".")[-1], "R": R, "real_rows": n,
           "entries_per_expert": counts.tolist(), "unvisited": unvisited,
           "max_abs_err": abs_err, "max_row_rel_err": row_err,
           "row_tol": K9_ROW_TOL, "rerun_bit_equal": True,
           "fault": {"tile": 0, "experts": [e0, e0 + 1], **fault},
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": {p: b[0] for p, b in bounds.items()},
           "bound_by": {p: b[1] for p, b in bounds.items()},
           "library_ms": None, "yardstick": "sort path's expert einsums, "
           f"capacity {cap}", "yardstick_ms": yard}
    emit({"phase": 3, **rec})
    return rec


def phase_k9_f32(GF, TM):
    """Float32 instances of K9 (plain and gated) at a small shape, made on
    the host from a seed: the kernels on the card against the plain
    versions on the CPU, every output by relative norm (phase 7's
    limit)."""
    gen = torch.Generator().manual_seed(11)
    tokens, E, k, D, F = 512, 8, 2, 256, 384
    x = torch.randn(tokens, D, generator=gen)
    logits = x @ (torch.randn(D, E, generator=gen) / D ** 0.5)
    idx, gv, _ = TM._topk_choices(logits, k, False, None)
    for gated in (False, True):
        args, emap, dy, _, _ = k9_operands(TM, gen, x, idx, gv, E, F, gated,
                                           torch.float32, torch.float32)
        cpu = k9_plain(GF, args, emap, dy, gated)
        card = k9_kernel(GF, [t.cuda() for t in args], emap.cuda(),
                         dy.cuda(), gated)
        errs = {o: rel_norm(a, b) for o, a, b in zip(K9_OUTPUTS, card, cpu)}
        emit({"phase": 3, "kernel": "grouped_ffn", "shape": "f32_small",
              "gated": gated, "dtype": "float32", "tokens": tokens, "E": E,
              "D": D, "F": F, "card_vs_cpu_rel_err": errs,
              "tol": PARITY_TOL})
        for o, err in errs.items():
            require(err <= PARITY_TOL, f"K9 f32 card vs CPU {o}: {err}")


def phase_k6(RN, gen):
    """K6 against its plain version at llama3_8b width (8 x 2048 rows of
    4096, bf16), per row (``K6_ROW_TOL``), with a planted fault (the
    weight read one column off); a float32 instance card vs CPU; times
    beside the bound and ``torch.nn.functional.rms_norm`` (timing only:
    it rounds before the weight multiply), kernel and library by device
    time."""
    n, d = RMS_ROWS, RMS_WIDTH
    x = torch.randn(n, d, device="cuda", generator=gen).bfloat16()
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).bfloat16()
    before = RN.rms_norm.launches
    out = RN.rms_norm(x, w)
    torch.cuda.synchronize()
    require(RN.rms_norm.launches == before + 1, "K6: one launch per call")
    ref = RN._plain_rms(x, w, 1e-6)
    row_err = row_rel_err(out, ref).max().item()
    require(row_err <= K6_ROW_TOL, f"K6: row error {row_err} > {K6_ROW_TOL}")
    fault = row_rel_err(RN.rms_norm(x, torch.roll(w, 1)), ref)
    require(bool((fault > K6_ROW_TOL).all()),
            "planted fault (weight one column off) passed the K6 check: "
            f"min row error {fault.min().item()}")
    xs = torch.randn(64, d, generator=torch.Generator().manual_seed(12))
    ws = 1 + 0.1 * torch.randn(d, generator=torch.Generator().manual_seed(13))
    f32_err = rel_norm(RN.rms_norm(xs.cuda(), ws.cuda()),
                       RN.rms_norm(xs, ws))
    require(f32_err <= PARITY_TOL, f"K6 f32 card vs CPU: {f32_err}")
    ms = device_ms(lambda: RN._kernel(x, w, 1e-6))
    plain_ms = cuda_ms(lambda: RN._plain_rms(x, w, 1e-6))
    library_ms = device_ms(lambda: torch.nn.functional.rms_norm(
        x, (d,), w, 1e-6))
    bound_ms, bound_by = bound(2 * n * d * 2 + d * 2, 4 * n * d)
    rec = {"kernel": "rms_norm", "shape": "llama3_8b", "N": n, "d": d,
           "dtype": "bfloat16",
           "max_abs_err": (out.float() - ref.float()).abs().max().item(),
           "max_row_rel_err": row_err, "row_tol": K6_ROW_TOL,
           "fault_min_row_rel_err": fault.min().item(),
           "f32_card_vs_cpu_rel_err": f32_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    emit({"phase": 3, **rec})
    return rec


def moe_bench_config(M, **kw):
    """The reference bench's MoE rung (bench.py:381-385)."""
    cfg = dict(vocab_size=32000, hidden_size=1024, moe_intermediate_size=1408,
               num_hidden_layers=8, num_attention_heads=MOE_HEADS,
               num_key_value_heads=MOE_HEADS, num_experts=8, top_k=2,
               dtype="bfloat16")
    cfg.update(kw)
    return M.MoEConfig(**cfg)


def moe_param_counts(M, cfg, params):
    """(total, active by leaf name, the bench's own active count).  Active
    by name scales w1/b1/w2/b2 by top_k / E.  The bench (bench.py:408-
    412) counts as expert weights every stacked [L, ...] layer leaf whose
    third-from-last dim is E, which at L = E takes in q/k/v/o/gate too."""
    total = sum(t.numel() for t in M.tree_leaves(params))
    expert = sum(lp[k].numel() for lp in params["layers"]
                 for k in ("w1", "b1", "w2", "b2"))
    L, E = cfg.num_hidden_layers, cfg.num_experts
    bench_expert = sum(t.numel() for lp in params["layers"]
                       for t in lp.values()
                       if t.dim() + 1 >= 3 and ((L,) + tuple(t.shape))[-3]
                       == E)
    scale = cfg.top_k / E
    return (total, int(total - expert + expert * scale),
            int(total - bench_expert + bench_expert * cfg.top_k // E))


def flash_counts(FA):
    return {"flash_attention_fwd": FA.flash_mha.fwd_launches,
            "flash_attention_bwd_dq": FA.flash_mha.dq_launches,
            "flash_attention_bwd_dkv": FA.flash_mha.dkv_launches}


def zero_moe_counts(FA, GF, RN):
    FA.flash_mha.fwd_launches = 0
    FA.flash_mha.dq_launches = 0
    FA.flash_mha.dkv_launches = 0
    GF.grouped_ffn.fwd_launches = 0
    GF.grouped_ffn.bwd_launches = 0
    RN.rms_norm.launches = 0


def params_moved(M, params, before):
    """How far the timed steps moved the params: per leaf name (summed
    over layers) the share of elements that changed, and the whole
    tree's ||after - before|| / ||before||."""
    names = (["embed"] + [k for _ in params["layers"]
                          for k in M._layer_keys(params)]
             + ["norm", "head"])
    changed, numel, f32 = {}, {}, set()
    d2 = p2 = 0.0
    for name, old, new in zip(names, before, M.tree_leaves(params)):
        old = old.to(new.device)
        changed[name] = changed.get(name, 0) + int((old != new).sum())
        numel[name] = numel.get(name, 0) + new.numel()
        if new.dtype == torch.float32:
            f32.add(name)
        d2 += float((new.float() - old.float()).square().sum())
        p2 += float(old.float().square().sum())
    return {"changed_share": {k: changed[k] / numel[k] for k in changed},
            "float32_leaves": sorted(f32),
            "rel_change": math.sqrt(d2 / p2)}


def phase_moe_train(M, FA, GF, RN):
    """13a: the reference bench's MoE rung (bench.py:369-420) through the
    port's moe_llm: setup -> build_train_step, 1 + 2 warm-up steps and
    10 timed steps on one [16, 513] batch (the "sort" dispatch, K1/K2
    attention, no remat).

    Phase 14 holds the step's loss, gradients and update to the CPU's;
    this phase only shows that the step runs at full size and moves the
    params: the loss must fall over the timed steps, every float32 leaf
    (the routers) must change, and the share of each leaf's elements
    that changed is reported.  Plain SGD at lr 3e-4 leaves most bf16
    weights where they are (an update under half a bf16 ulp rounds
    away), so the loss falls by little."""
    cfg = moe_bench_config(M)
    t0 = time.perf_counter()
    params = M.setup(cfg, seed=0)
    step = M.build_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ + 1),
                        device="cuda", generator=gen)
    for _ in range(3):
        loss, params = step(params, ids)
    float(loss)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    before = [t.detach().to("cpu", copy=True)
              for t in M.tree_leaves(params)]
    zero_moe_counts(FA, GF, RN)
    t0 = time.perf_counter()
    losses = []
    for _ in range(MOE_STEPS):
        loss, params = step(params, ids)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = params_moved(M, params, before)
    del before
    launches = {**flash_counts(FA),
                "grouped_ffn_fwd": GF.grouped_ffn.fwd_launches,
                "grouped_ffn_bwd": GF.grouped_ffn.bwd_launches}
    losses = [float(x) for x in losses]
    L = cfg.num_hidden_layers
    want = {"flash_attention_fwd": L * MOE_STEPS,
            "flash_attention_bwd_dq": L * MOE_STEPS,
            "flash_attention_bwd_dkv": L * MOE_STEPS,
            "grouped_ffn_fwd": 0, "grouped_ffn_bwd": 0}
    require(launches == want, f"13a launches {launches} != {want}")
    require(all(math.isfinite(x) for x in losses), f"loss {losses}")
    require(losses[-1] < losses[0], f"13a loss did not fall: {losses}")
    require(all(share > 0 for name, share in moved["changed_share"].items()
                if name in moved["float32_leaves"]),
            f"13a: a float32 leaf did not change: {moved}")
    total, active, bench_active = moe_param_counts(M, cfg, params)
    tps = MOE_BATCH * MOE_SEQ * MOE_STEPS / wall
    emit({"phase": "13a", "name": "bench_moe", "params_total": total,
          "params_active": active, "params_active_bench_count":
          bench_active, "batch": MOE_BATCH, "seq": MOE_SEQ,
          "steps": MOE_STEPS, "setup_and_warmup_s": setup_s,
          "wall_s": wall, "s_per_step": wall / MOE_STEPS,
          "tokens_per_s": tps,
          "mfu_active": tps * 6 * active / BF16_FLOPS_PER_S,
          "mfu_active_bench_count": tps * 6 * bench_active
          / BF16_FLOPS_PER_S,
          "loss_first": losses[0], "loss_last": losses[-1],
          "losses": losses, "params_moved": moved, "launches_per_step":
          {k: v // MOE_STEPS for k, v in launches.items()},
          "resident_bytes": resident,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    wall_ms, per_kernel = device_kernels(lambda: step(params, ids))
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    emit({"phase": "13a", "profile": "train_step", "wall_ms": wall_ms,
          "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
          "kernels_seen": len(per_kernel),
          "top_kernels_ms": [[nm[:80], ms] for nm, ms in top]})
    return launches


MOE_MODES = ("sort", "grouped", "dense")


def phase_moe_layer(TM, GF, gen, name, tokens, E, k, D, F):
    """13b: one MoE layer, forward + backward of ``moe_dispatch_combine``
    (bf16 weights, f32 router) in the three dispatch modes: ms per call
    by device time (what orders the modes) and by CUDA events (the
    wall, which the host's eager work sets at these sizes),
    exactly one K9 forward and backward per grouped call, and grouped
    held against sort at capacity_factor E / top_k (nothing dropped) per
    output row (``ROW_TOL``: the sort path's einsums round h, the bias
    add and silu to bf16 where K9 keeps f32)."""
    silu = torch.nn.functional.silu

    def rnd(*shape, scale, dtype=torch.bfloat16):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    ops = (rnd(tokens, D, scale=1.0),
           rnd(D, E, scale=D ** -0.5, dtype=torch.float32),
           rnd(E, D, F, scale=D ** -0.5), rnd(E, F, scale=0.1),
           rnd(E, F, D, scale=F ** -0.5), rnd(E, D, scale=0.1))
    ct = rnd(tokens, D, scale=1.0)

    def call(mode, cf=1.25):
        leaves = [t.detach().requires_grad_() for t in ops]
        y, aux = TM.moe_dispatch_combine(*leaves, top_k=k,
                                         capacity_factor=cf,
                                         activation=silu, dispatch_mode=mode)
        grads = torch.autograd.grad((y.float() * ct.float()).sum() + aux,
                                    leaves)
        return y.detach(), aux.detach(), grads

    f0, b0 = GF.grouped_ffn.fwd_launches, GF.grouped_ffn.bwd_launches
    yg, ag, _ = call("grouped")
    torch.cuda.synchronize()
    per_call = (GF.grouped_ffn.fwd_launches - f0,
                GF.grouped_ffn.bwd_launches - b0)
    require(per_call == (1, 1), f"13b {name}: K9 launches per grouped call "
            f"{per_call} != (1, 1)")
    ys, as_, _ = call("sort", cf=E / k)
    rows = row_rel_err(yg, ys)
    require(rows.max().item() <= ROW_TOL, f"13b {name}: grouped vs "
            f"undropped sort row error {rows.max().item()} > {ROW_TOL}")
    require(abs(float(ag) - float(as_)) <= 1e-6, f"13b {name}: aux differs")
    ms = {mode: device_ms(lambda: call(mode), iters=5, warmup=1)
          for mode in MOE_MODES}
    wall = {mode: cuda_ms(lambda: call(mode), iters=5, warmup=1)
            for mode in MOE_MODES}
    rec = {"phase": "13b", "name": name, "tokens": tokens, "E": E,
           "top_k": k, "D": D, "F": F, "capacity": TM._capacity(
               tokens, k, 1.25, E, None),
           "device_ms_fwd_bwd": ms, "wall_ms_fwd_bwd": wall,
           "grouped_over_sort": ms["grouped"] / ms["sort"],
           "k9_launches_per_grouped_call": list(per_call),
           "grouped_vs_sort_max_row_rel_err": rows.max().item(),
           "row_tol": ROW_TOL}
    emit(rec)
    return rec


def phase_fused_rms_norm(RN):
    """13c: ``incubate.nn.functional.fused_rms_norm`` with a residual,
    forward + backward at llama3_8b width (bf16): exactly one K6 launch
    per call; ms per call by device time and by CUDA events."""
    from paddle_tpu_torch.incubate.nn.functional import fused_rms_norm
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, d = RMS_ROWS, RMS_WIDTH
    x, res, ct = (torch.randn(n, d, device="cuda", generator=gen).bfloat16()
                  for _ in range(3))
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).bfloat16()

    def call():
        leaves = [t.detach().requires_grad_() for t in (x, res, w)]
        out, resid = fused_rms_norm(leaves[0], leaves[2],
                                    residual=leaves[1])
        return torch.autograd.grad((out.float() * ct.float()).sum(), leaves)

    before = RN.rms_norm.launches
    grads = call()
    torch.cuda.synchronize()
    require(RN.rms_norm.launches == before + 1,
            "13c: one K6 launch per fused_rms_norm call")
    require(all(bool(torch.isfinite(g.float()).all()) for g in grads),
            "13c: gradients finite")
    emit({"phase": "13c", "name": "fused_rms_norm", "N": n, "d": d,
          "dtype": "bfloat16", "device_ms_fwd_bwd": device_ms(call),
          "wall_ms_fwd_bwd": cuda_ms(call, iters=10),
          "k6_launches_per_call": 1})


def record_routes(TM, routes):
    """Wrap ``distributed.moe._topk_choices`` to keep each call's expert
    ids and f32 probabilities (on the host); returns the original."""
    orig = TM._topk_choices

    def rec(logits, top_k, train, noise_key):
        out = orig(logits, top_k, train, noise_key)
        routes.append((out[0].detach().cpu(),
                       torch.softmax(logits.detach().float(), -1).cpu()))
        return out

    TM._topk_choices = rec
    return orig


def route_ties(card, cpu):
    """Compare the card's and the CPU's routing call by call.  Returns
    the ties (a token whose expert ids differ where the CPU's f32
    probabilities of the two experts lie within ``MOE_TIE_TOL``); raises
    on a difference that is not a tie."""
    require(len(card) == len(cpu), "routing: call counts differ")
    ties = []
    for c, ((ic, _), (ip, pp)) in enumerate(zip(card, cpu)):
        for tok in torch.nonzero((ic != ip).any(-1))[:, 0].tolist():
            for j in torch.nonzero(ic[tok] != ip[tok])[:, 0].tolist():
                a, b = int(ic[tok, j]), int(ip[tok, j])
                gap = abs(float(pp[tok, a]) - float(pp[tok, b]))
                require(gap <= MOE_TIE_TOL, f"routing differs at call {c} "
                        f"token {tok} (experts {a} / {b}, gap {gap}): not "
                        "a tie")
                ties.append({"call": c, "token": tok, "choice": j,
                             "experts": [a, b], "gap": gap})
    return ties


def phase_moe_parity(M, TM):
    """14: one moe_llm training step in float32 at 2 layers of the bench
    rung's width (batch 2 x 128), with no and with 2 shared experts, card
    (kernels) vs CPU (plain versions) from one set of params: loss,
    every grad and every param after the step by relative norm
    (``PARITY_TOL``); then the grouped ``moe_dispatch_combine`` (K9 in
    float32), its output and grads.  Routing must agree except at a tie
    of the CPU's probabilities; a run that meets a tie names it and
    compares nothing after it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    for shared in (0, 2):
        cfg = moe_bench_config(M, num_hidden_layers=2, dtype="float32",
                               num_shared_experts=shared)
        ids = torch.from_numpy(np.random.default_rng(9).integers(
            0, cfg.vocab_size, (2, 129)).astype(np.int64))
        params_cpu = M.setup(cfg, seed=1, device="cpu")
        res, routes = {}, {}
        for device in ("cuda", "cpu"):
            routes[device] = []
            orig = record_routes(TM, routes[device])
            try:
                params = M.tree_map(lambda t: t.to(device, copy=True),
                                    params_cpu)
                loss, grads = M.value_and_grad(params, ids.to(device), cfg)
                _, params = M.build_train_step(cfg, device=device)(params,
                                                                   ids)
            finally:
                TM._topk_choices = orig
            res[device] = (loss, M.tree_leaves(grads), M.tree_leaves(params))
        ties = route_ties(routes["cuda"], routes["cpu"])
        (gl, gg, gp), (cl, cg, cp) = res["cuda"], res["cpu"]
        errs = {"loss": rel_norm(gl, cl),
                "grads": max(rel_norm(a, b) for a, b in zip(gg, cg)),
                "params": max(rel_norm(a, b) for a, b in zip(gp, cp))}
        emit({"phase": 14, "model": "moe_llm", "layers": 2,
              "shared_experts": shared, "dtype": "float32",
              "tokens": ids.shape[0] * (ids.shape[1] - 1),
              "loss_cuda": float(gl), "loss_cpu": float(cl),
              "rel_err": errs, "tol": PARITY_TOL, "ties": ties})
        if not ties:
            for key, err in errs.items():
                require(err <= PARITY_TOL, f"14 moe_llm (shared {shared}) "
                        f"{key}: {err} > {PARITY_TOL}")
    # the grouped dispatch (K9, float32) on the card against the CPU
    gen = torch.Generator().manual_seed(21)
    s, E, D, F = 512, 8, 1024, 1408
    ops = [torch.randn(*sh, generator=gen) * sc
           for sh, sc in (((s, D), 1.0), ((D, E), D ** -0.5),
                          ((E, D, F), D ** -0.5), ((E, F), 0.1),
                          ((E, F, D), F ** -0.5), ((E, D), 0.1))]
    ct = torch.randn(s, D, generator=gen)
    res, routes = {}, {}
    for device in ("cuda", "cpu"):
        routes[device] = []
        orig = record_routes(TM, routes[device])
        try:
            leaves = [t.to(device).requires_grad_() for t in ops]
            y, aux = TM.moe_dispatch_combine(
                *leaves, top_k=2, activation=torch.nn.functional.silu,
                dispatch_mode="grouped")
            grads = torch.autograd.grad((y * ct.to(device)).sum() + aux,
                                        leaves)
        finally:
            TM._topk_choices = orig
        res[device] = [y.detach(), aux.detach(), *grads]
    ties = route_ties(routes["cuda"], routes["cpu"])
    names = ("y", "aux", "dx", "dgate_w", "dw1", "db1", "dw2", "db2")
    errs = {nm: rel_norm(a, b) for nm, a, b in zip(names, res["cuda"],
                                                   res["cpu"])}
    emit({"phase": 14, "model": "moe_dispatch_combine grouped", "tokens": s,
          "E": E, "D": D, "F": F, "dtype": "float32", "rel_err": errs,
          "tol": PARITY_TOL, "ties": ties})
    if not ties:
        for key, err in errs.items():
            require(err <= PARITY_TOL, f"14 grouped dispatch {key}: {err}")


def k9_entries(records, launches):
    """The K9 entries of the kernels line: times at the bench layer
    (records[0]), errors over every phase-3 K9 record, launches from
    13b.  No single PyTorch call computes the fused FFN (library_ms
    null); the yardstick is the sort path's two expert einsums."""
    rep = records[0]
    out = []
    for part, line, outs, yard in (
            ("fwd", 97, ("out",), "fwd"),
            ("bwd", 126, ("dx", "dw1", "db1", "dw2", "db2"), "fwd_bwd")):
        out.append({
            "name": f"grouped_ffn_{part}", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/grouped_ffn.cu",
            "replaces": f"paddle_tpu/ops/pallas/grouped_ffn.py:{line}",
            "launches": launches[f"grouped_ffn_{part}"],
            "shape": rep["shape"],
            "max_abs_err": max(r["max_abs_err"][o] for r in records
                               for o in outs),
            "max_row_rel_err": max(r["max_row_rel_err"][o] for r in records
                                   for o in outs),
            "ms": rep["ms"][part], "plain_ms": rep["plain_ms"][part],
            "bound_ms": rep["bound_ms"][part],
            "bound_by": rep["bound_by"][part], "library_ms": None,
            "yardstick_ms": rep["yardstick_ms"][yard]})
    return out


# --------------------------------------------- phase 22: hybrid training
# 22a, one NCCL rank: llama3_8b's width at HYBRID_LAYERS layers, bf16,
# remat="attn", 8 x 2048, HYBRID_STEPS timed steps; then the f32 step at
# 2 layers of that width, card vs CPU, at HYBRID_PARITY_SEQ tokens
HYBRID_LAYERS = 4
HYBRID_STEPS = 5
HYBRID_PARITY_SEQ = 64
# 22b, four NCCL ranks, one per card (where the machine has four):
# (name, (pp, dp, tp), schedule, n_virtual, sp, zero1, n_micro) at
# llama3_8b's width; f32 parity at HYBRID_RANK_PARITY_LAYERS layers on
# a HYBRID_RANK_PARITY_BATCH batch against the one-rank run on the same
# card, then bf16 timing at HYBRID_RANK_LAYERS layers, 8 x 2048
HYBRID_MESHES = (
    ("pp2_tp2_zb_vpp2_sp", (2, 1, 2), "zb", 2, True, False, 4),
    ("pp2_dp2_1f1b_zero1", (2, 2, 1), "1f1b", 1, False, True, 4),
    ("dp2_tp2_gpipe_sp_zero1", (1, 2, 2), "gpipe", 1, True, True, 1),
)
HYBRID_RANK_LAYERS = 8
HYBRID_RANK_PARITY_LAYERS = 4
HYBRID_RANK_PARITY_BATCH = (8, 128)
HYBRID_RANK_TIMEOUT_S = 900


def free_port():
    """A free TCP port on this machine, for a process group's rendezvous
    (``tcp://localhost:<port>``)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_mfu(tps, n_params, cfg, seq, cards=1):
    """``bench.py:131-136``: tokens/s over the cards x (6 N + 12 L H S)
    over their bf16 peak."""
    attn = 12 * cfg.num_hidden_layers * cfg.hidden_size * seq
    return tps * (6 * n_params + attn) / (cards * BF16_FLOPS_PER_S)


def phase_hybrid(cfg8b, TH, FA, FM, D, smi):
    """Phase 22a: the hybrid step through ``torch.distributed`` with one
    NCCL rank (a (1, 1, 1) mesh) at llama3_8b's width and
    ``HYBRID_LAYERS`` layers, bf16, ``remat="attn"``, 8 x 2048: one
    ``remat=True`` step must launch K1 2·L times, then the timed
    ``remat="attn"`` steps L times a step (K2's dq and dk/dv L times a
    step in both), the loss finite and falling; tokens/s, MFU, peak
    memory and a profile of one step.  Then one f32 ``remat="attn"``
    step at 2 layers of that width, card vs CPU.  Returns the timed
    steps' launches (the main path's)."""
    D.init_parallel_env(device="cuda", rank=0, world_size=1,
                        init_method=f"tcp://localhost:{free_port()}")
    mesh = TH.build_mesh(1)
    cfg = dataclasses.replace(cfg8b, num_hidden_layers=HYBRID_LAYERS)
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    params, opt = TH.setup(cfg, seed=0, dtype=torch.bfloat16, mesh=mesh)
    n_params = sum(t.numel() for t in TH.tree_leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch, seq = 8, 2048
    ids = torch.randint(0, cfg.vocab_size, (batch, seq + 1), device="cuda",
                        generator=gen)
    step = TH.build_train_step(cfg, mesh, remat="attn")
    loss, params, opt = step(params, opt, ids)                 # warm-up
    zero_flash_counts(FA, FM)
    TH.build_train_step(cfg, mesh, remat=True)(params, opt, ids)
    torch.cuda.synchronize()
    full = flash_counts(FA)
    require(full == {"flash_attention_fwd": 2 * L,
                     "flash_attention_bwd_dq": L,
                     "flash_attention_bwd_dkv": L},
            f"remat=True launches {full}, want 2L K1 and L K2 (L {L})")
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts(FA, FM)
    t0 = time.perf_counter()
    losses = []
    for _ in range(HYBRID_STEPS):
        loss, params, opt = step(params, opt, ids)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_counts(FA)
    want = {"flash_attention_fwd": L * HYBRID_STEPS,
            "flash_attention_bwd_dq": L * HYBRID_STEPS,
            "flash_attention_bwd_dkv": L * HYBRID_STEPS}
    require(launches == want, f"remat='attn' launches {launches} != {want}")
    losses = [float(x) for x in losses]
    require(all(math.isfinite(x) for x in losses), f"loss {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    tps = batch * seq * HYBRID_STEPS / wall
    emit({"phase": "22a", "run": "one NCCL rank", "card": smi,
          "mesh": [1, 1, 1], "backend": "nccl", "layers": L,
          "params": n_params, "batch": batch, "seq": seq,
          "remat": "attn", "steps": HYBRID_STEPS,
          "setup_and_warmup_s": setup_s, "wall_s": wall,
          "s_per_step": wall / HYBRID_STEPS, "tokens_per_s": tps,
          "mfu": train_mfu(tps, n_params, cfg, seq), "losses": losses,
          "launches": launches, "remat_true_launches": full,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    profile_train(step, params, opt, ids, "22a")
    del params, opt
    release()
    phase_train_parity(dataclasses.replace(cfg8b, num_hidden_layers=2,
                                           dtype="float32"), TH,
                       seq=HYBRID_PARITY_SEQ, phase="22a", remat="attn",
                       mesh=mesh)
    import torch.distributed as dist
    dist.destroy_process_group()
    return launches


def rank_shard(TH, full, cfg, mesh, n_virtual):
    """This rank's shard of a whole (one-device) param tree ``full``."""
    lay = TH.layout(mesh)
    mine = TH.rank_layers(cfg.num_hidden_layers, lay.pp, lay.p, n_virtual)

    def cut(t, key):
        return TH.shard(t, key, lay.tp, lay.t)
    return {"embed": cut(full["embed"], "embed"),
            "stages": [{k: cut(t, k) for k, t in full["stages"][li].items()}
                       for li in mine],
            "norm": full["norm"], "head": cut(full["head"], "head")}


def dev_rel_norm(a, b):
    """||a - b|| / ||b|| on the card, in float64."""
    return ((a.double() - b.double()).norm()
            / b.double().norm().clamp_min(1e-300)).item()


def hybrid_rank_worker(rank, world, port, results):
    """One NCCL rank of phase 22b (spawned, one per card): the f32
    parity of each ``HYBRID_MESHES`` mesh against the one-rank run on
    this card, then its bf16 timing; puts (rank, ok, records) on
    ``results``."""
    import traceback
    import torch.distributed as dist
    try:
        from paddle_tpu_torch import distributed as D
        from paddle_tpu_torch.models import llama3_8b
        from paddle_tpu_torch.models import llama_hybrid as TH
        D.init_parallel_env(device="cuda", rank=rank, world_size=world,
                            init_method=f"tcp://localhost:{port}",
                            timeout_s=HYBRID_RANK_TIMEOUT_S)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        records = []
        # f32 parity: every mesh against the one-rank run from the same
        # params (setup draws every leaf on every rank in one order)
        cfg = dataclasses.replace(llama3_8b(), dtype="float32",
                                  num_hidden_layers=HYBRID_RANK_PARITY_LAYERS)
        b, s = HYBRID_RANK_PARITY_BATCH
        ids = torch.from_numpy(np.random.default_rng(22).integers(
            0, cfg.vocab_size, (b, s + 1))).cuda()
        t0 = time.perf_counter()
        ref, ref_opt = TH.setup(cfg, seed=1)
        ref_loss, ref, _ = TH.build_train_step(cfg, remat="attn")(
            ref, ref_opt, ids)
        ref_loss = float(ref_loss)
        del ref_opt
        release()
        ref_s = time.perf_counter() - t0
        for name, dims, sched, v, sp, zero1, n_micro in HYBRID_MESHES:
            mesh = TH.build_mesh(world, *dims)
            t0 = time.perf_counter()
            params, opt = TH.setup(cfg, seed=1, mesh=mesh, n_virtual=v,
                                   zero1=zero1)
            loss, params, _ = TH.build_train_step(
                cfg, mesh, remat="attn", schedule=sched, n_virtual=v, sp=sp,
                zero1=zero1, n_micro=n_micro)(params, opt, ids)
            del opt
            want = rank_shard(TH, ref, cfg, mesh, v)
            errs = [dev_rel_norm(a, w) for a, w in
                    zip(TH.tree_leaves(params), TH.tree_leaves(want))]
            records.append({"mesh": name, "part": "parity",
                            "loss": float(loss), "loss_one_rank": ref_loss,
                            "loss_rel_err": abs(float(loss) - ref_loss)
                            / abs(ref_loss),
                            "param_max_rel_err": max(errs),
                            "one_rank_s": ref_s,
                            "s": time.perf_counter() - t0})
            del params, want
            release()
        del ref
        release()
        cfg = dataclasses.replace(llama3_8b(),
                                  num_hidden_layers=HYBRID_RANK_LAYERS)
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch, seq = 8, 2048
        ids = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                            device="cuda", generator=gen)
        for name, dims, sched, v, sp, zero1, n_micro in HYBRID_MESHES:
            records.append(hybrid_rank_timing(TH, D, cfg, ids, name, dims,
                                              sched, v, sp, zero1, n_micro))
            release()
        results.put((rank, True, records))
    except BaseException:                       # noqa: BLE001 - reported
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def hybrid_rank_timing(TH, D, cfg, ids, name, dims, sched, v, sp, zero1,
                       n_micro):
    """One mesh's bf16 timing on this rank: a warm-up step, then
    ``HYBRID_STEPS`` timed steps (the ranks start together), peak memory,
    and one profiled step's NCCL share of the device's busy time."""
    from torch.profiler import ProfilerActivity, profile
    mesh = TH.build_mesh(D.get_world_size(), *dims)
    params, opt = TH.setup(cfg, seed=0, dtype=torch.bfloat16, mesh=mesh,
                           n_virtual=v, zero1=zero1)
    n_local = sum(t.numel() for t in TH.tree_leaves(params))
    step = TH.build_train_step(cfg, mesh, remat="attn", schedule=sched,
                               n_virtual=v, sp=sp, zero1=zero1,
                               n_micro=n_micro)
    loss, params, opt = step(params, opt, ids)
    torch.cuda.synchronize()
    D.barrier()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = []
    for _ in range(HYBRID_STEPS):
        loss, params, opt = step(params, opt, ids)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    D.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(params, opt, ids)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    busy = nccl = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            busy += us
            if "nccl" in ev.name.lower():
                nccl += us
    return {"mesh": name, "part": "timing", "dims": list(dims),
            "schedule": sched, "n_virtual": v, "sp": sp, "zero1": zero1,
            "n_micro": n_micro, "local_params": n_local,
            "losses": [float(x) for x in losses], "wall_s": wall,
            "peak_mem_bytes": peak, "profiled_step_ms": prof_wall * 1e3,
            "device_busy_ms": busy / 1e3, "nccl_ms": nccl / 1e3,
            "nccl_share": nccl / busy if busy else None}


def phase_hybrid_ranks(smi, n_cards=4):
    """Phase 22b: ``n_cards`` NCCL ranks, one per card, spawned with
    ``torch.multiprocessing``; each runs :func:`hybrid_rank_worker`.  A
    rank that fails, or gives no result within the time limit, fails the
    phase; every process is stopped before it returns."""
    import queue as queue_mod
    import torch.multiprocessing as mp
    from paddle_tpu_torch.models import llama3_8b
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=hybrid_rank_worker,
                         args=(r, n_cards, port, results))
             for r in range(n_cards)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.perf_counter() + HYBRID_RANK_TIMEOUT_S
    try:
        while len(out) + len(errors) < n_cards:
            try:
                rank, ok, res = results.get(
                    timeout=max(1.0, deadline - time.perf_counter()))
            except queue_mod.Empty:
                errors.append("no result from every rank within "
                              f"{HYBRID_RANK_TIMEOUT_S} s")
                break
            if ok:
                out[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
    finally:
        for p in procs:
            p.join(timeout=60 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
    require(not errors, "phase 22b: " + "\n".join(errors))
    cfg = dataclasses.replace(llama3_8b(),
                              num_hidden_layers=HYBRID_RANK_LAYERS)
    n_params = (2 * cfg.vocab_size * cfg.hidden_size + cfg.hidden_size
                + cfg.num_hidden_layers * (
                    2 * cfg.hidden_size
                    + 2 * cfg.hidden_size * cfg.hidden_size
                    + 2 * cfg.hidden_size * cfg.num_key_value_heads
                    * cfg.head_dim
                    + 3 * cfg.hidden_size * cfg.intermediate_size))
    for i, (name, *_rest) in enumerate(HYBRID_MESHES):
        par = [out[r][i] for r in range(n_cards)]
        loss_err = max(p["loss_rel_err"] for p in par)
        param_err = max(p["param_max_rel_err"] for p in par)
        emit({"phase": "22b", "run": f"{n_cards} NCCL ranks", "card": smi,
              "mesh": name, "part": "f32 parity vs one rank",
              "layers": HYBRID_RANK_PARITY_LAYERS,
              "batch": list(HYBRID_RANK_PARITY_BATCH),
              "loss": par[0]["loss"], "loss_one_rank": par[0]["loss_one_rank"],
              "loss_rel_err": loss_err, "param_max_rel_err": param_err,
              "tol": PARITY_TOL, "s": max(p["s"] for p in par)})
        require(loss_err <= PARITY_TOL and param_err <= PARITY_TOL,
                f"phase 22b {name}: loss {loss_err}, params {param_err} > "
                f"{PARITY_TOL}")
    for i, (name, *_rest) in enumerate(HYBRID_MESHES):
        tim = [out[r][len(HYBRID_MESHES) + i] for r in range(n_cards)]
        wall = max(t["wall_s"] for t in tim)
        tps = 8 * 2048 * HYBRID_STEPS / wall
        losses = tim[0]["losses"]
        require(all(math.isfinite(x) for x in losses) and
                losses[-1] < losses[0], f"phase 22b {name} loss {losses}")
        emit({"phase": "22b", "card": smi, "mesh": name, "part": "bf16 timing",
              "layers": HYBRID_RANK_LAYERS, "params": n_params,
              "batch": 8, "seq": 2048, "steps": HYBRID_STEPS,
              "wall_s": wall, "tokens_per_s": tps,
              "tokens_per_s_per_card": tps / n_cards,
              "mfu": train_mfu(tps, n_params, cfg, 2048, n_cards),
              "losses": losses,
              "nccl_share": [t["nccl_share"] for t in tim],
              "nccl_ms": [t["nccl_ms"] for t in tim],
              "device_busy_ms": [t["device_busy_ms"] for t in tim],
              "profiled_step_ms": [t["profiled_step_ms"] for t in tim],
              "peak_mem_bytes": [t["peak_mem_bytes"] for t in tim],
              "local_params": [t["local_params"] for t in tim],
              **{k: tim[0][k] for k in ("dims", "schedule", "n_virtual",
                                        "sp", "zero1", "n_micro")}})


# ------------------------------- phase 23: serving tensor parallelism
TP_SIZES = (1, 2, 4)
TP_F32_NEW = 12                  # 23a's new tokens per request
TP_KILL_RANK = 2                 # 23c's victim
TP_KILL_TIMEOUT_S = 600          # 23c's child, from spawn to its report
TP_WALL_S = 900                  # the whole serving-tp run, at most
# 23a's logits check in the int8-page mode: each run quantizes its K/V
# rows per (token, head) from f32 values that tp and tp=1 compute ~1e-6
# apart (the row-sharded o and down sum their K in two parts), and a
# value that falls on the other side of a rounding edge moves by one
# int8 level (1/127 of its row's amax).  The mode reads both runs' int8
# pages and requires every entry within TP_PAGE_LEVELS of tp=1's.  The
# other modes keep F32_LOGITS_TOL.
TP_INT8_PAGES_TOL = 2 ** -8
TP_PAGE_LEVELS = 1


def tp_counters(W, obs):
    """Rank 0's all-reduce calls and the live mesh's control messages
    (count, host seconds)."""
    mesh = W._live
    return {"all_reduce": obs.metric_value("collective_calls_total",
                                           {"op": "all_reduce"}),
            "sends": mesh.sends if mesh is not None else 0,
            "send_s": mesh.send_s if mesh is not None else 0.0}


def page_levels(got, want):
    """Two runs' int8 KV pages (each a list, per page, of ``read_page``'s
    (k, v, kscale, vscale)): the most int8 levels any entry differs by,
    how many entries and token rows (a head's row of a page) differ, of
    how many, and the scales' largest relative difference."""
    worst = entries = rows = n_entries = n_rows = 0
    scale = 0.0
    for g, w in zip(got, want):
        for gq, wq in zip(g[:2], w[:2]):
            d = (gq.int() - wq.int()).abs()         # [L, kvh, ps, hd]
            worst = max(worst, int(d.max()))
            entries += int((d > 0).sum())
            rows += int((d > 0).any(-1).sum())
            n_entries += d.numel()
            n_rows += d[..., 0].numel()
        for gs, ws in zip(g[2:], w[2:]):
            scale = max(scale, float(((gs - ws).abs()
                                      / ws.abs().clamp_min(1e-30)).max()))
    return {"max_level_diff": worst, "entries_differing": entries,
            "entries": n_entries, "rows_differing": rows, "rows": n_rows,
            "max_scale_rel_diff": scale}


def tp_launches(QM, LM, PA, FM):
    return {"paged_attention": PA.paged_attention.launches,
            "flash_mha_masked": FM.flash_mha_masked.launches,
            "weight_only_matmul_int8": QM.weight_only_matmul.int8_launches,
            "lora_gather_matmul": LM.lora_gather_matmul.launches}


def ranks_in_step(engine):
    """Wrap ``engine.step`` (tp > 1): after every step each rank's ring,
    positions and next tokens must equal rank 0's.  Returns the list the
    wrapper counts its checks into."""
    checks = [0]
    if engine.tp == 1:
        return checks
    step = engine.step

    def checked():
        out = step()
        states = engine.runner.rank_states()
        for r, st in enumerate(states[1:], 1):
            for key in ("ring", "pos", "tok"):
                require(np.array_equal(st[key], states[0][key]),
                        f"rank {r}'s {key} differs from rank 0's")
        checks[0] += 1
        return out

    engine.step = checked
    return checks


def omit_rank0_o_partial(G):
    """The planted fault of 23a: rank 0 sends zeros for its o partial
    into the all-reduce, in the dense layers of ``models.generation``
    (the workers' partials still arrive, so every rank agrees on the
    wrong sum).  Returns the undo."""
    orig = G._out_proj

    def faulty(w, attn, *a, **kw):
        return orig(w, torch.zeros_like(attn), *a, **kw)

    G._out_proj = faulty
    return lambda: setattr(G, "_out_proj", orig)


def phase_serving_tp_parity(cfg8b, mods, smi):
    """Phase 23a (see the module docstring)."""
    (QM, LM, PA, FM, G, W, obs, create_engine, init_state,
     GenerationConfig, AdapterStore, random_adapter, RequestState) = mods
    cfg = dataclasses.replace(cfg8b, num_hidden_layers=2, dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    state = init_state(cfg, torch.Generator(device="cuda").manual_seed(23),
                       device="cuda")
    adapters = {f"a{i}": random_adapter(cfg, LORA_RANK, seed=30 + i)
                for i in range(2)}
    rng = np.random.default_rng(23)
    prefix = rng.integers(0, cfg.vocab_size, 96)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 40)]),
               rng.integers(0, cfg.vocab_size, 150),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 9)]),
               rng.integers(0, cfg.vocab_size, 70)]
    kw = dict(max_slots=2, page_size=64, max_model_len=512, sync_interval=4)

    def store():
        st = AdapterStore(cfg, capacity=2, rank=LORA_RANK)
        for a, w in adapters.items():
            st.register(a, w, alpha=LORA_ALPHA)
        return st

    def dense(engine):
        lo = [engine.submit(p, GenerationConfig(max_new_tokens=TP_F32_NEW))
              for p in prompts[:2]]
        for _ in range(4):
            engine.step()
        return lo + [engine.submit(p, GenerationConfig(
            max_new_tokens=TP_F32_NEW), priority=1) for p in prompts[2:3]]

    def every(names=(None,) * 4):
        return lambda engine: [
            engine.submit(p, GenerationConfig(max_new_tokens=TP_F32_NEW),
                          adapter=a) for p, a in zip(prompts, names)]

    records = {}

    def replay(engine):
        engine._proposer = ReplayProposer(SPEC_K, records["plain"])
        return every()(engine)

    modes = (
        ("dense_cache_preempt", dense, dict(enable_prefix_cache=True,
                                            preempt=True),
         ("preemptions", "spilled_pages", "restored_pages", "spill_bytes",
          "prefix_hits", "cached_tokens", "cow_copies")),
        # the prefix cache off: the resumed request's pages come back from
        # the host tier (read_page / write_page across the ranks)
        ("dense_host_tier", dense, dict(preempt=True),
         ("preemptions", "spilled_pages", "restored_pages", "spill_bytes")),
        ("int8_weights", every(), dict(quant="int8"), ()),
        ("int8_pages", every(), dict(kv_quant=True), ()),
        ("lora", every((None, "a0", "a1", "a0")), dict(lora=True), ()),
        ("spec_replay", replay, dict(spec_k=SPEC_K, enable_prefix_cache=True),
         ("spec_proposed", "spec_accepted", "spec_verify_steps",
          "spec_committed_tokens")))
    common = ("decode_steps", "host_syncs", "pages_allocated", "decode_traces",
              "prefill_buckets", "cached_prefill_buckets", "pages_in_use")

    def run(tp, script, mode_kw, fault=None):
        mkw = dict(mode_kw)
        if mkw.pop("lora", False):
            mkw["lora"] = store()
        engine = create_engine(cfg, state, mesh=tp, **kw, **mkw)
        checks = ranks_in_step(engine)
        rows = stash_logits(engine, RequestState)
        zero_launches(QM, LM, PA, FM)
        before = tp_counters(W, obs)
        undo = fault() if fault else None
        try:
            reqs = script(engine)
            engine.run_until_complete()
        finally:
            if undo:
                undo()
        torch.cuda.synchronize()
        after = tp_counters(W, obs)
        require(all(r.finish_reason == "length" for r in reqs),
                (tp, [r.finish_reason for r in reqs]))
        pages = ([engine.runner.read_page(p)
                  for p in range(engine.blocks.num_pages)]
                 if engine.kv_quant else None)
        return {"reqs": reqs, "rows": rows, "stats": engine.stats(),
                "pages": pages,
                "launches": tp_launches(QM, LM, PA, FM),
                "all_reduce": after["all_reduce"] - before["all_reduce"],
                "rank_checks": checks[0],
                "mesh": engine.runner.mesh_info()}

    # the drafts: tp=1's own plain run of the traffic
    plain = run(1, every(), dict(enable_prefix_cache=True))
    records["plain"] = [(r.prompt, r.output_tokens) for r in plain["reqs"]]
    ref, out = {}, []
    for tp in TP_SIZES:
        for name, script, mode_kw, keys in modes:
            got = run(tp, script, mode_kw)
            if tp == 1:
                ref[name] = got
                continue
            want = ref[name]
            parts, err = compare_runs(got["reqs"], want["reqs"], got["rows"],
                                      want["rows"])
            tol = (TP_INT8_PAGES_TOL if name == "int8_pages"
                   else F32_LOGITS_TOL)
            keys = common + keys
            stats = {k: got["stats"][k] for k in keys}
            rec = {"phase": "23a", "card": smi, "mode": name, "tp": tp,
                   "layers": 2, "dtype": "float32",
                   "tokens_identical": [r.output_tokens for r in got["reqs"]]
                   == [r.output_tokens for r in want["reqs"]],
                   "parted": [p for p in parts if "token" in p],
                   "max_logits_row_rel_err": err,
                   "logits_tol": tol, "tie_tol": TIE_TOL,
                   "stats": stats, "stats_equal": stats == {
                       k: want["stats"][k] for k in keys},
                   "launches_rank0": got["launches"],
                   "launches_tp1": want["launches"],
                   "all_reduce_calls": got["all_reduce"],
                   "rank_checks": got["rank_checks"],
                   "devices": [d["device"] for d in got["mesh"]["devices"]]}
            if name == "int8_pages":
                rec["pages_vs_tp1"] = page_levels(got["pages"],
                                                  want["pages"])
            emit(rec)
            out.append(rec)
            require(err <= tol, rec)
            require(all(p["tie_margin_over_std"] <= TIE_TOL
                        for p in rec["parted"]), rec)
            require(rec["stats_equal"], rec)
            require(got["rank_checks"] > 0, rec)
            require(got["stats"]["decode_traces"]
                    == (2 if name == "spec_replay" else 1), rec)
            if name.startswith("dense"):
                require(stats["preemptions"] == 1
                        and stats["spilled_pages"] >= 1, rec)
            if name == "dense_host_tier":
                require(stats["restored_pages"] >= 1, rec)
            if name == "spec_replay":
                require(stats["spec_accepted"] > stats["spec_verify_steps"]
                        > 0, rec)
            for kern in ("paged_attention", "flash_mha_masked"):
                require(got["launches"][kern] > 0 or name == "int8_pages"
                        and kern == "paged_attention", (kern, rec))
            if name == "int8_weights":
                require(got["launches"]["weight_only_matmul_int8"] > 0, rec)
            if name == "int8_pages":
                require(rec["pages_vs_tp1"]["max_level_diff"]
                        <= TP_PAGE_LEVELS, rec)
            if name == "lora":
                require(got["launches"]["lora_gather_matmul"] > 0, rec)
        if tp == 2:
            # the planted fault, on this mesh
            bad = run(2, dense, modes[0][2], fault=lambda: (
                omit_rank0_o_partial(G)))
            _, ferr = compare_runs(bad["reqs"], ref[modes[0][0]]["reqs"],
                                   bad["rows"], ref[modes[0][0]]["rows"])
            emit({"phase": "23a", "card": smi, "fault": "rank 0's o partial "
                  "left out of the all-reduce", "tp": 2,
                  "max_logits_row_rel_err": ferr, "logits_tol": F32_LOGITS_TOL})
            require(ferr > F32_LOGITS_TOL, f"planted fault passed the "
                    f"logits check: {ferr}")
        release()
    W.shutdown_meshes()
    del state
    release()
    return out


def card_processes():
    """(pid, card index) of each compute process ``nvidia-smi`` lists on
    each card (none where it lists none, as in some containers)."""
    def query(what):
        return [line.split(", ") for line in subprocess.run(
            ["nvidia-smi", f"--query-{what}", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip().splitlines()
            if line]
    index = {u: int(i) for i, u in query("gpu=index,uuid")}
    return [(int(pid), index.get(u)) for pid, u in
            query("compute-apps=pid,gpu_uuid")]


def host_window(engine, dec):
    """Each rank's host counters now: the mesh's (see ``WorkerMesh.
    host_stats``) at tp > 1, this process's at tp=1; rank 0's
    ``decode_step`` calls are ``dec``'s, timed around the runner's
    method (its message, its shard and its checks)."""
    if engine.tp > 1:
        ranks = engine.runner._mesh.host_stats()
    else:
        ranks = [{"pid": os.getpid(), "cpu_s": time.process_time(),
                  "wall_s": time.perf_counter(), "calls": {}}]
    ranks[0]["calls"] = dict(ranks[0]["calls"], decode_step=list(dec))
    return ranks


def host_growth(before, after):
    """Per rank, between two :func:`host_window` readings: the share of a
    core its process kept busy, and the host microseconds of each
    ``decode_step`` call."""
    out = []
    for a, b in zip(before, after):
        n0, s0 = a["calls"].get("decode_step", (0, 0.0))
        n1, s1 = b["calls"].get("decode_step", (0, 0.0))
        out.append({"pid": b["pid"],
                    "busy_cores": (b["cpu_s"] - a["cpu_s"])
                    / (b["wall_s"] - a["wall_s"]),
                    "decode_calls": n1 - n0,
                    "decode_us_per_call": (1e6 * (s1 - s0) / (n1 - n0)
                                           if n1 > n0 else None)})
    return out


def phase_serving_tp_bench(cfg, mods, smi):
    """Phase 23b (see the module docstring)."""
    (QM, LM, PA, FM, G, W, obs, create_engine, init_state,
     GenerationConfig, AdapterStore, random_adapter, RequestState) = mods
    release()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    # the state stays on the host: a tp engine scatters each rank's shard
    # from it, so no card holds a second, full copy (made on the card
    # from the seed, which is quicker, then moved)
    state = {k: v.cpu() for k, v in init_state(
        cfg, torch.Generator(device="cuda").manual_seed(0),
        device="cuda").items()}
    release()
    emit({"phase": "23b", "init_state_s": time.perf_counter() - t0,
          "state_device": "cpu",
          "card0_allocated_before": before,
          "card0_allocated_after": torch.cuda.memory_allocated(),
          "weight_bytes": sum(t.numel() * t.element_size()
                              for t in state.values())})
    warm, prompts, rng = serve_prompts(cfg.vocab_size)
    fresh = [rng.integers(0, cfg.vocab_size, n)
             for n in (128, 2048, 700, 1500, 333, 1524, 1324, 1900)]
    out = {}
    for tp in sorted(TP_SIZES, reverse=True):
        W.shutdown_meshes()         # each tp on fresh workers: clean peaks
        release()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = create_engine(cfg, state, mesh=tp, max_slots=8,
                               page_size=64, max_model_len=8192,
                               enable_prefix_cache=True, sync_interval=8)
        build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        resident = engine.runner.mesh_info()["devices"]
        procs = card_processes()
        if tp > 1:
            # a worker rank holds a context on its own card only
            rank_of = {pid: r for r, pid in
                       enumerate(engine.runner._mesh.pids, 1)}
            seen = [(rank_of[pid], card) for pid, card in procs
                    if pid in rank_of]
            require(all(r == card for r, card in seen),
                    f"a worker rank touched another card: {seen}")
        dec = [0, 0.0]
        decode_step = engine.runner.decode_step

        def timed_decode_step():
            t = time.perf_counter()
            out = decode_step()
            dec[0] += 1
            dec[1] += time.perf_counter() - t
            return out

        engine.runner.decode_step = timed_decode_step
        engine.submit(warm, GenerationConfig(max_new_tokens=8)).result()
        torch.cuda.synchronize()
        zero_launches(QM, LM, PA, FM)
        timings0, stats0 = dict(engine.timings), engine.stats()
        h0 = host_window(engine, dec)
        c0 = tp_counters(W, obs)
        t0 = time.perf_counter()
        reqs = [engine.submit(p, GenerationConfig(max_new_tokens=64))
                for p in prompts]
        engine.run_until_complete()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c1 = tp_counters(W, obs)
        ranks_host = host_growth(h0, host_window(engine, dec))
        launches = tp_launches(QM, LM, PA, FM)
        stats = engine.stats()
        for r in reqs:
            require(r.finish_reason == "length"
                    and len(r.output_tokens) == 64, (tp, r.finish_reason))
        require(stats["decode_traces"] == 1, stats["decode_traces"])
        require(launches["paged_attention"] > 0
                and launches["flash_mha_masked"] > 0, launches)
        ttft = [r.first_token_at - r.arrival_time for r in reqs]
        decode_s = (engine.timings["decode_s"] - timings0["decode_s"]
                    + engine.timings["host_sync_s"]
                    - timings0["host_sync_s"])
        decode_tokens = sum(len(r.output_tokens) - 1 for r in reqs)
        steps = stats["decode_steps"] - stats0["decode_steps"]
        prof = profile_decode(engine, fresh, GenerationConfig, phase="23b",
                              counters=lambda: tp_counters(W, obs))
        grown = prof["window_counts"]
        busy = sum(prof["device_ms_per_step"].values())
        nccl = prof["device_ms_per_step"].get("nccl", 0.0)
        peak = engine.runner.mesh_info()["devices"]
        rec = {"phase": "23b", "card": smi, "tp": tp,
               "layers": cfg.num_hidden_layers, "dtype": "bfloat16",
               "requests": len(reqs), "build_s": build_s, "wall_s": wall,
               "ttft_s_mean": float(np.mean(ttft)),
               "ttft_s_max": float(np.max(ttft)),
               "prefill_s": (engine.timings["prefill_s"]
                             - timings0["prefill_s"]),
               "decode_s": decode_s, "decode_tokens": decode_tokens,
               "decode_tokens_per_s": decode_tokens / decode_s,
               "decode_steps": steps, "launches_rank0": launches,
               "all_reduce_calls": c1["all_reduce"] - c0["all_reduce"],
               "all_reduces_per_decode_step": grown["all_reduce"]
               / prof["steps"],
               "control_messages": c1["sends"] - c0["sends"],
               "control_us_per_call": (1e6 * grown["send_s"] / grown["sends"]
                                       if grown["sends"] else None),
               "all_reduce_host_us_per_call_rank0": prof[
                   "host_us_per_collective"].get("collective:all_reduce"),
               "ranks_host": ranks_host,
               "wall_ms_per_step": prof["wall_ms_per_step"],
               "device_busy_share_rank0": prof["device_busy_share"],
               "nccl_ms_per_step_rank0": nccl,
               "nccl_share_of_busy_rank0": nccl / busy if busy else None,
               "resident_bytes": [d.get("bytes_in_use") for d in resident],
               "peak_bytes": [d.get("peak_bytes_in_use") for d in peak],
               "kv_pool_bytes": [d["kv_pool_bytes"] for d in resident],
               "weight_bytes": [d["weight_bytes"] for d in resident],
               "devices": [d["device"] for d in resident],
               "card_processes_seen": procs}
        emit(rec)
        if tp > 1:
            require(rec["all_reduces_per_decode_step"]
                    == 2 * cfg.num_hidden_layers, rec)
        out[tp] = rec
        engine.close()
        del engine, reqs
        release()
    W.shutdown_meshes()
    del state
    release()
    return out


def serving_tp_kill_child(results):
    """Phase 23c's rank 0 (a spawned process, so that what a dead peer
    leaves in its NCCL communicator stays out of the smoke's own
    process): a tp=4 engine with requests in flight; after 3 steps (the
    card synchronised, so every rank has finished them) rank
    ``TP_KILL_RANK``'s worker is killed, and the engine's next calls
    must raise naming it."""
    try:
        from paddle_tpu_torch.models import init_state, llama_tiny
        from paddle_tpu_torch.serving import GenerationConfig, create_engine
        from paddle_tpu_torch.serving.parallel import worker as W
        cfg = llama_tiny(hidden_size=512, intermediate_size=1024,
                         num_attention_heads=8, num_key_value_heads=8,
                         num_hidden_layers=2, dtype="bfloat16")
        state = init_state(cfg, torch.Generator(device="cuda").manual_seed(7),
                           device="cuda")
        engine = create_engine(cfg, state, mesh=4, max_slots=4, page_size=16,
                               max_model_len=256)
        mesh = engine.runner._mesh
        results.put(("pids", os.getpid(), mesh.pids))
        rng = np.random.default_rng(7)
        reqs = [engine.submit(rng.integers(0, cfg.vocab_size, 40),
                              GenerationConfig(max_new_tokens=64))
                for _ in range(4)]
        for _ in range(3):
            engine.step()
        torch.cuda.synchronize()
        victim = mesh._procs[TP_KILL_RANK - 1]
        t0 = time.perf_counter()
        victim.kill()
        victim.join()
        try:
            for _ in range(64):
                engine.step()
            raised = None
        except W.WorkerError as e:
            raised = (type(e).__name__, e.rank, str(e)[:300])
        results.put(("raised", raised, time.perf_counter() - t0,
                     sum(r.is_finished() for r in reqs), W.TIMEOUT_S))
        engine.close()
        results.put(("closed", [p.is_alive() for p in mesh._procs] or []))
    except BaseException:                        # noqa: BLE001 - reported
        import traceback
        results.put(("error", traceback.format_exc()))


def pid_alive(pid):
    """Whether ``pid`` runs (a zombie has stopped)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def phase_serving_tp_kill(smi):
    """Phase 23c (see :func:`serving_tp_kill_child`); every process the
    child started must be stopped at the end."""
    import queue as queue_mod
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    child = ctx.Process(target=serving_tp_kill_child, args=(results,))
    t0 = time.perf_counter()
    child.start()
    got = {}
    deadline = t0 + TP_KILL_TIMEOUT_S
    while "closed" not in got and "error" not in got:
        try:
            item = results.get(timeout=max(1.0, deadline
                                           - time.perf_counter()))
        except queue_mod.Empty:
            break
        got[item[0]] = item[1:]
    child.join(timeout=60)
    if child.is_alive():
        child.kill()
        child.join()
    pids = [got["pids"][0], *got["pids"][1]] if "pids" in got else []
    for pid in pids[1:]:
        for _ in range(50):                 # a worker exits within 1 s
            if not pid_alive(pid):
                break
            time.sleep(0.1)
    alive = [pid for pid in pids if pid_alive(pid)]
    for pid in alive:
        os.kill(pid, 9)
    rec = {"phase": "23c", "card": smi, "tp": 4, "killed_rank": TP_KILL_RANK,
           "raised": got.get("raised"), "closed": "closed" in got,
           "left_running": alive, "s": time.perf_counter() - t0}
    emit(rec)
    require("error" not in got, got.get("error"))
    raised = got.get("raised")
    require(raised is not None and raised[0] is not None
            and raised[0][1] == TP_KILL_RANK
            and f"rank {TP_KILL_RANK}" in raised[0][2]
            and raised[1] < raised[3], f"23c: {rec}")
    require(not alive and "closed" in got, f"23c: processes left: {rec}")


# ------------------------- phase 24: expert and context parallelism
# 24a: f32 parity of one moe_llm step at 2 layers of 13a's width, with 0
# and 2 shared experts, at each capacity factor, on each (name, (dp, ep))
# mesh against the one-rank run on card 0 from the same params, batch
# EP_PARITY_BATCH; the planted fault (capacity counted per holder, not
# globally) runs at EP_FAULT = (mesh, shared experts, capacity factor).
# A routing tie on any rank moves which entries drop, and so every
# number after it: the config runs again on the batch of the next seed
# of EP_PARITY_SEEDS, and fails if every seed ties
EP_PARITY_MESHES = (("dp2_ep2", (2, 2)), ("dp1_ep4", (1, 4)),
                    ("dp4_ep1", (4, 1)))
EP_PARITY_CF = (1.25, 0.35)
EP_PARITY_BATCH = (4, 128)
EP_PARITY_SEEDS = (24, 25, 26)
EP_FAULT = ("dp2_ep2", 0, 0.35)
# 24b: bf16 at full width: (name, (dp, ep), batch, seq); EP_STEPS timed
# steps after one warm-up
EP_BENCH = (("deepseek_moe_16b", (1, 4), 8, 512),
            ("bench_moe", (2, 2), MOE_BATCH, MOE_SEQ))
EP_STEPS = 5
# 24b's SGD rate: at the bench's 3e-4 an update under half a bf16 ulp
# rounds away, and 13a's model's loss moved by 3e-5 in five steps, up
# and down, on an H100; 1e-2 moves the bf16 leaves too
EP_LR = 1e-2
# 24c: ring and Ulysses over a sep axis of the four cards, bf16 at
# SEP_SHAPE (B, S, H, D) against one card's sdpa of the whole sequence
# per row, and float32 at SEP_F32_SHAPE by relative norm
SEP_SHAPE = (1, 16384, 32, 128)
SEP_PLAIN_HEADS = 4       # heads a call of 24c's plain K1/K2 versions takes
SEP_F32_SHAPE = (1, 2048, 8, 64)
SEP_F32_TOL = 1e-5
EP_WALL_S = 900                  # the whole expert-sep run, at most


def record_choices(TM, routes):
    """Wrap ``distributed.moe._choices`` (every routing call, one device
    or a holder of an expert-parallel mesh) to keep each call's expert
    ids and f32 probabilities; returns the original."""
    orig = TM._choices

    def rec(logits, top_k, train, noise_key):
        out = orig(logits, top_k, train, noise_key)
        routes.append((out[0].detach().contiguous(), out[2].detach()))
        return out

    TM._choices = rec
    return orig


def ep_shard(M, tree, lay):
    """A rank's shard (``lay``: its EPLayout) of a whole param tree."""
    return dict(tree, layers=[{k: M.shard(t, k, lay.ep, lay.j)
                               for k, t in lp.items()}
                              for lp in tree["layers"]])


def moe_active_params(cfg):
    """Params a token passes through: every leaf but the routed experts,
    which count top_k of E (13a's count by leaf name)."""
    h, f, L = cfg.hidden_size, cfg.moe_intermediate_size, \
        cfg.num_hidden_layers
    hd, nh, kvh = cfg.head_dim, cfg.num_attention_heads, \
        cfg.num_key_value_heads
    layer = (2 * h + h * (nh + 2 * kvh) * hd + nh * hd * h
             + h * cfg.num_experts + cfg.top_k * (2 * h * f + f + h)
             + 2 * h * cfg.num_shared_experts * f)
    return 2 * cfg.vocab_size * h + h + L * layer


def ep_reference(M, TM, D, cfg, ids):
    """The one-rank step on card 0 (mesh None) from ``M.setup(cfg,
    seed=1)``, broadcast to every rank: (loss, grads, params after the
    step, the first L routing calls' ids and probabilities, the entries
    dropped past the capacity)."""
    import torch.distributed as dist
    full = M.setup(cfg, seed=1)
    L = cfg.num_hidden_layers
    t, e, k = ids.shape[0] * (ids.shape[1] - 1), cfg.num_experts, cfg.top_k
    routes = []
    if D.get_rank() == 0:
        orig = record_choices(TM, routes)
        try:
            loss, grads = M.value_and_grad(full, ids, cfg)
            _, after = M.build_train_step(cfg)(
                M.tree_map(lambda x: x.clone(), full), ids)
        finally:
            TM._choices = orig
        loss = loss.reshape(1)
        grads, after = M.tree_leaves(grads), M.tree_leaves(after)
        routes = [x for call in routes[:L] for x in call]
    else:
        loss = torch.empty(1, device="cuda")
        grads = [torch.empty_like(x) for x in M.tree_leaves(full)]
        after = [torch.empty_like(x) for x in M.tree_leaves(full)]
        routes = [torch.empty(shape, dtype=dt, device="cuda")
                  for _ in range(L) for shape, dt in
                  (((t, k), torch.int64), ((t, e), torch.float32))]
    for x in [loss, *grads, *after, *routes]:
        dist.broadcast(x, 0)
    routes = list(zip(routes[0::2], routes[1::2]))
    cap = TM._capacity(t, k, cfg.capacity_factor, e, None)
    dropped = sum(int((TM._count_rank(idx, idx, e, torch.float32)[4]
                       >= cap).sum()) for idx, _ in routes)
    return float(loss), M._unflatten(full, grads), \
        M._unflatten(full, after), routes, dropped


def ep_run(M, TM, cfg, ids, dims, ref, plant=False):
    """One step of ``cfg`` on this rank of a (dp, ep) mesh from its shard
    of ``M.setup(cfg, seed=1)``: the loss's, grads' and updated params'
    relative errors against ``ref`` (:func:`ep_reference`), by norm over
    the rank's shard, and the routing ties against the one-rank run's.
    ``plant``: capacity counted per holder (the fault 24a must catch)."""
    import torch.distributed as dist
    ref_loss, ref_grads, ref_after, ref_routes, _ = ref
    mesh = M.build_mesh(dist.get_world_size(), *dims)
    lay = M.layout(mesh)
    params = M.setup(cfg, mesh, seed=1)
    routes = []
    orig_choices = record_choices(TM, routes)
    orig_cap = TM._capacity
    if plant:
        TM._capacity = lambda s, k, cf, e, cap: orig_cap(
            s // lay.holders, k, cf, e, cap)
    try:
        loss, grads = M.value_and_grad(params, ids, cfg, mesh)
        _, after = M.build_train_step(cfg, mesh)(params, ids)
    finally:
        TM._choices, TM._capacity = orig_choices, orig_cap
    L = cfg.num_hidden_layers
    tc = routes[0][0].shape[0]
    at = slice(lay.holder * tc, (lay.holder + 1) * tc)
    ties = route_ties(routes[:L], [(i[at], p[at]) for i, p in ref_routes]) \
        if not plant else []
    return {"loss": float(loss), "loss_one_rank": ref_loss,
            "loss_rel_err": abs(float(loss) - ref_loss) / abs(ref_loss),
            "grad_max_rel_err": max(dev_rel_norm(a, b) for a, b in zip(
                M.tree_leaves(grads),
                M.tree_leaves(ep_shard(M, ref_grads, lay)))),
            "param_max_rel_err": max(dev_rel_norm(a, b) for a, b in zip(
                M.tree_leaves(after),
                M.tree_leaves(ep_shard(M, ref_after, lay)))),
            "ties": ties}


def ep_parity(M, TM, D):
    """24a on this rank (see the constants above).  Every rank takes the
    same seeds: whether a seed tied anywhere is summed over the world."""
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    b, s = EP_PARITY_BATCH
    vocab = moe_bench_config(M).vocab_size
    out = []
    for shared in (0, 2):
        for cf in EP_PARITY_CF:
            t0 = time.perf_counter()
            cfg = moe_bench_config(M, num_hidden_layers=2, dtype="float32",
                                   num_shared_experts=shared,
                                   capacity_factor=cf)
            for n, seed in enumerate(EP_PARITY_SEEDS):
                ids = torch.from_numpy(np.random.default_rng(seed).integers(
                    0, vocab, (b, s + 1))).cuda()
                ref = ep_reference(M, TM, D, cfg, ids)
                recs = [{"part": "24a", "mesh": name, "dims": list(dims),
                         "shared": shared, "cf": cf, "seed": seed,
                         "dropped": ref[4],
                         **ep_run(M, TM, cfg, ids, dims, ref)}
                        for name, dims in EP_PARITY_MESHES]
                tied = torch.tensor([float(sum(len(r["ties"])
                                               for r in recs))],
                                    device="cuda")
                dist.all_reduce(tied)
                retry = bool(tied.item()) and n + 1 < len(EP_PARITY_SEEDS)
                for r in recs:
                    r["retry"] = retry
                out += recs
                if not retry:
                    break
                del ref
                release()
            if (shared, cf) == EP_FAULT[1:]:
                name, dims = next(m for m in EP_PARITY_MESHES
                                  if m[0] == EP_FAULT[0])
                out.append({"part": "24a fault", "mesh": name,
                            "shared": shared, "cf": cf, "seed": seed,
                            **ep_run(M, TM, cfg, ids, dims, ref,
                                     plant=True)})
            out.append({"part": "24a step wall", "shared": shared,
                        "cf": cf, "s": time.perf_counter() - t0})
            del ref
            release()
    return out


def ep_bench(M, FA, D, name, dims, batch, seq):
    """24b on this rank: ``name``'s model in bf16 at (dp, ep) ``dims``, a
    warm-up step and ``EP_STEPS`` timed steps (the ranks start together)
    on one [batch, seq + 1] batch; peak memory, K1/K2 launches and one
    profiled step's NCCL share of the device's busy time."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    cfg = M.deepseek_moe_16b() if name == "deepseek_moe_16b" \
        else moe_bench_config(M)
    mesh = M.build_mesh(D.get_world_size(), *dims)
    params = M.setup(cfg, mesh, seed=0)
    n_local = sum(t.numel() for t in M.tree_leaves(params))
    step = M.build_train_step(cfg, mesh, lr=EP_LR)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq + 1), device="cuda",
                        generator=gen)
    loss, params = step(params, ids)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    D.barrier()
    torch.cuda.reset_peak_memory_stats()
    for attr in ("fwd_launches", "dq_launches", "dkv_launches"):
        setattr(FA.flash_mha, attr, 0)
    t0 = time.perf_counter()
    losses = []
    for _ in range(EP_STEPS):
        loss, params = step(params, ids)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_counts(FA)
    peak = torch.cuda.max_memory_allocated()
    D.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(params, ids)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    busy = nccl = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            busy += us
            if "nccl" in ev.name.lower():
                nccl += us
    del params
    release()
    return {"part": "24b", "name": name, "dims": list(dims), "batch": batch,
            "seq": seq, "layers": cfg.num_hidden_layers,
            "experts": cfg.num_experts, "top_k": cfg.top_k,
            "shared": cfg.num_shared_experts, "local_params": n_local,
            "active_params": moe_active_params(cfg), "setup_s": setup_s,
            "losses": [float(x) for x in losses], "wall_s": wall,
            "launches": launches, "peak_mem_bytes": peak,
            "profiled_step_ms": prof_wall * 1e3,
            "device_busy_ms": busy / 1e3, "nccl_ms": nccl / 1e3,
            "nccl_share": nccl / busy if busy else None}


def sep_inputs(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(*shape, device="cuda", dtype=dtype, generator=gen)
            for _ in range(4)]


def exact_attention(full, causal):
    """Attention of the whole sequence in float64, head by head (q, k, v
    and the output's cotangent in ``full``, [B, S, H, D]): out, dq, dk,
    dv as float32 [B, S, H, D], the exact reference of 24c's bf16 rows."""
    res = [torch.empty(full[0].shape, dtype=torch.float32,
                       device=full[0].device) for _ in range(4)]
    mask = torch.ones(full[0].shape[1], full[0].shape[1], dtype=torch.bool,
                      device=full[0].device).tril() if causal else None
    for b in range(full[0].shape[0]):
        for h in range(full[0].shape[2]):
            qh, kh, vh, dh = (t[b, :, h].double() for t in full)
            scale = qh.shape[-1] ** -0.5
            s = qh @ kh.T * scale
            if causal:
                s.masked_fill_(~mask, float("-inf"))
            p = torch.softmax(s, dim=-1)
            del s
            out = p @ vh
            ds = p * (dh @ vh.T - (dh * out).sum(dim=-1, keepdim=True))
            res[3][b, :, h] = (p.T @ dh).float()
            del p
            res[0][b, :, h] = out.float()
            res[1][b, :, h] = (ds @ kh * scale).float()
            res[2][b, :, h] = (ds.T @ qh * scale).float()
            del ds
    return res


def sep_row_errs(got, ref):
    """Per-row errors of out, dq, dk, dv against ``ref`` (row_rel_err for
    the output, grad_row_err for the gradients)."""
    return {nm: (row_rel_err(g, r) if nm == "out" else grad_row_err(g, r))
            for nm, g, r in zip(("out", "dq", "dk", "dv"), got, ref)}


def sdpa_vs_plain(FA, full, ref, exact, causal):
    """24c's one-card ``sdpa`` rows (``ref``: out, dq, dk, dv of the
    whole sequence ``full``, [B, S, H, D]) against the plain bf16
    versions of K1 and K2, SEP_PLAIN_HEADS heads a call; the plain
    backward takes the kernel's out and lse, as phase 3's does.  Returns
    the per-row errors of ``sdpa`` against the plain rows, and the plain
    rows' own against float64 (``exact``)."""
    q, k, v, do = (t.transpose(1, 2) for t in full)     # [B, H, S, D]
    scale = q.shape[-1] ** -0.5
    out, lse = FA._flash_fwd(q, k, v, causal, scale)
    plain = [torch.empty(full[0].shape, dtype=torch.float32,
                         device=q.device) for _ in range(4)]
    for h in range(0, q.shape[1], SEP_PLAIN_HEADS):
        g = slice(h, h + SEP_PLAIN_HEADS)
        args = (q[:, g], k[:, g], v[:, g])
        got = [FA._flash_fwd_xla(*args, causal, scale)[0],
               FA._flash_bwd_dq_xla(*args, out[:, g], lse[:, g], do[:, g],
                                    causal, scale),
               *FA._flash_bwd_dkv_xla(*args, out[:, g], lse[:, g],
                                      do[:, g], causal, scale)]
        for dst, t in zip(plain, got):
            dst[:, :, g] = t.transpose(1, 2).float()
        del got
    del out, lse
    vs_plain = sep_row_errs(ref, plain)
    plain_exact = sep_row_errs(plain, exact)
    return ({nm: float(e.max()) for nm, e in vs_plain.items()},
            {nm: float(e.max()) for nm, e in plain_exact.items()})


def sep_check(name, got, ref, exact, sdpa_exact):
    """24c's bf16 rows of ``name``'s out, dq, dk, dv (``got``, the whole
    sequence) on rank 0.  Ulysses runs the one-card kernels at H/n heads:
    every row within ROW_TOL of the one-card ``sdpa`` (``ref``).  The ring
    computes in float32: every row within ROW_TOL of float64 (``exact``),
    and of ``sdpa`` within ROW_TOL plus that row's own distance from
    float64 (``sdpa_exact``): K2 takes delta from the bf16 output and
    rounds dS to bf16, which moves a query that sees few keys by up to
    0.11 at SEP_SHAPE on an H100."""
    vs_sdpa = sep_row_errs(got, ref)
    rec = {"row_err": {nm: float(e.max()) for nm, e in vs_sdpa.items()}}
    nm, e = max(vs_sdpa.items(), key=lambda kv: float(kv[1].max()))
    rec["worst_row"] = {"of": nm, "at": [int(i) for i in np.unravel_index(
        int(e.argmax()), tuple(e.shape))]}
    if name == "ulysses":
        rec["within"] = max(rec["row_err"].values()) <= ROW_TOL
        return rec
    vs_exact = sep_row_errs(got, exact)
    rec["row_err_vs_float64"] = {nm: float(e.max())
                                 for nm, e in vs_exact.items()}
    rec["within"] = all(
        float(vs_exact[nm].max()) <= ROW_TOL
        and bool((vs_sdpa[nm] <= ROW_TOL + sdpa_exact[nm]).all())
        for nm in vs_sdpa)
    return rec


def sep_call(fn, mine, mesh, causal):
    """fn's output and q/k/v gradients on this rank's chunks ``mine``
    (q, k, v, the output's cotangent)."""
    ts = [t.detach().clone().requires_grad_() for t in mine[:3]]
    out = fn(*ts, mesh, is_causal=causal)
    return [out.detach(), *torch.autograd.grad(out, ts, mine[3])]


def sep_parts(RA, mp_ops, FA, FAsdpa, D, C):
    """24c on this rank: ring and Ulysses attention over a sep axis of
    the world against one card's ``sdpa`` of the whole sequence (rank 0
    holds the check), bf16 per row and float32 by relative norm; ms of
    each; Ulysses' K1/K2 launches per call; and a ring whose first k/v
    rotation is skipped (the planted fault; every rank skips it, so the
    P2P pairs stay matched)."""
    from paddle_tpu_torch.distributed import ProcessMesh
    world, me = D.get_world_size(), D.get_rank()
    mesh = ProcessMesh(np.arange(world), ["sep"])
    group = mesh.group("sep")
    fns = (("ring", RA.ring_attention), ("ulysses", RA.ulysses_attention))
    out = []

    def chunks(ts):
        sl = ts[0].shape[1] // world
        return [t[:, me * sl:(me + 1) * sl].contiguous() for t in ts]

    def whole(ts):
        return [C.all_gather(None, t.contiguous(), group=group, axis=1)
                for t in ts]

    for dtype, shape in ((torch.bfloat16, SEP_SHAPE),
                         (torch.float32, SEP_F32_SHAPE)):
        torch.backends.cuda.matmul.allow_tf32 = False
        for causal in (True, False):
            full = sep_inputs(shape, dtype, 24)
            mine = chunks(full)
            ref = exact = sdpa_exact = vs_plain = plain_exact = None
            if me == 0:
                ref = sep_call(FAsdpa, full, None, causal)
                if dtype == torch.bfloat16:
                    exact = exact_attention(full, causal)
                    sdpa_exact = sep_row_errs(ref, exact)
                    vs_plain, plain_exact = sdpa_vs_plain(FA, full, ref,
                                                          exact, causal)
            for name, fn in fns:
                for attr in ("fwd_launches", "dq_launches", "dkv_launches"):
                    setattr(FA.flash_mha, attr, 0)
                got = whole(sep_call(fn, mine, mesh, causal))
                launches = flash_counts(FA)
                rec = {"part": "24c", "fn": name, "dtype": str(dtype),
                       "shape": list(shape), "causal": causal,
                       "launches_per_call": launches}
                if me == 0:
                    if dtype == torch.bfloat16:
                        rec.update(sep_check(name, got, ref, exact,
                                             sdpa_exact))
                    else:
                        rec["rel_err"] = {
                            nm: dev_rel_norm(g, r) for nm, g, r in
                            zip(("out", "dq", "dk", "dv"), got, ref)}
                del got
                if dtype == torch.bfloat16:
                    D.barrier()
                    rec["ms"] = cuda_ms(lambda: sep_call(fn, mine, mesh,
                                                         causal),
                                        iters=3, warmup=1)
                out.append(rec)
            if dtype == torch.bfloat16:
                out.append({"part": "24c", "fn": "sdpa one card",
                            "causal": causal, "shape": list(shape),
                            "row_err_vs_float64": None if me else {
                                nm: float(e.max())
                                for nm, e in sdpa_exact.items()},
                            "row_err_vs_plain": vs_plain,
                            "plain_row_err_vs_float64": plain_exact,
                            "ms": cuda_ms(lambda: sep_call(
                                FAsdpa, full, None, causal), iters=3,
                                warmup=1) if me == 0 else None})
                if not causal:
                    fault_exact = exact       # the planted fault's reference
            del full, mine, ref, exact, sdpa_exact
            release()
            D.barrier()
    # the planted fault: the first rotation of k and v skipped
    full = sep_inputs(SEP_SHAPE, torch.bfloat16, 24)
    orig, calls = mp_ops.ring_shift, [0]

    def skipped(tensors, group, shift=1):
        calls[0] += 1
        return list(tensors) if calls[0] == 1 else orig(tensors, group,
                                                        shift)
    mp_ops.ring_shift = skipped
    try:
        with torch.no_grad():
            got = whole([RA.ring_attention(*chunks(full)[:3], mesh,
                                           is_causal=False)])[0]
    finally:
        mp_ops.ring_shift = orig
    err = None
    if me == 0:
        with torch.no_grad():
            want = FAsdpa(*full[:3], is_causal=False)
        err = {"vs_sdpa": float(row_rel_err(got, want).max()),
               "vs_float64": float(row_rel_err(got, fault_exact[0]).max())}
    out.append({"part": "24c fault", "fn": "ring", "row_err": err})
    return out


def expert_sep_worker(rank, world, port, results):
    """One NCCL rank of phase 24 (spawned, one per card): 24a, 24b and
    24c; puts (rank, ok, records) on ``results``."""
    import traceback
    try:
        from paddle_tpu_torch import distributed as D
        from paddle_tpu_torch.distributed import collective as C
        from paddle_tpu_torch.distributed import moe as TM
        from paddle_tpu_torch.distributed import mp_ops
        from paddle_tpu_torch.models import moe_llm as M
        from paddle_tpu_torch.ops import ring_attention as RA
        from paddle_tpu_torch.ops.pallas import flash_attention as FA
        D.init_parallel_env(device="cuda", rank=rank, world_size=world,
                            init_method=f"tcp://localhost:{port}",
                            timeout_s=EP_WALL_S)
        records = []
        t0 = time.perf_counter()
        records += ep_parity(M, TM, D)
        records.append({"part": "24a wall",
                        "wall_s": time.perf_counter() - t0})
        for bench in EP_BENCH:
            t0 = time.perf_counter()
            records.append(ep_bench(M, FA, D, *bench))
            records.append({"part": "24b wall", "name": bench[0],
                            "wall_s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        records += sep_parts(RA, mp_ops, FA, FA.sdpa, D, C)
        records.append({"part": "24c wall",
                        "wall_s": time.perf_counter() - t0})
        results.put((rank, True, records))
    except BaseException:                       # noqa: BLE001 - reported
        results.put((rank, False, traceback.format_exc()))
    finally:
        # an NCCL group is aborted, not destroyed: a destroy waits on peers
        from paddle_tpu_torch.serving.parallel.worker import _leave_group
        _leave_group("cuda")


def phase_expert_sep(smi, n_cards=4):
    """Phase 24: ``n_cards`` NCCL ranks, one per card, each running
    :func:`expert_sep_worker`; rank 0's records hold the one-card
    comparisons.  A rank that fails, or gives no result in time, fails
    the phase; every process is stopped before it returns."""
    import queue as queue_mod
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=expert_sep_worker,
                         args=(r, n_cards, port, results))
             for r in range(n_cards)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.perf_counter() + EP_WALL_S
    try:
        while len(out) + len(errors) < n_cards:
            try:
                rank, ok, res = results.get(
                    timeout=max(1.0, deadline - time.perf_counter()))
            except queue_mod.Empty:
                errors.append(f"no result from every rank within "
                              f"{EP_WALL_S} s")
                break
            if ok:
                out[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
    finally:
        for p in procs:
            p.join(timeout=60 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
    require(not errors, "phase 24: " + "\n".join(errors))
    check_expert_sep(out, smi, n_cards)


def check_expert_sep(out, smi, n_cards):
    """Phase 24's records: printed, and held to their limits."""
    ranks = [out[r] for r in range(n_cards)]
    for i, rec in enumerate(ranks[0]):
        part = rec["part"]
        per_rank = [r[i] for r in ranks]
        if part == "24a":
            errs = {k: max(r[k] for r in per_rank)
                    for k in ("loss_rel_err", "grad_max_rel_err",
                              "param_max_rel_err")}
            ties = [t for r in per_rank for t in r["ties"]]
            emit({"phase": "24a", "card": smi, **{k: rec[k] for k in (
                "mesh", "dims", "shared", "cf", "seed", "dropped", "loss",
                "loss_one_rank")}, **errs, "tol": PARITY_TOL, "ties": ties,
                "rerun_at_next_seed": rec["retry"]})
            # a tie at this config on any rank: the next seed's batch
            # holds the limits (every rank's record says so); no seed left
            require(rec["retry"] or not ties, f"24a {rec['mesh']} shared "
                    f"{rec['shared']} cf {rec['cf']}: routing tied at every "
                    f"seed of {EP_PARITY_SEEDS}")
            if not rec["retry"]:
                require(all(v <= PARITY_TOL for v in errs.values()),
                        f"24a {rec['mesh']} shared {rec['shared']} cf "
                        f"{rec['cf']}: {errs} > {PARITY_TOL}")
        elif part == "24a fault":
            err = max(max(r["loss_rel_err"], r["grad_max_rel_err"],
                          r["param_max_rel_err"]) for r in per_rank)
            emit({"phase": "24a", "planted": "capacity per holder",
                  **{k: rec[k] for k in ("mesh", "shared", "cf", "seed")},
                  "max_rel_err": err, "tol": PARITY_TOL})
            require(err > PARITY_TOL, f"24a: the planted fault passed "
                    f"({err} <= {PARITY_TOL})")
        elif part == "24b" and "losses" in rec:
            wall = max(r["wall_s"] for r in per_rank)
            tokens = rec["batch"] * rec["seq"] * EP_STEPS
            tps = tokens / wall
            losses = rec["losses"]
            L = rec["layers"]
            emit({"phase": "24b", "card": smi, "cards": n_cards,
                  **{k: rec[k] for k in ("name", "dims", "batch", "seq",
                                         "layers", "experts", "top_k",
                                         "shared", "active_params")},
                  "steps": EP_STEPS, "wall_s": wall,
                  "tokens_per_s": tps, "tokens_per_s_per_card":
                  tps / n_cards, "mfu_active": tps * 6 * rec["active_params"]
                  / (n_cards * BF16_FLOPS_PER_S), "losses": losses,
                  "launches_per_step": {k: v / EP_STEPS for k, v in
                                        rec["launches"].items()},
                  "setup_s": [r["setup_s"] for r in per_rank],
                  "local_params": [r["local_params"] for r in per_rank],
                  "peak_mem_bytes": [r["peak_mem_bytes"] for r in per_rank],
                  "nccl_share": [r["nccl_share"] for r in per_rank],
                  "nccl_ms": [r["nccl_ms"] for r in per_rank],
                  "device_busy_ms": [r["device_busy_ms"] for r in per_rank],
                  "profiled_step_ms": [r["profiled_step_ms"]
                                       for r in per_rank]})
            require(all(math.isfinite(x) for x in losses)
                    and losses[-1] < losses[0], f"24b {rec['name']} loss "
                    f"{losses}")
            for r in per_rank:
                require(r["launches"] == {
                    "flash_attention_fwd": L * EP_STEPS,
                    "flash_attention_bwd_dq": L * EP_STEPS,
                    "flash_attention_bwd_dkv": L * EP_STEPS},
                    f"24b {rec['name']} launches {r['launches']}")
        elif part == "24c" and "fn" in rec:
            if "ms" in rec and rec["fn"] != "sdpa one card":
                rec["ms"] = [r["ms"] for r in per_rank]
            emit({"phase": "24c", "card": smi,
                  **{k: v for k, v in rec.items() if k != "part"}})
            if rec["fn"] == "ulysses":
                require(rec["launches_per_call"] == {
                    "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
                    "flash_attention_bwd_dkv": 1},
                    f"24c ulysses launches {rec['launches_per_call']}")
            if "within" in rec:
                require(rec["within"], f"24c {rec}: rows beyond {ROW_TOL}")
            if rec.get("row_err_vs_plain") is not None:
                require(max(rec["row_err_vs_plain"].values()) <= ROW_TOL,
                        f"24c one-card sdpa vs the plain K1/K2 versions: "
                        f"{rec['row_err_vs_plain']} > {ROW_TOL}")
            if "rel_err" in rec:
                require(max(rec["rel_err"].values()) <= SEP_F32_TOL,
                        f"24c {rec}: > {SEP_F32_TOL}")
        elif part == "24c fault":
            emit({"phase": "24c", "planted": "one ring rotation skipped",
                  "row_err": rec["row_err"], "tol": ROW_TOL})
            require(min(rec["row_err"].values()) > ROW_TOL, "24c: the "
                    f"planted ring fault passed ({rec['row_err']})")
        else:
            emit({"phase": part, "card": smi, **{
                k: v for k, v in rec.items() if k != "part"},
                "per_rank_wall_s": [r.get("wall_s", r.get("s"))
                                    for r in per_rank]})


# ------------------------------------------- phase 25: the eager Paddle API
EAGER_STEPS = 5          # 25a's timed steps, after one warm-up
EAGER_SEQ = 2048
EAGER_BATCH = 8
EAGER_PARITY_SEQ = 256   # 25b / 25c: f32, 2 layers of TinyLlama's width
EAGER_LOSS_TOL = 1e-5    # 25b: the Layer path against the functional one
EAGER_NEW = 16           # 25c: greedy tokens per prompt


def layer_state_of(params) -> dict:
    """A training param tree (``models/llama_hybrid``) under the Layer
    model's state keys (``functional_state()``: ``llama.embed_tokens.
    weight``, ...), the same tensors."""
    names = {"input_ln": "input_layernorm.weight",
             "q": "self_attn.q_proj.weight", "k": "self_attn.k_proj.weight",
             "v": "self_attn.v_proj.weight", "o": "self_attn.o_proj.weight",
             "post_ln": "post_attention_layernorm.weight",
             "gate": "mlp.gate_proj.weight", "up": "mlp.up_proj.weight",
             "down": "mlp.down_proj.weight"}
    out = {"llama.embed_tokens.weight": params["embed"]}
    for i, lp in enumerate(params["stages"]):
        out.update({f"llama.layers.{i}.{names[k]}": t
                    for k, t in lp.items()})
    out["llama.norm.weight"] = params["norm"]
    out["lm_head.weight"] = params["head"]
    return out


def eager_model(cfg, params, device):
    """A ``LlamaForCausalLM`` built through the Paddle API on ``device``
    ("cpu" or "gpu"), holding copies of the training tree's weights."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import llama as TL
    prev = paddle.device._current
    paddle.set_device(device)
    try:
        model = TL.LlamaForCausalLM(cfg)
    finally:
        paddle.device._current = prev
    dev = "cpu" if device == "cpu" else "cuda"
    model.load_functional_state({k: t.detach().to(dev, copy=True)
                                 for k, t in layer_state_of(params).items()})
    return model


def eager_step(paddle, model, crit, opt, ids):
    """One eager step through the Paddle API: the loss (a Tensor)."""
    t_ids = paddle.Tensor(ids)
    loss = crit(model(t_ids[:, :-1]), t_ids[:, 1:])
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def eager_train(cfg, TH, FA, plain, batch, smi):
    """25a at ``batch`` rows: the Layer path's timed steps (launches,
    plain calls, losses, tokens/s, MFU, peak memory, a profile), then the
    functional step's tokens/s on the same weights and batch."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import llama as TL
    params, _ = TH.setup(cfg, seed=0, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (batch, EAGER_SEQ + 1),
                        device="cuda", generator=gen)
    t0 = time.perf_counter()
    model = eager_model(cfg, params, "gpu")
    crit = TL.LlamaPretrainingCriterion()
    opt = paddle.optimizer.AdamW(parameters=model.parameters())
    n_params = sum(int(np.prod(p.shape)) for p in model.parameters())
    eager_step(paddle, model, crit, opt, ids)                  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    FA.flash_mha.fwd_launches = 0
    FA.flash_mha.dq_launches = 0
    FA.flash_mha.dkv_launches = 0
    plain0 = dict(plain)
    t0 = time.perf_counter()
    losses = [eager_step(paddle, model, crit, opt, ids)
              for _ in range(EAGER_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"flash_attention_fwd": FA.flash_mha.fwd_launches,
                "flash_attention_bwd_dq": FA.flash_mha.dq_launches,
                "flash_attention_bwd_dkv": FA.flash_mha.dkv_launches}
    plain_calls = {k: n - plain0[k] for k, n in plain.items()}
    losses = [float(x) for x in losses]
    layers = cfg.num_hidden_layers
    require(not any(plain_calls.values()),
            f"25a: the eager steps called plain attention: {plain_calls}")
    require(all(math.isfinite(x) for x in losses), f"25a loss {losses}")
    require(losses[-1] < losses[0], f"25a: loss did not fall: {losses}")
    want = {k: layers * EAGER_STEPS for k in launches}
    require(launches == want, f"25a flash launches {launches} != {want}")
    tps = batch * EAGER_SEQ * EAGER_STEPS / wall
    attn_flops = 12 * layers * cfg.hidden_size * EAGER_SEQ
    mfu = tps * (6 * n_params + attn_flops) / BF16_FLOPS_PER_S
    profile_train(lambda *_: eager_step(paddle, model, crit, opt, ids),
                  None, None, None, phase="25a")
    del model, opt, crit
    release()
    # the functional step (phases 6 and 15's path, without recompute:
    # the Layer path has none) on the same weights and batch
    step = TH.build_train_step(cfg, remat=False)
    fopt = TH.init_adamw(params)
    loss, params, fopt = step(params, fopt, ids)                # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EAGER_STEPS):
        loss, params, fopt = step(params, fopt, ids)
    torch.cuda.synchronize()
    f_tps = batch * EAGER_SEQ * EAGER_STEPS / (time.perf_counter() - t0)
    rec = {"phase": "25a", "card": smi, "params": n_params,
           "batch": batch, "seq": EAGER_SEQ, "steps": EAGER_STEPS,
           "remat": False, "setup_and_warmup_s": setup_s, "wall_s": wall,
           "s_per_step": wall / EAGER_STEPS, "tokens_per_s": tps,
           "mfu": mfu, "losses": losses, "launches": launches,
           "plain_attention_calls": plain_calls,
           "resident_bytes": resident, "peak_mem_bytes": peak,
           "functional_tokens_per_s": f_tps,
           "eager_over_functional": tps / f_tps}
    emit(rec)
    del params, fopt, step
    release()
    return launches


def eager_parity(cfg, TH, smi):
    """25b: f32 at 2 layers — the Layer path on the card against the same
    on the CPU: the loss of each of 2 AdamW steps and every param after
    them (two independent runs), and every grad of each step against the
    CPU's grads at the card's params of that step (a CPU probe model
    loaded with them: an AdamW step moves a near-zero gradient's element
    by up to lr either way, so the second step of two independent runs
    starts from params ~3e-5 apart, and their grads differ by more than
    the kernels do — printed beside); against the functional path on the
    card (loss, grads); and a planted fault (AdamW without its bias
    correction) that must fail the param check.  Returns the card and
    CPU models for 25c."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import llama as TL
    from paddle_tpu_torch.optimizer import AdamW

    class UncorrectedAdamW(AdamW):
        """The planted fault: AdamW without its bias correction."""

        def _update_param(self, p, g, lr):
            x = self._param_f32(p)
            if self._wd:
                x = x * (1.0 - lr * self._wd)
            m = self._beta1 * self._acc(p, "moment1") + (1 - self._beta1) * g
            v = self._beta2 * self._acc(p, "moment2") \
                + (1 - self._beta2) * torch.square(g)
            self._set_acc(p, "moment1", m)
            self._set_acc(p, "moment2", v)
            self._write_back(p, x - lr * m / (torch.sqrt(v) + self._epsilon))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params, _ = TH.setup(cfg, seed=1, dtype=torch.float32, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, EAGER_PARITY_SEQ + 1)).astype(np.int64))
    crit = TL.LlamaPretrainingCriterion()

    def grads_of(model, dev_ids):
        t_ids = paddle.Tensor(dev_ids)
        loss = crit(model(t_ids[:, :-1]), t_ids[:, 1:])
        loss.backward()
        return loss._data.detach().double().cpu(), {
            n: p._grad_data().detach().clone()
            for n, p in model.named_parameters()}

    probe = eager_model(cfg, params, "cpu")
    runs, models, probe_errs = {}, {}, []
    for name, device, opt_cls in (("cuda", "gpu", AdamW),
                                  ("cpu", "cpu", AdamW),
                                  ("fault", "gpu", UncorrectedAdamW)):
        model = eager_model(cfg, params, device)
        opt = opt_cls(parameters=model.parameters())
        dev_ids = ids.to("cpu" if device == "cpu" else "cuda")
        losses, grads = [], []
        t0 = time.perf_counter()
        for _ in range(2):
            if name == "cuda":      # the CPU's grads at these params
                probe.load_functional_state({
                    k: v.detach().cpu().clone()
                    for k, v in model.functional_state().items()})
                _, want = grads_of(probe, ids)
                probe.clear_gradients()
            loss, g = grads_of(model, dev_ids)
            if name == "cuda":
                probe_errs.append(max(dev_rel_norm(g[k], want[k].cuda())
                                      for k in want))
            losses.append(loss)
            grads.append(g)
            opt.step()
            opt.clear_grad()
        runs[name] = (losses, grads, {n: p._data.detach() for n, p
                                      in model.named_parameters()},
                      time.perf_counter() - t0)
        if name != "fault":
            models[name] = model
    del probe
    # the functional path at the same initial weights, on the card
    cparams = TH.tree_map(lambda t: t.to("cuda", copy=True), params)
    f_loss, f_grads = TH.value_and_grad(cparams, ids.cuda(), cfg, None,
                                        remat=False)
    f_grads = layer_state_of(f_grads)

    def worst(a, b):
        return max(dev_rel_norm(a[k].cuda(), b[k].cuda()) for k in b)

    (gl, gg, gp, gs), (cl, cg, cp, cs) = runs["cuda"], runs["cpu"]
    errs = {"loss": max(rel_norm(a, b) for a, b in zip(gl, cl)),
            "grads": max(probe_errs), "params": worst(gp, cp)}
    vs_fn = {"loss": rel_norm(gl[0], f_loss), "grads": worst(gg[0],
                                                             f_grads)}
    fault = worst(runs["fault"][2], cp)
    emit({"phase": "25b", "card": smi, "layers": cfg.num_hidden_layers,
          "dtype": "float32", "seq": EAGER_PARITY_SEQ, "steps": 2,
          "card_vs_cpu": errs, "grads_by_step": probe_errs,
          "independent_runs_grads_by_step": [worst(a, b)
                                             for a, b in zip(gg, cg)],
          "tol": PARITY_TOL, "layer_vs_functional": vs_fn,
          "loss_tol": EAGER_LOSS_TOL, "fault_params": fault,
          "loss_cuda": [float(x) for x in gl],
          "loss_cpu": [float(x) for x in cl], "cuda_s": gs, "cpu_s": cs})
    for key, err in errs.items():
        require(err <= PARITY_TOL, f"25b card vs CPU {key}: {err}")
    require(vs_fn["loss"] <= EAGER_LOSS_TOL,
            f"25b Layer vs functional loss: {vs_fn['loss']}")
    require(vs_fn["grads"] <= PARITY_TOL,
            f"25b Layer vs functional grads: {vs_fn['grads']}")
    require(fault > PARITY_TOL,
            f"25b: the planted fault passed the param check ({fault})")
    return models


def eager_serving(models, smi):
    """25c: greedy tokens of 4 prompts from the model forms —
    ``model.generate`` and ``create_engine(model)`` on the card — equal
    to the ``(state, config)`` forms on the card and to the CPU's."""
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.serving import GenerationConfig, create_engine
    card, cpu = models["cuda"], models["cpu"]
    cfg = card.config
    prompts = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int64)

    def engine_tokens(engine):
        reqs = [engine.submit(p.tolist(),
                              GenerationConfig(max_new_tokens=EAGER_NEW))
                for p in prompts]
        while engine.scheduler.has_work():
            engine.step()
        return [r.output_tokens for r in reqs]

    kw = dict(max_slots=4, page_size=64)
    out = {
        "generate_model": card.generate(prompts, max_new_tokens=EAGER_NEW),
        "generate_state": G.generate(card.functional_state(), cfg, prompts,
                                     max_new_tokens=EAGER_NEW),
        "generate_cpu": cpu.generate(prompts, max_new_tokens=EAGER_NEW),
    }
    out = {k: v.cpu().numpy()[:, prompts.shape[1]:].tolist()
           for k, v in out.items()}
    out["engine_model"] = engine_tokens(create_engine(card, **kw))
    out["engine_state"] = engine_tokens(create_engine(
        cfg, card.functional_state(), **kw))
    out["engine_cpu"] = engine_tokens(create_engine(cpu, **kw))
    # each form against the CPU's run of the same entry point
    same = {k: v == out[k.split("_")[0] + "_cpu"] for k, v in out.items()}
    emit({"phase": "25c", "card": smi, "prompts": len(prompts),
          "new_tokens": EAGER_NEW, "equal_to_cpu": same,
          "generate_equals_engine": out["generate_cpu"]
          == out["engine_cpu"]})
    require(all(same.values()), f"25c tokens differ: {same}")


def live_cuda_tensors(top=6):
    """The largest CUDA tensors alive (found by ``gc``) with the types of
    what holds them, two levels up: what earlier phases left on the
    card."""
    found = [o for o in gc.get_objects()
             if isinstance(o, torch.Tensor) and o.is_cuda]
    found.sort(key=lambda t: -t.numel() * t.element_size())
    out = []
    for t in found[:top]:
        holders = []
        for r in gc.get_referrers(t):
            if r is found:
                continue
            up = [type(u).__name__ for u in gc.get_referrers(r)
                  if u is not found][:3]
            holders.append(f"{type(r).__name__}<-{','.join(up)}")
        out.append([list(t.shape), str(t.dtype),
                    t.numel() * t.element_size(), holders[:3]])
    del found
    return out


def phase_eager(LlamaConfig, TH, FA, FM, smi):
    """Phase 25: the eager Paddle API on the card (see the module
    docstring).  Returns 25a's K1/K2 launches."""
    t0 = time.perf_counter()
    emit({"phase": 25, "allocated_at_start": torch.cuda.memory_allocated(),
          "largest_live": live_cuda_tensors()})
    cfg = tinyllama_config(LlamaConfig)
    plain, restore = count_plain_calls(FA, FM)
    try:
        launches = None
        try:
            launches = eager_train(cfg, TH, FA, plain, EAGER_BATCH, smi)
        except torch.cuda.OutOfMemoryError:
            pass            # retried below, once the failed frames are gone
        if launches is None:
            release()
            emit({"phase": "25a", "note": f"batch {EAGER_BATCH} x "
                  f"{EAGER_SEQ} without recompute exceeds the card's "
                  f"memory: both paths take batch {EAGER_BATCH // 2}"})
            launches = eager_train(cfg, TH, FA, plain, EAGER_BATCH // 2,
                                   smi)
    finally:
        restore()
    release()
    models = eager_parity(tinyllama_config(
        LlamaConfig, num_hidden_layers=2, dtype="float32"), TH, smi)
    release()
    eager_serving(models, smi)
    del models
    release()
    emit({"phase": 25, "wall_s": time.perf_counter() - t0})
    return launches


# ------------------------- phase 26: LeNet, ResNet50 and BERT-base trained
LENET_BATCH, LENET_WARMUP, LENET_STEPS = 64, 3, 30   # bench.py:528-585
RESNET_BATCH, RESNET_HW, RESNET_CHUNK = 128, 224, 10  # bench.py:174-226
RESNET_FLOPS_PER_IMAGE = 3 * 4.1e9   # the bench's count (bench.py:218-219)
BERT_BATCH, BERT_SEQ, BERT_CHUNK, BERT_CALLS = 32, 384, 10, 3  # :229-283
# 26d: f32, card vs the port on the CPU from the same weights
VISION_STEPS = 2
RESNET_PARITY_SHAPE = (2, 3, 64, 64)
BERT_PARITY_LAYERS, BERT_PARITY_SHAPE = 2, (2, 384)
# BERT's phase-3 record: BERT-base's attention (12 of 64, S 384, not
# causal) at 26c's batch
BERT_FLASH_SHAPE = ("bert_base", BERT_BATCH, 12, 12, BERT_SEQ, BERT_SEQ, 64)


def on_device(paddle, device):
    """A context that makes ``device`` the eager API's current one."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        prev = paddle.device._current
        paddle.set_device(device)
        try:
            yield
        finally:
            paddle.device._current = prev
    return ctx()


def vision_profile(fn, phase):
    """One call of ``fn`` under ``torch.profiler``: device ms by group
    (cuDNN convolutions, batch norms, K1/K2, other matmuls, elementwise
    and the rest), the top kernels and the idle share (1 - busy / wall)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name] = (per_kernel.get(ev.name, 0.0)
                                   + ev.time_range.elapsed_us() / 1e3)
    groups = dict.fromkeys(("conv", "batch_norm", "flash", "matmul",
                            "elementwise"), 0.0)
    for name, ms in per_kernel.items():
        low = name.lower()
        if "batch_norm" in low or "bn_fw" in low or "bn_bw" in low:
            key = "batch_norm"
        elif "flash_sm90::" in low or "flash_bwd_" in low \
                or "flash_fwd_" in low:
            key = "flash"
        elif any(m in low for m in ("conv", "implicit_gemm", "fprop",
                                    "dgrad", "wgrad", "cudnn")):
            key = "conv"
        elif any(m in low for m in ("gemm", "gemv", "cutlass", "xmma",
                                    "sm90", "cublas", "nvjet")):
            key = "matmul"
        else:
            key = "elementwise"
        groups[key] += ms
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    rec = {"phase": phase, "profile": "one step", "wall_ms": wall * 1e3,
           "device_ms": groups, "device_busy_ms": busy,
           "device_idle_share": 1 - busy / (wall * 1e3),
           "kernels_seen": len(per_kernel),
           "top_kernels_ms": [[n[:80], ms] for n, ms in top]}
    emit(rec)
    return rec


def phase_lenet(smi):
    """26a: ``bench_lenet`` on the card: 3 warm-up steps, then 30 eager
    steps and 30 ``train_step`` steps, each path from seed 0's LeNet."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import LeNet
    F = paddle.nn.functional
    rng = np.random.default_rng(0)
    x = paddle.to_tensor(rng.standard_normal(
        (LENET_BATCH, 1, 28, 28)).astype(np.float32))
    y = paddle.to_tensor(rng.integers(0, 10, (LENET_BATCH,)))

    def make():
        paddle.seed(0)
        m = LeNet()
        m.train()
        return m, paddle.optimizer.SGD(learning_rate=0.01,
                                       parameters=m.parameters())

    model, opt = make()

    def eager():
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    first = float(eager())
    for _ in range(LENET_WARMUP - 1):
        eager()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LENET_STEPS):
        loss = eager()
    eager_last = float(loss)
    eager_sps = LENET_STEPS / (time.perf_counter() - t0)
    model, opt = make()
    step = paddle.jit.train_step(model, opt,
                                 lambda m, a, b: F.cross_entropy(m(a), b))
    float(step(x, y))
    for _ in range(LENET_WARMUP):
        loss = step(x, y)
    float(loss)
    t0 = time.perf_counter()
    for _ in range(LENET_STEPS):
        loss = step(x, y)
    step_last = float(loss)
    step_sps = LENET_STEPS / (time.perf_counter() - t0)
    emit({"phase": "26a", "card": smi, "model": "LeNet",
          "batch": LENET_BATCH, "steps": LENET_STEPS,
          "eager_steps_per_s": eager_sps,
          "train_step_steps_per_s": step_sps,
          "eager_over_train_step": eager_sps / step_sps,
          "loss_first": first, "loss_eager_last": eager_last,
          "loss_train_step_last": step_last,
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})
    require(all(math.isfinite(v) for v in (first, eager_last, step_last)),
            "26a: a LeNet loss is not finite")
    require(eager_last < first and step_last < first,
            f"26a: LeNet's loss did not fall: {first} -> {eager_last} "
            f"(eager), {step_last} (train_step)")


def phase_resnet50(smi):
    """26b: ``bench_resnet50`` on the card: AMP O1 in bf16, Momentum(0.1,
    0.9), ``train_step(...).multi_step(10)``: a warm-up call, then the
    best of 2 timed calls; images/s, MFU by the bench's count, peak
    memory, the loss and a profile of one step."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet50
    F = paddle.nn.functional
    t0 = time.perf_counter()
    paddle.seed(0)
    model = resnet50(num_classes=1000)
    model.train()
    opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=model.parameters())

    def loss_fn(m, x, y):
        with paddle.amp.auto_cast(enable=True, level="O1"):
            out = m(x)
        return F.cross_entropy(out, y)

    train = paddle.jit.train_step(model, opt, loss_fn)
    many = train.multi_step(RESNET_CHUNK)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = paddle.Tensor(torch.randn(RESNET_BATCH, 3, RESNET_HW, RESNET_HW,
                                  device="cuda", generator=gen))
    y = paddle.Tensor(torch.randint(0, 1000, (RESNET_BATCH,), device="cuda",
                                    generator=gen))
    first = float(many(x, y))                       # warm-up: 10 steps
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    best = math.inf
    for _ in range(2):
        t0 = time.perf_counter()
        loss = float(many(x, y))
        best = min(best, time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    ips = RESNET_BATCH * RESNET_CHUNK / best
    mfu = ips * RESNET_FLOPS_PER_IMAGE / BF16_FLOPS_PER_S
    prof = vision_profile(lambda: train(x, y), "26b")
    emit({"phase": "26b", "card": smi, "model": "resnet50",
          "batch": RESNET_BATCH, "hw": RESNET_HW, "amp": "O1 bfloat16",
          "steps_per_call": RESNET_CHUNK, "best_call_s": best,
          "images_per_s": ips, "mfu": mfu, "peak_mem_bytes": peak,
          "setup_and_warmup_s": setup_s, "loss_after_warmup": first,
          "loss": loss, "s_per_step": best / RESNET_CHUNK,
          "profiled_step_device_idle_share": prof["device_idle_share"]})
    require(math.isfinite(loss), f"26b: ResNet50's loss {loss}")
    del model, opt, train, many, x, y
    release()


def phase_bert_base(FA, FM, smi):
    """26c: ``bench_bert`` on the card: ``BertConfig()`` at 32 x 384, AMP
    O1 in bf16, AdamW(3e-5), ``multi_step(10)``, 2 warm-up calls and 3
    timed ones; examples/s, MFU by the bench's count; 12 launches each of
    K1, K2 dq and K2 dk/dv a step and no call of an attention plain
    version.  Returns the launches of the timed calls."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.bert import BertConfig, \
        BertForSequenceClassification
    F = paddle.nn.functional
    cfg = BertConfig()
    paddle.seed(0)
    model = BertForSequenceClassification(cfg)
    model.train()
    opt = paddle.optimizer.AdamW(learning_rate=3e-5,
                                 parameters=model.parameters())

    def loss_fn(m, ids, y):
        with paddle.amp.auto_cast(enable=True, level="O1"):
            logits = m(ids)
        return F.cross_entropy(logits, y)

    train = paddle.jit.train_step(model, opt, loss_fn)
    many = train.multi_step(BERT_CHUNK)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = paddle.Tensor(torch.randint(0, cfg.vocab_size,
                                      (BERT_BATCH, BERT_SEQ), device="cuda",
                                      generator=gen))
    y = paddle.Tensor(torch.randint(0, cfg.num_labels, (BERT_BATCH,),
                                    device="cuda", generator=gen))
    first = float(many(ids, y))
    float(many(ids, y))
    n_params = sum(int(np.prod(p.shape)) for p in model.parameters())
    plain, restore = count_plain_calls(FA, FM)
    try:
        FA.flash_mha.fwd_launches = 0
        FA.flash_mha.dq_launches = 0
        FA.flash_mha.dkv_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BERT_CALLS):
            loss = many(ids, y)
        loss = float(loss)
        dt = time.perf_counter() - t0
        launches = {"flash_attention_fwd": FA.flash_mha.fwd_launches,
                    "flash_attention_bwd_dq": FA.flash_mha.dq_launches,
                    "flash_attention_bwd_dkv": FA.flash_mha.dkv_launches}
        plain_calls = dict(plain)
    finally:
        restore()
    steps = BERT_CALLS * BERT_CHUNK
    eps = BERT_BATCH * steps / dt
    flops_per_ex = 6 * n_params * BERT_SEQ + 12 * cfg.num_hidden_layers \
        * cfg.hidden_size * BERT_SEQ * BERT_SEQ       # bench.py:272-274
    mfu = eps * flops_per_ex / BF16_FLOPS_PER_S
    prof = vision_profile(lambda: train(ids, y), "26c")
    emit({"phase": "26c", "card": smi, "model": "BERT-base",
          "params": n_params, "batch": BERT_BATCH, "seq": BERT_SEQ,
          "amp": "O1 bfloat16", "steps": steps, "wall_s": dt,
          "examples_per_s": eps, "mfu": mfu, "loss_first_call": first,
          "loss": loss, "launches": launches,
          "launches_per_step": {k: n / steps for k, n in launches.items()},
          "plain_attention_calls": plain_calls,
          "profiled_step_device_idle_share": prof["device_idle_share"]})
    require(math.isfinite(loss), f"26c: BERT-base loss {loss}")
    want = {k: cfg.num_hidden_layers * steps for k in launches}
    require(launches == want, f"26c flash launches {launches} != {want}")
    require(not any(plain_calls.values()),
            f"26c: BERT-base called plain attention: {plain_calls}")
    del model, opt, train, many
    release()
    return launches


def vision_twins(paddle, build, seed=0):
    """``build()`` on the card (from ``seed``) and on the CPU, the CPU's
    loaded with the card's state dict."""
    from paddle_tpu_torch.models.convert import layer_state_from_numpy
    paddle.seed(seed)
    card = build()
    with on_device(paddle, "cpu"):
        cpu = build()
    layer_state_from_numpy(cpu, {k: v.numpy() for k, v
                                 in card.state_dict().items()})
    return card, cpu


def vision_run(paddle, model, device, batch, out_loss, make_opt,
               dtype="float32"):
    """One eager forward and backward (output, loss, grads), then
    ``VISION_STEPS`` ``train_step`` steps; returns those and the state
    dict after them, as float64 CPU tensors.  Float inputs take
    ``dtype``."""
    def cpu64(t):
        return t.detach().double().cpu()

    with on_device(paddle, device):
        xs = [paddle.to_tensor(b, dtype=dtype if b.dtype.kind == "f"
                               else None) for b in batch]
        out, loss = out_loss(model, *xs)
        loss.backward()
        grads = {n: cpu64(p._grad_data()) for n, p
                 in model.named_parameters() if p._grad_data() is not None}
        model.clear_gradients()
        step = paddle.jit.train_step(model, make_opt(model),
                                     lambda m, *b: out_loss(m, *b)[1])
        for _ in range(VISION_STEPS):
            step(*xs)
        state = {k: cpu64(v._data) for k, v in model.state_dict().items()}
    return cpu64(out._data), cpu64(loss._data), grads, state


def vision_errs(card, cpu, f64=None, noise=None):
    """Card vs CPU, by relative norm: the output, the loss, the grads and
    the state (params and BatchNorm buffers).  Without ``f64``, each leaf
    is held within the limit: a leaf whose gradient is rounding noise (an
    attention key bias's) against 1e-4 of the whole gradient's norm, and
    ``noise`` (key suffix -> bound) holds such params by their largest
    absolute difference.  With ``f64`` (the CPU's run in float64), each
    of the four is held whole (all its leaves as one vector): within the
    limit, or no farther from float64 than twice the CPU's own distance
    from it, plus the limit.  ResNet50's f32 gradients lie 1.5-2.7 %
    from float64 on the CPU alone (batch 2-32, 64-128 px), leaf by leaf
    and whole, so no two f32 runs hold 1e-4 there, and the Momentum
    steps carry that into the params.  Returns (errors, failures)."""
    (go, gl, gg, gs), (co, cl, cg, cs) = card, cpu
    require(sorted(gg) == sorted(cg), "26d: card and CPU grads of "
            f"different params: {sorted(set(gg) ^ set(cg))}")
    whole = math.sqrt(sum(float(g.square().sum()) for g in cg.values()))
    fails, errs, loose = [], {}, {}

    def rel(a, b, floor=0.0):
        return float((a - b).norm()) / max(float(b.norm()), floor, 1e-300)

    def flat(d, keys):
        return torch.cat([d[k].reshape(-1) for k in keys])

    states = [k for k in cs
              if not any(k.endswith(s_) for s_ in noise or {})]
    parts = {"output": (go, co, f64 and f64[0]),
             "loss": (gl.reshape(1), cl.reshape(1),
                      f64 and f64[1].reshape(1)),
             "grads": (flat(gg, cg), flat(cg, cg), f64 and flat(f64[2], cg)),
             "state": (flat(gs, states), flat(cs, states),
                       f64 and flat(f64[3], states))}
    for kind, (a, b, ref64) in parts.items():
        errs[kind] = rel(a, b)
        if f64 is None:
            continue
        mine, cpus = rel(a, ref64), rel(b, ref64)
        errs[kind + "_vs_float64"] = [mine, cpus]
        if errs[kind] > PARITY_TOL and mine > 2 * cpus + PARITY_TOL:
            fails.append((kind, "whole", mine, cpus))
    errs["worst_grad_leaf"] = max(rel(gg[n], cg[n], 1e-4 * whole)
                                  for n in cg)
    errs["worst_state_leaf"] = max(rel(gs[k], cs[k]) for k in states)
    for k in cs:
        bound_ = next((b for s_, b in (noise or {}).items()
                       if k.endswith(s_)), None)
        if bound_ is not None:
            loose[k] = float((gs[k] - cs[k]).abs().max())
            if loose[k] > bound_:
                fails.append(("state", k, loose[k], bound_))
    errs["noise_leaves_max_abs"] = max(loose.values(), default=0.0)
    if f64 is None:
        for kind in ("output", "loss"):
            if errs[kind] > PARITY_TOL:
                fails.append((kind, kind, errs[kind]))
        for kind in ("grad", "state"):
            if errs[f"worst_{kind}_leaf"] > PARITY_TOL:
                fails.append((kind, "worst leaf",
                              errs[f"worst_{kind}_leaf"]))
    return errs, fails


def vision_parity(smi):
    """26d: f32, the card against the port on the CPU on the same
    weights: output, loss and every grad of one eager step, then params
    and BatchNorm buffers after 2 ``train_step`` steps, within 1e-4
    relative, for LeNet (batch 64), the whole ResNet50 (2 x 3 x 64 x 64,
    held whole against the CPU's float64 run: ``vision_errs``) and
    BERT at base width with 2 layers (2 x 384: the f32 K1/K2 at d 64, not
    causal).  TF32 is off for matmuls and cuDNN (cuDNN's is on by
    default) and put back after.  A planted fault, BatchNorm stepped
    with torch's momentum number (0.1) in place of Paddle's (0.9), must
    fail the check."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.bert import BertConfig, \
        BertForSequenceClassification
    from paddle_tpu_torch.vision.models import LeNet, resnet50
    F = paddle.nn.functional
    rng = np.random.default_rng(5)

    def ce(m, x, y):
        out = m(x)
        return out, F.cross_entropy(out, y)

    def sgd(m):
        return paddle.optimizer.SGD(learning_rate=0.01,
                                    parameters=m.parameters())

    def momentum(m):
        return paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                         parameters=m.parameters())

    bert_lr = 3e-5

    def adamw(m):
        return paddle.optimizer.AdamW(learning_rate=bert_lr,
                                      parameters=m.parameters())

    bert_cfg = BertConfig(num_hidden_layers=BERT_PARITY_LAYERS)
    cases = {
        "lenet": (LeNet, [rng.standard_normal((LENET_BATCH, 1, 28, 28))
                          .astype(np.float32),
                          rng.integers(0, 10, (LENET_BATCH,))], sgd, None),
        "resnet50": (lambda: resnet50(num_classes=1000),
                     [rng.standard_normal(RESNET_PARITY_SHAPE)
                      .astype(np.float32),
                      rng.integers(0, 1000, (RESNET_PARITY_SHAPE[0],))],
                     momentum, None),
        "bert": (lambda: BertForSequenceClassification(bert_cfg),
                 [rng.integers(0, bert_cfg.vocab_size, BERT_PARITY_SHAPE),
                  rng.integers(0, 2, (BERT_PARITY_SHAPE[0],))], adamw,
                 {"attention.key.bias": 2 * VISION_STEPS * bert_lr}),
    }
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name, (build, batch, make_opt, noise) in cases.items():
            t0 = time.perf_counter()
            card, cpu = vision_twins(paddle, build)
            f64 = fault = None
            if name == "resnet50":
                fault, cpu64 = vision_twins(paddle, build)
                for layer in fault.sublayers():
                    if hasattr(layer, "_momentum"):
                        layer._momentum = 0.1
                cpu64.to(device="cpu", dtype="float64")
                cpu64.train()
                f64 = vision_run(paddle, cpu64, "cpu", batch, ce, make_opt,
                                 dtype="float64")
                del cpu64
            for m in (card, cpu):
                m.train()
            runs = {dev: vision_run(paddle, m, dev, batch, ce, make_opt)
                    for dev, m in (("gpu", card), ("cpu", cpu))}
            errs, fails = vision_errs(runs["gpu"], runs["cpu"], f64, noise)
            rec = {"phase": "26d", "card": smi, "model": name,
                   "dtype": "float32", "steps": VISION_STEPS,
                   "card_vs_cpu": errs, "tol": PARITY_TOL,
                   "failed": fails[:5], "wall_s": time.perf_counter() - t0}
            if fault is not None:
                fault.train()
                f_run = vision_run(paddle, fault, "gpu", batch, ce, make_opt)
                f_errs, f_fails = vision_errs(f_run, runs["cpu"], f64)
                rec["fault_state"] = f_errs["state"]
                rec["fault_failed"] = len(f_fails)
            emit(rec)
            require(not fails, f"26d {name} card vs CPU: {fails[:5]}")
            if fault is not None:
                require(any(f[0] == "state" for f in f_fails),
                        "26d: BatchNorm at torch's momentum passed the "
                        f"state check ({rec['fault_state']})")
            out[name] = errs
            del card, cpu, fault, runs, f64
            release()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return out


def phase_vision(FA, FM, smi):
    """Phase 26: the bench's LeNet, ResNet50 and BERT rungs through the
    public API, then their f32 parity.  Returns 26c's K1/K2 launches."""
    t0 = time.perf_counter()
    phase_lenet(smi)
    release()
    phase_resnet50(smi)
    launches = phase_bert_base(FA, FM, smi)
    vision_parity(smi)
    emit({"phase": 26, "wall_s": time.perf_counter() - t0})
    return launches


def main_expert_sep() -> int:
    """``python3 chip_smoke.py expert-sep``: phase 24, on a machine with
    four cards."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the "
              "card", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops import cuda_lib
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    require(torch.cuda.device_count() >= 4,
            f"phase 24 needs 4 cards, found {torch.cuda.device_count()}")
    # a hung collective must not hold the cards: past EP_WALL_S (the
    # build included) the run ends with an error
    guard = threading.Timer(EP_WALL_S, lambda: (print(
        f"chip_smoke: expert-sep passed {EP_WALL_S} s; stopping",
        file=sys.stderr, flush=True), os._exit(3)))
    guard.daemon = True
    guard.start()
    laps = Laps()
    emit({"phase": 2, "build_s": cuda_lib.build()})
    laps(2)
    phase_expert_sep(smi[0])
    laps(24)
    guard.cancel()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main_serving_tp() -> int:
    """``python3 chip_smoke.py serving-tp``: phase 23, on a machine with
    four cards."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the "
              "card", file=sys.stderr)
        return 1
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.models import init_state, llama3_8b
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.pallas import flash_mask as FM
    from paddle_tpu_torch.ops.pallas import lora_matmul as LM
    from paddle_tpu_torch.ops.pallas import paged_attention as PA
    from paddle_tpu_torch.ops.pallas import quant_matmul as QM
    from paddle_tpu_torch.serving import (AdapterStore, GenerationConfig,
                                          RequestState, create_engine,
                                          random_adapter)
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.serving.parallel import worker as W
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    require(torch.cuda.device_count() >= 4,
            f"phase 23 needs 4 cards, found {torch.cuda.device_count()}")
    # a hung collective must not hold the cards: past TP_WALL_S the run
    # ends with an error (the workers exit once this process is gone)
    guard = threading.Timer(TP_WALL_S, lambda: (print(
        f"chip_smoke: serving-tp passed {TP_WALL_S} s; stopping",
        file=sys.stderr, flush=True), os._exit(3)))
    guard.daemon = True
    guard.start()
    laps = Laps()
    emit({"phase": 2, "build_s": cuda_lib.build()})
    laps(2)
    mods = (QM, LM, PA, FM, G, W, obs, create_engine, init_state,
            GenerationConfig, AdapterStore, random_adapter, RequestState)
    try:
        phase_serving_tp_parity(llama3_8b(), mods, smi[0])
        laps("23a")
        phase_serving_tp_bench(llama3_8b(), mods, smi[0])
        laps("23b")
        phase_serving_tp_kill(smi[0])
        laps("23c")
    finally:
        W.shutdown_meshes()
    guard.cancel()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main_hybrid_ranks() -> int:
    """``python3 chip_smoke.py hybrid-ranks``: phase 22b alone, on a
    machine with four cards."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the "
              "card", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops import cuda_lib
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    require(torch.cuda.device_count() >= 4,
            f"phase 22b needs 4 cards, found {torch.cuda.device_count()}")
    laps = Laps()
    emit({"phase": 2, "build_s": cuda_lib.build()})
    laps(2)
    phase_hybrid_ranks(smi[0])
    laps("22b")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    if sys.argv[1:] == ["hybrid-ranks"]:
        return main_hybrid_ranks()
    if sys.argv[1:] == ["serving-tp"]:
        return main_serving_tp()
    if sys.argv[1:] == ["expert-sep"]:
        return main_expert_sep()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the "
              "card", file=sys.stderr)
        return 1
    from paddle_tpu_torch.models import (GenerationConfig, LlamaConfig,
                                         init_state, llama3_8b)
    from paddle_tpu_torch.distributed import moe as TM
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.models import llama_hybrid as TH
    from paddle_tpu_torch.models import moe_llm as M
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.pallas import decode_attention as DA
    from paddle_tpu_torch.ops.pallas import flash_attention as FA
    from paddle_tpu_torch.ops.pallas import flash_mask as FM
    from paddle_tpu_torch.ops.pallas import grouped_ffn as GF
    from paddle_tpu_torch.ops.pallas import lora_matmul as LM
    from paddle_tpu_torch.ops.pallas import paged_attention as PA
    from paddle_tpu_torch.ops.pallas import quant_matmul as QM
    from paddle_tpu_torch.ops.pallas import rms_norm as RN
    from paddle_tpu_torch import distributed as DIST
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import (AdapterStore, EngineSupervisor,
                                          FaultPlan, RequestState, Router,
                                          ServingClient, ServingHTTPError,
                                          create_engine, quantize_state,
                                          random_adapter, serve)
    from paddle_tpu_torch.serving.server import _usage_json

    laps = Laps()
    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0),
            f"need compute capability 9.0 (Hopper), got {cap}")
    emit({"phase": 1, "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "capability": list(cap)})
    laps(1)

    # phase 2: build
    build_s = cuda_lib.build()
    emit({"phase": 2, "build_s": build_s, "ptxas": {
        name: [line.strip() for line in log.splitlines()
               if "registers" in line or "spill" in line]
        for name, log in cuda_lib.build_log.items()}})
    emit({"phase": 2, "spill_store_bytes": {
        src: spill_bytes(cuda_lib.build_log[src], marks)
        for src, marks in NEW_INSTANCES.items()}})
    laps(2)

    # phase 3: kernels vs plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    pageds = [phase_paged(PA, gen, *shape) for shape in PAGED_SHAPES]
    paged = pageds[0]       # phase 4's decode shape: the kernels line's
    verify = phase_paged_verify(PA, DA, gen)    # phase 17's verify step
    for shape in PAGED_SHAPES:
        phase_paged_f32(PA, *shape)
    release()
    masked = [phase_masked(FM, gen, *shape) for shape in MASKED_SHAPES]
    release()
    phase_window(FA, FM, gen, *WINDOW_SHAPE)
    release()
    flash = [phase_flash(FA, gen, *shape) for shape in FLASH_SHAPES]
    bert_flash = phase_flash(FA, gen, *BERT_FLASH_SHAPE, causal=False)
    k8 = [phase_k8(FM, gen, *shape) for shape in K8_SHAPES]
    release()
    for name, B, H, kvh, _, causal, kind, D in K8_SHAPES:
        phase_k8_f32(FM, name, B, H, kvh, causal, kind, D)
    for D in NEW_HEAD_DIMS:
        phase_flash_f32(FA, D)
    release()
    quant = phase_quant(QM, gen)
    lora = phase_lora(LM, gen)
    release()
    decode = [phase_decode(DA, gen, *shape) for shape in K7_SHAPES]
    for shape in K7_SHAPES:
        phase_decode_f32(DA, *shape)
    release()
    phase_dbias_long(FM, gen)
    release()
    route_launches = phase_routes(FA, FM, DA, PA, G, init_state,
                                  create_engine, GenerationConfig)
    release()
    k9 = [phase_k9(GF, TM, gen, *shape) for shape in K9_SHAPES]
    release()
    phase_k9_f32(GF, TM)
    k6 = phase_k6(RN, gen)
    release()
    laps(3)

    # phase 4: the main path at full width and depth
    launches, serve4 = phase_serve(llama3_8b(), PA, FM, create_engine,
                                   init_state, GenerationConfig)
    release()
    laps(4)

    # phase 5: end-to-end parity, card vs CPU
    phase_parity(llama3_8b(), create_engine, init_state, GenerationConfig)
    release()
    laps(5)

    # phase 6: the training path at full width and depth
    launches.update(phase_train(bench_config(LlamaConfig), TH, FA))
    release()
    laps(6)

    # phase 7: training parity, card vs CPU
    phase_train_parity(bench_config(LlamaConfig, num_hidden_layers=2,
                                    dtype="float32"), TH)
    release()
    laps(7)

    # phase 8: the quantized and multi-LoRA serving modes, full depth
    mods = (QM, LM, PA, FM, create_engine, init_state, GenerationConfig,
            AdapterStore, random_adapter)
    modes = {"8a": phase_modes(llama3_8b(), mods, "8a int8+lora", "int8",
                               False, True)}
    release()
    modes["8b"] = phase_modes(llama3_8b(), mods, "8b int4+kv_quant", "int4",
                              True, False)
    release()
    laps(8)

    # phase 9: both modes, card vs CPU
    phase_modes_parity(llama3_8b(), create_engine, init_state,
                       GenerationConfig, AdapterStore, random_adapter,
                       quantize_state)
    release()
    laps(9)

    # phase 10: the reference bench's long-context rung
    phase_train(bench_config(LlamaConfig,
                             max_position_embeddings=LONGCTX_SEQ), TH, FA,
                batch=1, seq=LONGCTX_SEQ, steps=LONGCTX_STEPS, phase="10a")
    release()
    qkv, k8_launches = phase_longctx_masked(FA, FM)
    release()
    for counts in (phase_longctx_window(FA, FM, qkv),
                   phase_longctx_bias(FA, FM, qkv)):
        k8_launches = {k: k8_launches[k] + counts[k] for k in counts}
    del qkv
    release()
    laps(10)

    # phase 11: the reference bench's decode rungs through generate
    gmods = {"G": G, "DA": DA, "PA": PA, "FM": FM, "QM": QM, "LM": LM,
             "init_state": init_state}
    decode_cfg = bench_config(LlamaConfig, max_position_embeddings=4096)
    decode_launches = phase_bench_decode(gmods, decode_cfg)
    release()
    laps("11a")
    phase_bench_paged(gmods, decode_cfg)
    release()
    laps("11b")
    phase_long_decode(gmods, llama3_8b())
    release()
    laps("11c")

    # phase 12: generation parity, card vs CPU, and sampling on the card
    phase_generate_parity(gmods, llama3_8b())
    release()
    laps(12)

    # phase 13: the reference bench's MoE rung through moe_llm (13a), one
    # MoE layer in the three dispatch modes (13b), fused_rms_norm (13c)
    phase_moe_train(M, FA, GF, RN)
    release()
    laps("13a")
    zero_moe_counts(FA, GF, RN)
    for shape in MOE_LAYER_SHAPES:
        phase_moe_layer(TM, GF, gen, *shape)
        release()
    k9_launches = {"grouped_ffn_fwd": GF.grouped_ffn.fwd_launches,
                   "grouped_ffn_bwd": GF.grouped_ffn.bwd_launches}
    laps("13b")
    zero_moe_counts(FA, GF, RN)
    phase_fused_rms_norm(RN)
    k6_launches = RN.rms_norm.launches
    release()
    laps("13c")

    # phase 14: MoE training and the grouped dispatch, card vs CPU
    phase_moe_parity(M, TM)
    release()
    laps(14)

    # phase 15: TinyLlama-1.1B training (head_dim 64: K1/K2 at d 64), no
    # plain attention on the way; then its f32 step, card vs CPU
    plain, restore = count_plain_calls(FA, FM)
    try:
        tiny_train = phase_train(tinyllama_config(LlamaConfig), TH, FA,
                                 phase=15, plain=plain)
    finally:
        restore()
    release()
    phase_train_parity(tinyllama_config(LlamaConfig, num_hidden_layers=2,
                                        dtype="float32"), TH, phase=15)
    release()
    laps(15)

    # phase 16: TinyLlama-1.1B served (prefill: the K8 forward at d 64;
    # decode: K3 at d 64), phase 4's traffic; then its greedy tokens at
    # 2 layers, f32, card vs CPU
    tiny_serve, _ = phase_serve(tinyllama_config(LlamaConfig), PA, FM,
                                create_engine, init_state, GenerationConfig,
                                phase=16)
    release()
    phase_parity(tinyllama_config(LlamaConfig), create_engine, init_state,
                 GenerationConfig, phase=16)
    release()
    laps(16)

    # phase 25 (run here, beside TinyLlama's phases 15-16, before the
    # llama3_8b phases 17-22): the eager Paddle API, TinyLlama-1.1B as an
    # nn.Layer trained by the port's AdamW (K1/K2 at d 64 through the
    # registry's flash_attention op), its f32 parity, serving from it
    eager = phase_eager(LlamaConfig, TH, FA, FM, smi)
    tiny_train = {k: tiny_train[k] + eager[k] for k in tiny_train}
    release()
    laps(25)

    # phase 26 (after 25, before 17): the bench's LeNet, ResNet50 and
    # BERT rungs through jit.train_step (BERT-base: K1/K2 at d 64, not
    # causal), then their f32 parity, card vs CPU
    bert_train = phase_vision(FA, FM, smi)
    release()
    laps(26)

    # phases 17-18: the serving engine's speculative decoding and
    # preemption at llama3_8b full width and depth, on one state
    gen8b = torch.Generator(device="cuda").manual_seed(0)
    state8b = init_state(llama3_8b(), gen8b, device="cuda")
    spec_launches = phase_spec(llama3_8b(), state8b, PA, FM, create_engine,
                               GenerationConfig, RequestState)
    laps(17)
    phase_preempt(llama3_8b(), state8b, create_engine, GenerationConfig,
                  RequestState, PA, FM)
    release()
    laps(18)

    # phase 19: both, and a recovered poisoned step, card vs CPU in f32
    phase_serving_parity(llama3_8b(), create_engine, init_state,
                         GenerationConfig, EngineSupervisor, FaultPlan,
                         RequestState, G)
    release()
    laps(19)

    # phase 20: llama3_8b served over HTTP (phases 17-18's state)
    http_launches = phase_http(llama3_8b(), state8b, PA, FA, FM, serve,
                               ServingClient, ServingHTTPError, obs,
                               GenerationConfig, smi, serve4)
    del state8b
    release()
    laps(20)

    # phase 21: the HTTP path and the router in float32, card vs CPU
    phase_http_parity(llama3_8b(), serve, create_engine, init_state,
                      GenerationConfig, AdapterStore, random_adapter,
                      Router, ServingClient, _usage_json, smi)
    release()
    laps(21)

    # phase 22: hybrid-parallel training through torch.distributed: one
    # NCCL rank (22a); four, one per card, where the machine has them
    hybrid = phase_hybrid(llama3_8b(), TH, FA, FM, DIST, smi)
    for k, n in hybrid.items():
        launches[k] += n
    release()
    laps("22a")
    if torch.cuda.device_count() >= 4:
        phase_hybrid_ranks(smi)
        laps("22b")
    else:
        emit({"phase": "22b", "ran": "one-rank part only",
              "cards": torch.cuda.device_count()})
    emit({"phase": 24, "ran": False, "cards": torch.cuda.device_count(),
          "why": "expert and context parallelism take four cards: "
                 "python3 chip_smoke.py expert-sep"})


    rep = masked[1]     # the 2048 bucket: the longest prompts of phase 4
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": "paged_attention", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/pallas/paged_attention.py:123",
         # phase 4's decode steps, phase 17's decode and verify steps
         # and phase 20's decode steps over HTTP
         "launches": (launches["paged_attention"]
                      + spec_launches["paged_attention"]
                      + http_launches["paged_attention"]),
         "max_abs_err": max(p["max_abs_err"] for p in pageds + [verify]),
         "max_row_rel_err": max(p["max_row_rel_err"]
                                for p in pageds + [verify]),
         "shapes": [p["shape"] for p in pageds + [verify]],
         "verify": {k: verify[k] for k in keys + ("k7_same_keys_ms",)},
         **{k: paged[k] for k in keys}},
        # the CUDA-core body: d 72's times, launches from phase 3's
        # head_dim-8 engine (the reference's tensor-parallel test model)
        {"name": "paged_attention_any_head_dim", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/pallas/paged_attention.py:123",
         "launches": route_launches["paged_any"],
         "max_abs_err": max(p["max_abs_err"] for p in pageds
                            if p["shape"] in PAGED_ANY_SHAPES),
         "max_row_rel_err": max(p["max_row_rel_err"] for p in pageds
                                if p["shape"] in PAGED_ANY_SHAPES),
         "shapes": list(PAGED_ANY_SHAPES),
         "d8": {k: next(p for p in pageds if p["shape"] == "d8")[k]
                for k in keys},
         **{k: next(p for p in pageds if p["shape"] == "d72")[k]
            for k in keys}},
        {"name": "flash_mha_masked", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_sm90.cuh",
         "replaces": "paddle_tpu/ops/pallas/flash_mask.py:193",
         # phase 4's full prefills and phase 20's over HTTP
         "launches": (launches["flash_mha_masked"]
                      + http_launches["flash_mha_masked"]),
         "max_abs_err": max(m["max_abs_err"] for m in masked),
         "max_row_rel_err": max(m["max_row_rel_err"] for m in masked),
         **{k: rep[k] for k in keys}},
        *flash_entries(flash, launches),
        gemv_entry("weight_only_matmul_int8", "paddle_tpu_torch/csrc/"
                   "quant_matmul.cu", "paddle_tpu/ops/pallas/"
                   "quant_matmul.py:144", [q for q in quant
                                           if q["kernel"].endswith("int8")],
                   modes["8a"]["weight_only_matmul_int8"],
                   next(q for q in quant if q["kernel"].endswith("int8")
                        and q["shape"] == "gate/up" and q["M"] == 8)),
        gemv_entry("weight_only_matmul_int4", "paddle_tpu_torch/csrc/"
                   "quant_matmul.cu", "paddle_tpu/ops/pallas/"
                   "quant_matmul.py:163", [q for q in quant
                                           if q["kernel"].endswith("int4")],
                   modes["8b"]["weight_only_matmul_int4"],
                   next(q for q in quant if q["kernel"].endswith("int4")
                        and q["shape"] == "gate/up" and q["M"] == 8)),
        gemv_entry("lora_gather_matmul", "paddle_tpu_torch/csrc/"
                   "lora_matmul.cu", "paddle_tpu/ops/pallas/"
                   "lora_matmul.py:65", lora,
                   modes["8a"]["lora_gather_matmul"],
                   next(r for r in lora if r["shape"] == "gate/up")),
        *k8_entries(k8, k8_launches),
        *head_dim_entries(flash, k8, masked, route_launches, tiny_train,
                          tiny_serve),
        *bert_flash_entries(bert_flash, bert_train),
        decode_entry(decode, decode_launches["decode_attention"]),
        *k9_entries(k9, k9_launches),
        {"name": "rms_norm", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/rms_norm.cu",
         "replaces": "paddle_tpu/ops/pallas/rms_norm.py:24",
         "launches": k6_launches, "shape": k6["shape"],
         "max_abs_err": k6["max_abs_err"],
         "max_row_rel_err": k6["max_row_rel_err"],
         **{k: k6[k] for k in keys}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
