#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --profile  # + profiled decode steps and prefills

Phases, each of which must pass:

1. Build: compile every CUDA kernel of the port from ``csrc/`` (one
   nvcc per source, all at once) and print the build time and ptxas
   resource lines; for K3's tensor-core variant
   (``flash_attention_sm90.cu``) also its registers, dynamic shared
   memory and spills at hd = vd = 128, for K1 those of its bf16
   split kernel (the MHA models' ``<bf16, 1, 256>`` and the MLA
   latent's wide ``<bf16, 16, 512>``) and its combine kernel, for K4
   those of every
   ``selective_scan_kernel`` instantiation (the served one: bf16 x,
   n = 16), for K2 those of both forms of ``mux_score_kernel``, and for
   K3's backward (``flash_attention_bwd.cu``) those of its D, dk / dv
   and dq kernels in bf16 and fp32; none may spill.
2. Kernels against their plain PyTorch versions on the card: K1
   ``paged_attention`` over float32 / bf16 / int8 pages, GQA groups
   g in {1, 2, 4, 8}, full / window / chunk / logit-cap / v_dim
   variants, mixed lengths with a length-0 row, long rows at page 64
   (lengths 0-2048, windows of 50 and 1000 and a chunk of 300 whose
   edges fall inside splits) and a shape served in one split; the
   combined (B, M+1) operand against separate operands and a second
   call against the first (both bitwise), then at the served shapes;
   and its absorbed-latent (MLA) form at minicpm3-4b's decode shape
   (B = 8, H = 40 over one latent head, hd 288, V the leading 256
   features of the same bf16 pages of 64, phase 3's mix of lengths
   17-1024 with a length-0 row; and one 2048-token row): within 2e-2,
   both bitwise checks, and a CUDA graph's replay bitwise equal to the
   eager call;
   K2 ``mux_score`` in its head form (the probe's mean pool, out
   projection and tanh fused before Eq. 5-6, against ``mux_head_ref``)
   at the served probe shape (B=1, S=64, d=128, M=32, N=2), the sweep
   (B, S, d, M, N) = (3, 1, 32, 8, 2), (5, 17, 96, 24, 6), (2, 64, 128,
   32, 16), d = 30 (4-byte loads), M = 72 and N = 40 (lanes loop), d =
   4096 (132 KB of shared memory) and h off 16-byte alignment, and in
   its meta form (the TPU kernel's contract) at the reference sweep
   shapes and the image mux's served shapes (B = 1 and 256, M = 64,
   N = 6, ``normalize=False``), each twice, bitwise; then the probe's and select's CUDA
   graphs against the eager functions they capture at (B, S) = (1, 64),
   (1, 17), (3, 64) (weights and assignments bitwise equal, or weights
   within 1e-6 with the reason logged; K2's launches as its wrapper
   counted them: a capture tallies one, which each replay adds);
   K3 ``flash_attention`` on the JAX sweep's
   five shapes, GQA g in {1, 2, 4, 8} with S and T off the tiles, hd
   256, hd < vd, windows and chunks with fully masked rows in the
   first live tile, a block with an odd key-tile count (the 2-stage K/V
   ring wraps an odd number of times), one visible key per row (window
   1: the output must be that key's V row exactly) and two shapes
   without the causal rule, each in fp32 (the SIMT variant) and bf16
   (the tensor-core variant), and the served prefill shapes (B=1, S=T
   in {128, 448, 1024}, H=K in {16, 32}, hd 128, bf16) and
   minicpm3-4b's expanded MLA prefill (B=1, S=T in {128, 448, 1024},
   H=K=40, hd 96, vd 64, bf16); K4
   ``selective_scan`` on the JAX sweep's three shapes, S and d_in off
   every tile, n in {1, 4, 5, 8, 12, 16, 64}, d_in that defeat 16-byte
   copies, S = 0, 1 and 3, 4096 steps (each with fp32 and bf16 x),
   zero and random start states h0, h0 chaining (two halves, the
   second from the first's h_final, equal one scan of the whole), two
   calls bitwise equal, and the served shapes (B=2 and B=1, S=1024,
   d_in=8192, n=16, bf16 x).  TF32 is
   switched off for the plain versions
   (``torch.backends.cuda.matmul.allow_tf32 = False``,
   ``torch.backends.cudnn.allow_tf32 = False``), so they run in full
   fp32.  Tolerances: 2e-2 with bf16 operands or outputs, 1e-4 for
   fp32 paged and flash attention, 1e-5 for the fp32 mux head, 2e-5
   absolute plus 2e-5 relative for K4 (its arithmetic is fp32 whatever
   x's dtype).  Each
   kernel is timed at the served shape (CUDA events; input copies
   rotated so the 50 MB L2 never holds the next call's operands)
   beside its plain version and its bound; K1 at both served decode
   shapes and one 2048-token row, and its MLA form at B = 8 and at one
   2048-token row (its bound from bytes and from bf16 FLOPs, and the
   fp32 CUDA-core time of those FLOPs beside it), also as a CUDA graph
   and with the wrapper's host microseconds a call; K3 at every served
   prefill shape (the MLA ones too), each beside
   ``scaled_dot_product_attention`` (timed only,
   never on the port's path; both also timed as CUDA graphs, an extra
   column), with the wrapper's host microseconds per call for each
   variant, and its SIMT variant on fp32 copies at the largest shape;
   K4 at B=2 and B=1, eager and as CUDA graphs, with host microseconds
   a call; K2's head form at the served probe shape eager, as a CUDA
   graph and in host microseconds a call, beside the same composed
   plain ops eager and as a graph, and its meta form.
   K1 and K3 at gemma2-27b's shapes (g = 2, logit cap 50, query scale
   144^-1/2): K1 at B = 8, H = 32 over K = 16, hd 128, bf16 pages of
   64, 128 pages a row, window 4096, rows 17-5100 long (three past the
   window), against its plain version (2e-2, per element and per
   output vector), both bitwise checks, a CUDA graph's replay bitwise
   equal to the eager call, the 5100-token row changed by the window;
   K3 at B = 1, S = T = 5120 (a 5100-token prompt padded to page 64),
   H = 32 over K = 16, with the window and without, against its plain
   version (2e-2, per element and per output vector), the rows past
   4096 changed by the window; both again on q scaled 16x, where the
   cap binds, against their plain versions per output vector and
   changed by the cap; both timed eager and as CUDA graphs beside
   their bounds (the visible tokens / pairs) and their plain versions,
   K3 also beside torch's ``flex_attention`` (compiled; a softcap
   ``score_mod``, a causal / sliding-window block mask, grouped heads;
   timed only, its output held to the plain version first); K1 has no
   library call (none pages K/V through block tables).
   A tiny fp32 model's prefill (through K3's SIMT variant) and
   teacher-forced decode (through K1) on the card are held against the
   same model on the CPU (its swa layer's windowed launches counted),
   and so are a tiny fp32 MLA model's at
   minicpm3-4b's attention widths (K1's latent form, fp32 pages, five
   head tiles), a tiny fp32 olmoe-shaped MoE model's (qk-norm, 4
   experts top-2: its 8-token prefill drops assignments at capacity,
   decode is dropless) and a tiny fp32 falcon-mamba's
   ``prefill`` (through K4) and teacher-forced ring decode.
3. The direct served path at full width: olmo-1b and codeqwen1.5-7b at
   their published configs (depth uncut) with random bf16 weights
   from a seeded ``torch.Generator``, bf16 page pools (page 64; 512
   and 256 pages), ``max_len`` 2048, decode batch 8, behind a
   token-probe mux (d_model 128, 2 layers, meta_dim 32, vocab 50304,
   cost = 2 x params) whose threshold is set from the probe weights so
   both models get traffic.  8 prompts of 128-1024 tokens (two share a
   256-token prefix) go through ``MuxServer.probe`` ->
   ``prefill_into_pages`` in the selected engine ->
   ``decode_step_batch`` until each has 32 tokens.  Checks: each pool
   drains to zero pages, ``paged_attention`` launched num_layers x
   decode steps times on each engine, ``flash_attention`` num_layers x
   whole-prompt prefills, every one of them on the tensor-core variant
   (the per-variant counts; likewise in phases 4-6), ``mux_score``
   once per probe.  The server's probe and select graphs are captured
   once at B=1, S=64 before the run, so every probe of phases 3-5 is a
   replay of each.  Before the run, the server's probe also captures
   three new shapes (S = 23, 40, 57) while another thread runs
   whole-prompt prefills on olmo-1b: the graphed probes against the
   eager ones, and every racing prefill against the same prefill run
   alone.  Every paged decode step of phases 3-5 replays one of the
   engine's two CUDA graphs (the plain step and the one with the fused
   copy-on-write), captured when the pools are made, before any
   request (their capture seconds are printed).  Before the run, on
   each engine: each capture must tally one ``paged_attention`` launch
   a layer; requests A, B (A's prompt, 333 tokens, so B maps A's partly
   filled boundary page) and C decode 6 tokens in one batch of 8 rows,
   each step run eagerly (the function the graph captured) and then as
   the graph on the same operand: logits bitwise equal, or within 2e-2
   with the reason logged, and the same greedy tokens; the first step
   copies on write for A only; one sampled request (temperature 0.8)
   gives the same tokens graphed, graphed again and eager.  Phase 3
   then runs twice, graphed and with the eager steps: the same tokens
   for every request, and the median step ms, host microseconds a step
   call and decode tokens/s of both.
4. The scheduler path on the same zoo, the serving entry point users
   call: ``PagedLLMScheduler`` over one ``InProcessBackend`` per
   engine, ``select_fn`` = the mux probe, whole-prompt prefill.  16
   prompts of 128-1024 tokens (four share a 256-token prefix) arrive
   open-loop at Poisson times (4 requests/s, ``traffic.arrival_times``)
   and ask for 32 greedy tokens each.  Checks: every request completes
   as its prompt + 32 tokens, ``flash_attention`` launched num_layers x
   whole-prompt prefills and ``paged_attention`` num_layers x decode
   steps (from the engines' own counters), ``mux_score`` once per
   request, a decode batch mixed requests admitted at different times,
   and each pool drains to zero pages.
5. The scheduler path again on the same prompts and arrival times, with
   ``select_fn`` = ``MuxServer.probe_weights`` + ``select`` and no
   prewarm, so every prefill runs in the scheduler's own admission on
   the backend's executor thread.  The checks of phase 4, and besides:
   no logit-cache hit, and every whole-prompt prefill (so every
   ``flash_attention`` launch) made on an executor thread.  Every logit
   sampled in phases 3-5 is finite.
6. The ring-cache path of the launcher, after the zoo of phases 3-5 is
   freed: falcon-mamba-7b at its published config (64 layers, d_model
   4096, d_inner 8192) with random bf16 weights, built by
   ``repro_torch.launch.serve.build_engine``, serves 2 prompts of 1024
   tokens for 32 greedy tokens through ``Engine.generate`` (twice; the
   first run warms up), then 16 ring decode steps are timed one by one;
   olmo-1b at full width serves 2 x 256 tokens for 8 tokens the same
   way (K3 on the ring prefill, ``cache_prefill``).  Checks: tokens of
   shape (2, 1056) and (2, 264); every logit finite; per prefill call,
   ``selective_scan`` launched 64 times (falcon-mamba) or
   ``flash_attention`` 16 times (olmo-1b) and no other kernel.  Each
   ring decode step replays the graph captured when the engine made its
   ring caches; a third ``generate`` with the step run eagerly must
   give the same tokens, and 16 steps from one prefill, eager and then
   graphed from the same saved caches, must give the same tokens and
   logits bitwise equal or within 2e-2 (median step ms and host
   microseconds of each).
7. The paper's image mux, the port's ``configs/paper_mux.py`` at full
   width: the six zoo CNNs (``zoo_xxs`` ... ``zoo_xl``, 32x32x3 images,
   10 classes) and the 4-conv mux backbone (meta_dim 64), random fp32
   weights from a seeded generator, costs from ``zoo_costs``, 2048
   images drawn from ``SEED``.  cuDNN's TF32 switch is on for the phase,
   so the port's own full-fp32 scope of its convolutions is what holds
   the card to the CPU.  Checks, in order: every zoo CNN's logits and
   embeddings and ``serve``'s weights on 16 images, card against CPU
   (1e-4 / 1e-5); ``MuxServer.serve`` on 8 batches of 256 under argmax
   (capacity 64) and under a threshold set in the widest gap of the
   middle half of the cheapest model's weights (capacity 256, at least
   two models called): outputs finite, ``assign`` = ``select`` on the
   returned weights, ``flops`` = ``costs[assign]``, each model keeps
   min(its rows, capacity) and a dropped row is zero, K2's meta form
   launched once a ``serve`` (its capture tallied one), the graphed
   batch step against the eager ``_batch_step`` on every batch (bitwise,
   or within 1e-5 / 1e-4 with the reason logged); ``MuxScheduler``
   with ``bench_scheduler.py``'s setup (``SchedulerConfig(max_batch_size=8,
   max_wait_ms=4.0, default_slo_ms=250.0)``, 192 images at Poisson
   400/s and bursty 200/s, ``warmup`` first) over the thresholded
   server: every request completes bitwise equal to
   ``reference_output(x, reference_assignment(x))``, K2 launched once a
   probe, no graph captured after ``warmup``; K2's meta form at its
   served shapes (B = 1 and 256, M = 64, N = 6) against
   ``mux_score_ref`` and timed.  Its wall time is printed.
8. The paper's Algorithm 1 and its tables, at ``paper_mux.config()``
   uncut, trained fresh on the card (cuDNN's TF32 switch on for the
   phase).  First one ``zoo_train_step`` and one ``mux_train_step`` per
   objective (``"ensemble"`` over the six CNNs, ``"offload"`` over the
   ``zoo_xs`` / ``zoo_m`` pair) on the card and on the CPU from the same
   seeded params and 64 images: the switch read inside every backward
   must be off (and on when the same backward runs outside the port's
   scope); loss, gradient norm, gradients, first moment and updated
   params within their fp32 tolerances (``PAPER_*``).  Then
   ``paper.common.get_state`` at the ``full`` scale: 8192 training and
   2048 eval images drawn on the card, ``train_zoo`` 500 steps at batch
   256, ``train_mux`` 500 steps over all six (``"ensemble"``) and 500
   over the pair (``"offload"``), and the ablation zoo
   (``contrastive=False``, 500 steps), with each stage's wall and median
   ms a step after 10 warm-up steps (CUDA events).  The runners then
   print Fig. 1's matrix, Table I's rows and TNR, Table II's rows,
   saving factor and oracle, and Fig. 6's ratios with and without the
   loss; checks are the JAX package's own (``tests/test_system.py``):
   hybrid-single accuracy within 0.05 of the best single model, its
   FLOPs no more than the largest model's, push above pull with the
   loss; the headline figures are logged, not gated.  Last, both trained
   muxes are served through ``MuxServer.serve`` (argmax, 256-image
   batches, every row kept, K2's meta form as the probe's head): each
   served assignment equals the evaluation's but on rows whose top two
   weights lie within 1e-5 (at most 1% of rows), each served prediction
   on the agreeing rows is right exactly where the evaluation's is
   (Table II's hybrid-single accuracy, Table I's hybrid accuracy and
   local fraction), and K2 launches once a ``serve`` (and once more on
   each server's first, the graph's warm-up); K2's meta form at the
   pair's served shape (B=256, M=64, N=2), on its trained operands, is
   held against ``mux_score_ref`` and timed.
9. MLA and an int8 pool served: minicpm3-4b at its published config
   (62 layers, d_model 2560, 40 heads, kv_lora 256 + d_rope 32;
   random bf16 weights; a bf16 latent pool) next to olmo-1b with
   ``kv_cache_dtype="int8"`` (int8 pages, bf16 scales), 512 pages of 64
   each, ``max_len`` 2048, decode batch 8, behind the token-probe mux of
   ``build_zoo``; prompts from olmo-1b's 50,304-token vocabulary.
   ``check_decode_graphs`` on both engines (each capture tallies one K1
   launch a layer, also under its form: ``paged_attention_latent`` on
   minicpm3-4b, ``paged_attention_int8`` on olmo-1b); both pools'
   dtypes; phase 3 on 8 prompts graphed then eager and phase 4 on 16
   through ``PagedLLMScheduler`` at Poisson 4/s, each with phases 3-4's
   checks (K1 = layers x decode steps by form on each engine, K3 on
   its tensor-core variant = layers x whole-prompt prefills, K2 once a
   probe, every request answered, pools drained); the scheduler's 16
   requests then run again on the direct path, every one held until
   all are admitted: the same tokens, request by request.  On each
   engine a 1024-token prompt is admitted whole and, on a fresh pool,
   in chunks of 256 (``begin_prefill`` / ``prefill_chunk``): first-token
   logits within 2e-2 and the same 8 greedy tokens, or the reason
   logged (a chunked path whose logits are more than a tenth of their
   norm off fails).  Last, ``launch.serve``'s ring path on minicpm3-4b
   (2 x 512 tokens, 16 greedy; phase 6's checks: K3 62 a prefill, graphed
   ring steps against eager).  With ``--profile``, one minicpm3-4b
   1024-token prefill and a graphed decode step of each engine under
   ``torch.profiler``, and phase 6's ring profile.
10. The zoo's remaining single-card models served at their published
   configs (random bf16 weights), each zoo through phase 9's flow
   (``serve_zoo``: the decode graphs' checks, 8 prompts on the direct
   path graphed then eager, 16 through ``PagedLLMScheduler`` at Poisson
   4/s with every request's tokens equal to the direct path's, a
   1024-token prefill whole and in chunks of 256 on each engine; K1 =
   layers x steps and K3 = layers x whole-prompt prefills, each also
   counted in the swa layers alone).  Zoo A: olmo-1b (384 pages) and
   gemma2-27b (46 layers, d_model 4608, 32 heads over 16 KV heads,
   window 4096 on alternate layers, attention and final softcaps; 320
   pages of 64, 7.7 GB), both at ``max_len`` 8192.  Then on gemma2's
   engine alone: prompts of 4608 and 5100 tokens admitted whole and
   decoded 8 tokens together (K3 and K1 launched with the window in
   each of its 23 swa layers, checked), and the 5100-token prompt on
   the paged path against the same engine's ``generate`` (the swa
   layers' 4096-slot ring wraps): first-token logits within 2e-2 and
   the same tokens, or the reason logged; logits a tenth of their norm
   apart fail.  The zoo is freed (under 1 GB left).  Zoo B: olmo-1b and
   olmoe-1b-7b (16 layers, 64 experts top-8, qk-norm; the reference's
   gather dispatch, dropless in decode), 512 pages each, ``max_len``
   2048; its chunked prefill routes each chunk on its own (capacity
   follows the chunk), so that difference is logged, not held.  Last,
   olmoe on the launcher's ring path (2 x 512 tokens, 16 greedy; phase
   6's checks).  Each model's weights-read time (its weight bytes a
   step over 3.35 TB/s) is printed beside its step.  With
   ``--profile``, a 1024-token prefill of each zoo's larger model and a
   graphed decode step of each engine.
11. Speculative multiplexed decoding, ``SpeculativeBackend(
   InProcessBackend(target), draft)`` under ``PagedLLMScheduler``, page
   64, decode batch 8, draft length 4, random bf16 weights from seeded
   generators.  The draft is olmo-1b at its published config; the
   target is its 16 layers followed by 16 whose ``wo`` and MLP ``down``
   are zeroed, with its embedding and final norm (2.25 B params: the
   weight surgery of ``benchmarks/bench_spec_decode.py``), so drafts
   are accepted by construction; a second pair drafts with olmo-1b from
   another seed, whose drafts are nearly all rejected (rollback, the
   acceptance-EMA fallback).  Target ``max_len`` 2048, the draft's 2112
   (lazy decode allocation, no span reclaim).  8 prompts of 128-512
   tokens drafting 4 and 2 of 1024 tokens at k = 0 (a length
   threshold), 24 greedy tokens each at Poisson 4/s, through each pair
   and through a plain ``InProcessBackend`` on the same target.
   Checks: every request answered; each spec request's tokens equal
   the plain target's, or first differ where the plain step's top-2
   logits lie within 2e-2 (logged with the gap: the verify step's
   gathered fp32-score attention and K1 round differently); both pools
   drained; structural acceptance >= 0.9; the diverse pair falls back
   at least once; speculation never turned off by a draft-engine error;
   the verify step's graph bitwise equal to the eager step at its third
   call; K1 = layers x decode steps on each engine, and a verify step
   launches no kernel.  Printed: the verify step's ms at (8, 5) graphed
   and eager and its capture seconds, the target's and the draft's
   step ms, decode tokens/s of each run, acceptance, peak draft-pool
   pages, each model's weights-read time, beside the card's name and
   power limit.
12. LM training (the port's ``launch.train`` / ``Trainer`` /
   ``make_train_step`` / ``lm_loss``).  (a) K3's backward
   (``csrc/flash_attention_bwd.cu``: dq, dk, dv from q, k, v, the
   forward's out and row log-sum-exps, dout) against
   ``flash_attention_bwd_plain`` fed the same tensors, at olmo-1b's
   train shape (B 2, S = T 4096, 16 heads of 128, bf16), GQA g = 2 with
   a window of 256 and cap 50, g = 4 with a chunk of 96, MLA's hd 96 /
   vd 64 at 40 heads, hd 40 / vd 24 off the tiles, and three fp32 cases
   (g = 2; window and cap; chunk at 96 / 64): ||kernel - plain|| /
   ||plain|| of each gradient within 1e-2 (bf16) / 1e-4 (fp32), K3's
   row log-sum-exps against ``flash_attention_lse_plain`` (2e-2 /
   1e-4), the forward's out bitwise unchanged by writing them, two
   backward calls bitwise equal.  (b) At olmo-1b's train shape: the
   backward as a CUDA graph and eager, its bound, its plain version,
   ``scaled_dot_product_attention(is_causal=True)``'s backward through
   autograd (timed apart from its forward), and K3's forward with and
   without the log-sum-exps.  (c) One ``make_train_step`` step and the
   loss and gradients of three tiny fp32 LMs (the GQA window model, the
   MoE and the MLA ones of phase 2; the MLA one with its loss chunked
   by 8) on the card against the CPU on the same params and
   ``lm_batch`` batch, TF32 off: losses and metrics within 1e-5, every
   gradient entry within 1e-5 of the global norm; K3's backward
   launched once a layer, its SIMT forward once (twice under remat).
   (d) olmo-1b at its published config (1.18 B fp32 params, bf16
   compute, ``remat="full"``) trained 20 steps through
   ``launch.train``'s ``build_trainer`` + ``Trainer.run`` on
   ``lm_batch`` at global batch 2 x 4096 (train_4k's 256 does not fit
   one card): median step ms (CUDA events), tokens/s, model FLOPs (6 N
   tokens) as a share of 989 TFLOP/s, ms a batch of data and the
   (vocab, vocab) table's build, peak memory, the losses, then two steps
   under ``torch.profiler`` by kernel family; checks: finite losses and
   gradient norms, step 0 within 1.0 of ln 50,304, the last loss below
   the first, K3 forward launches = 16 x steps x 2 (the remat
   recompute), all on the tensor-core variant, K3 backward launches =
   16 x steps.
13. Last, since a ``torch.profiler`` window slows the host's later
   launches: the whole probe (weights + select) at B=1, S=64, eager
   against graphed: ms a call, host microseconds a call, and device
   busy ms and launches a probe from ``torch.profiler``, whose rows
   must show ``mux_score_kernel`` once a probe on either path.  With
   ``--profile`` the profiled sections (one 1024-token prefill per
   engine, a graphed decode step 2 of a rerun of phase 3, and of phase
   6 one prefill, one graphed and one eager ring step) follow the
   served phases they read from.  After the probe's profile, always:
   10 graphed image ``serve`` steps
   (argmax, B = 256) under ``torch.profiler``: device busy ms and
   launches a step against the median wall ms of an unprofiled
   ``serve``, the idle share; K2 must show once a step.  Then 5
   ``zoo_train_step``s of phase 8 under ``torch.profiler`` with cuDNN's
   TF32 switch on: device busy ms and launches a step against the timed
   median, and no kernel whose name says TF32.

Output: progress lines, then the ``{"kernels": [...]}`` JSON line (the
launches are phase 4's for K1-K3 and phase 6's falcon-mamba run for K4;
K1's and K3's entries also have phase 9's launches, ``phase9_launches``,
and their times at the MLA shapes, ``mla_shape`` / ``mla_shapes``, and
phase 10's scheduler launches by zoo, ``phase10_launches``, and their
rows at gemma2's shapes, ``g2_shape``;
K2's entry also has its meta form's launches on phase 7's image path and
phase 8's served trained muxes, ``meta_launches``, and its times at the
served shapes, ``meta_form``; K3's backward's entry, ``flash_attention_bwd``,
has phase 12's olmo-1b launches and its times at that train shape),
a JSON line of K1's ptxas resources and its times by shape, a JSON
line of K4's ptxas resources and its times by batch, a JSON
line of K3's tensor-core variant's ptxas resources and its
times at each served shape beside SDPA and the bound, a JSON line of
the direct path's per-request admission ms and decode tokens/s and,
for phases 4 and 5, the launches, TTFT p50/p99 and decode tokens/s per
model, a JSON line of phase 6's prefill ms, decode tokens/s (graphed and
eager), median decode step ms, the ring step's capture seconds and its
eager-against-graphed steps, and launches per model (with ``--profile``
also device busy ms of the prefill, K4's share of it, and of one
graphed and one eager decode step), a ``{"decode_graphs": ...}`` line
(the paged steps' captures and checks, and phase 3's step ms, host
microseconds and tokens/s graphed and eager), a
``{"probe": ...}`` line (K2's ptxas resources and times, the graphs
against the eager probe, the probe eager against graphed), an
``{"image_mux": ...}`` line (phase 7's figures: ``serve`` ms a batch
graphed and eager, images/s, mean_flops, saving factor and called
fractions per policy, the scheduler's throughput, p50 / p99, queue p99,
batch fill, saving factor and SLO violations per load, K2's meta form
at its served shapes, the profiled serve step), a ``{"paper": ...}``
line (phase 8's card-vs-CPU steps, each training stage's steps, wall,
median ms a step and first / last loss, the tables, the headline
figures, the served trained muxes, the profiled zoo step), an
``{"mla_phase": ...}`` line (phase 9: the decode graphs' checks, the
pools, per model the admission ms, TTFT p50 / p99, decode tokens/s and
median step ms graphed / eager, the launches, the chunked prefills,
the ring path, the phase's wall seconds), a ``{"zoo_phase": ...}``
line (phase 10 by zoo: memory after the build, per model the admission
ms, TTFT p50 / p99, decode tokens/s direct and through the scheduler,
median step ms graphed / eager beside its weights-read ms, the chunked
prefills; gemma2's long prompts' prefill ms and launches and its ring
against paged difference; olmoe's ring path; the wall seconds), a
``{"spec_phase": ...}`` line (phase 11: the card, the plain run's and
each pair's decode tokens/s, counters, acceptance, steps, K1 launches,
near-ties, the verify graph against eager, the timed steps), a
``{"train_phase": ...}`` line (phase 12: K3's backward checks and
times, the tiny train steps, olmo-1b's run and its profiled step), the
card's name and power limit (nvidia-smi), and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises: the run
exits non-zero without that last line.  It needs one CUDA card and a
checkout of the repository (it imports ``src/repro_torch``).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
FP32_FLOPS = 67e12               # fp32 outside the tensor cores
SEED = 0
BF16_TOL = 2e-2
F32_PAGED_TOL = 1e-4
F32_FLASH_TOL = 1e-4
# K3 bf16, per element beside the 2e-2 above: |kernel - plain| <= 4e-3 +
# 2e-2 |plain| (bf16 rounding of P and of the output is relative; the
# absolute term covers entries near 0)
BF16_FLASH_REL = (4e-3, 2e-2)
# K1 / K3 bf16, per output vector (one query row of one head): ||kernel -
# plain|| <= 1e-2 ||plain||.  bf16 rounding of the output is 2^-9 of it;
# where a softmax spreads over thousands of keys the outputs sit near
# 0.02, the size of the absolute 2e-2 above, which then holds nothing
BF16_ROW_REL_L2 = 1e-2
F32_MUX_TOL = 1e-5
SCAN_RTOL = SCAN_ATOL = 2e-5     # K4 in fp32 arithmetic, as the JAX sweep
MODEL_TOL = 1e-3                 # fp32 logits, card vs CPU
SFU_EXP_PER_CLOCK_PER_SM = 16    # MUFU exponentials, Hopper


class CheckFailed(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn(i)`` over ``iters`` calls (CUDA events)."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_cuda_graph(fn, iters: int, reps: int = 5) -> float:
    """Mean ms per call of ``fn(i)``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events — the device's
    time for back-to-back calls without the host's per-call cost (an
    extra column beside ``time_cuda``, never in its place)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm up off the default stream
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * iters)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn(i)``: the time the calling
    thread spends in it (it returns once the launch is queued; at a
    short kernel and 200 calls the queue never fills, so no call waits
    for the device)."""
    import torch
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(calls):
        fn(i)
    host = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return host


def ptxas_entries(lib: str, key: str) -> dict:
    """{mangled entry: "registers ...; spills ..."} for every entry of
    ``csrc/<lib>.cu``'s build log whose name contains ``key``."""
    from repro_torch.kernels import build
    build.load(lib)                             # builds the source if needed
    lines = build.build_log(lib).splitlines()
    found = {}
    for i, ln in enumerate(lines):
        if "Compiling entry" not in ln or key not in ln:
            continue
        name = ln.split("'")[1] if "'" in ln else ln.strip()
        body = []
        for nxt in lines[i + 1:]:
            if "Compiling entry" in nxt:
                break
            if "registers" in nxt or "spill" in nxt:
                body.append(nxt.replace("ptxas info    :", "").strip())
        found[name] = "; ".join(body)
    return found


def check_sm90_resources() -> dict:
    """K3's tensor-core variant at the served width (hd = vd = 128, the
    ``<128>`` instantiation): ptxas's registers and spills from the build
    log and the dynamic shared memory its launch asks for; it must spill
    nothing."""
    from repro_torch.kernels.flash_attention import wgmma_smem_bytes
    smem = wgmma_smem_bytes(128)                # builds the source if needed
    entry = ptxas_entries("flash_attention_sm90",
                          "flash_attention_sm90_kernelILi128E")
    check(len(entry) == 1, "no ptxas entry for the <128> instantiation of "
          "flash_attention_sm90_kernel in the build log")
    text = next(iter(entry.values()))
    log(f"  flash_attention_sm90 <128>: {text}; dynamic shared memory "
        f"{smem} bytes a block")
    check("0 bytes spill stores, 0 bytes spill loads" in text,
          f"flash_attention_sm90 at hd = vd = 128 spills: {text}")
    return {"ptxas": text, "dynamic_smem_bytes": smem}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_inputs(gen, dev, *, lengths, h, kk, hd, ps, m, page_dtype,
                 q_dtype, vd=None, share_kv=False):
    """Random q and page pool drawn on the CPU from ``gen``; row i maps
    its own shuffled pages.  int8 pools quantise per (slot, head) as the
    model's pool does."""
    import torch
    from repro_torch.models.attention import _quantize
    vd = vd or hd
    need = [max(1, -(-int(n) // ps)) for n in lengths]
    pages = 1 + sum(need)
    perm = torch.randperm(pages - 1, generator=gen) + 1
    bt = torch.zeros((len(lengths), m), dtype=torch.int32)
    off = 0
    for i, n in enumerate(need):
        bt[i, :n] = perm[off:off + n].to(torch.int32)
        off += n
    q = torch.randn((len(lengths), h, hd), generator=gen).to(q_dtype)
    kf = torch.randn((pages, ps, kk, hd), generator=gen)
    vf = kf if share_kv else torch.randn((pages, ps, kk, vd), generator=gen)
    inp = {"q": q, "bt": bt,
           "lengths": torch.as_tensor(lengths, dtype=torch.int32)}
    if page_dtype == torch.int8:
        inp["k"], inp["k_scales"] = _quantize(kf)
        inp["v"], inp["v_scales"] = ((inp["k"], inp["k_scales"]) if share_kv
                                     else _quantize(vf))
    else:
        inp["k"] = kf.to(page_dtype)
        inp["v"] = inp["k"] if share_kv else vf.to(page_dtype)
    return {k: v.to(dev) for k, v in inp.items()}


def paged_call(inp, kw):
    args = (inp["q"], inp["k"], inp["v"], inp["bt"], inp["lengths"])
    kw = dict(kw)
    if "k_scales" in inp:
        kw.update(k_scales=inp["k_scales"], v_scales=inp["v_scales"])
    return args, kw


def check_paged_resources() -> dict:
    """K1's served instantiations (bf16 pages: one output a thread and
    rows up to 256, ``paged_attention_kernel<__nv_bfloat16, 1, 256>``,
    for the MHA models; 16 outputs a thread and rows up to 512,
    ``<__nv_bfloat16, 16, 512>``, for the absorbed MLA latent) and both
    forms of its combine pass (``<false>``, one block a (KV head, row);
    ``<true>``, runs of outputs for head-tiled shapes): ptxas's
    registers and spills from the build log; none may spill."""
    found = {}
    for key, tag in (("paged_attention_kernelI13__nv_bfloat16Li1ELi256EE",
                      "split"),
                     ("paged_attention_kernelI13__nv_bfloat16Li16ELi512EE",
                      "split_mla"),
                     ("paged_attention_kernel_combineILb0E", "combine"),
                     ("paged_attention_kernel_combineILb1E",
                      "combine_mla")):
        entry = ptxas_entries("paged_attention", key)
        check(len(entry) == 1, f"no single ptxas entry for K1's {tag} kernel "
              f"({key}) in the build log")
        text = next(iter(entry.values()))
        log(f"  paged_attention {tag} kernel (bf16 pages): {text}")
        check("0 bytes spill stores, 0 bytes spill loads" in text,
              f"K1's {tag} kernel spills: {text}")
        found[tag] = text
    return found


def paged_plan_of(inp, v_dim=None) -> str:
    """The split plan the wrapper takes for these inputs (for the log)."""
    import torch
    from repro_torch.kernels.paged_attention import (paged_plan, sm_count,
                                                     smem_optin)
    q, k, v, bt = inp["q"], inp["k"], inp["v"], inp["bt"]
    p = paged_plan(q.shape[0], k.shape[2], q.shape[1] // k.shape[2],
                   bt.shape[1], k.shape[1], q.shape[2], v_dim or v.shape[-1],
                   k.element_size(), k.dtype == torch.int8,
                   sm_count(q.device.index), smem_optin(q.device.index))
    tiles = f" x{p.head_tiles} head tiles" if p.head_tiles > 1 else ""
    return f"{p.num_splits}x{p.pages_per_split}p tile {p.tile}{tiles}"


def bf16_errors(got, want) -> dict:
    """``got`` against ``want``: the max abs error, the worst element's
    share of its ``BF16_FLASH_REL`` limit, and the worst relative L2
    error of one output vector (the last axis)."""
    d, w = got.float() - want.float(), want.float()
    rel_abs, rel = BF16_FLASH_REL
    return {"max_abs_err": d.abs().max().item(),
            "rel_ratio": (d.abs() / (rel_abs + rel * w.abs())).max().item(),
            "row_rel_l2": (d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
                           ).max().item()}


def k1_four_ways(args, kw, pf) -> tuple:
    """K1 on one input four ways: separate operands, the same call
    again, the combined operand (``pf``, :func:`decode_prefetch`'s) and
    one replay of that call captured in a CUDA graph.  Returns the first
    output and whether each other one equals it bit for bit."""
    import torch
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    sep = paged_attention_cuda(*args, **kw)
    again = paged_attention_cuda(*args, **kw)
    comb = paged_attention_cuda(*args, prefetch=pf, **kw)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_attention_cuda(*args, prefetch=pf, **kw)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        captured = paged_attention_cuda(*args, prefetch=pf, **kw)
    graph.replay()
    torch.cuda.synchronize()
    return sep, {"combined==separate": torch.equal(sep, comb),
                 "repeat": torch.equal(sep, again),
                 "graph==eager": torch.equal(sep, captured)}


def k1_timed(copies, kw, *, iters: int, plain_iters: int) -> dict:
    """K1 with ``kw`` over the rotated input ``copies``: eager
    (``time_cuda``, ``iters`` calls), as a CUDA graph (half as many),
    the plain version, the wrapper's host microseconds a call, and the
    bound's two parts (:func:`paged_bound_parts` on the first copy, at
    ``kw``'s ``v_dim`` and window) with the larger of them."""
    from repro_torch.kernels.paged_attention import (decode_prefetch,
                                                     paged_attention_cuda,
                                                     paged_attention_plain)
    calls = [paged_call(c, kw) for c in copies]
    pfs = [decode_prefetch(c["bt"], c["lengths"]) for c in copies]
    n = len(copies)

    def kernel(i):
        a, k = calls[i % n]
        return paged_attention_cuda(*a, prefetch=pfs[i % n], **k)

    def plain(i):
        a, k = calls[i % n]
        return paged_attention_plain(*a, **k)
    t_bytes, t_ops = paged_bound_parts(copies[0], kw.get("v_dim"),
                                       kw.get("window"))
    return {"copies": n, "ms": time_cuda(kernel, iters=iters),
            "graph_ms": time_cuda_graph(kernel, iters=iters // 2),
            "plain_ms": time_cuda(plain, iters=plain_iters),
            "host_us": host_us(kernel), "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_paged_attention(dev) -> float:
    """K1 over page dtypes x GQA groups x variants: short rows at page
    16 (M=16), long rows at page 64 (M=32: lengths 0, 1, 63, 64, 65,
    1000, 2048 with windows and a chunk whose edges fall inside splits)
    and a shape the plan serves in one split.  Each case: within
    tolerance of the plain version, separate == combined operands and
    two calls bitwise equal, length-0 rows exact zeros.  Returns the max
    error over every case."""
    import torch
    from repro_torch.kernels.paged_attention import (decode_prefetch,
                                                     paged_attention_cuda,
                                                     paged_attention_plain)
    gen = torch.Generator().manual_seed(SEED)
    h, hd = 16, 128
    short = {"full": {}, "window": {"window": 50}, "chunk": {"chunk": 48},
             "logit_cap": {"logit_cap": 30.0}, "v_dim": {"v_dim": 64}}
    long = {"long": {}, "long_window50": {"window": 50},
            "long_window1000": {"window": 1000},
            "long_chunk300": {"chunk": 300}}
    cases = ([(16, 16, [0, 1, 77, 200, 256], v, kw) for v, kw in short.items()]
             + [(64, 32, [0, 1, 63, 64, 65, 1000, 2048], v, kw)
                for v, kw in long.items()])
    dtypes = {"float32": (torch.float32, torch.float32),
              "bf16": (torch.bfloat16, torch.bfloat16),
              "int8": (torch.int8, torch.bfloat16)}
    one_split = list(np.random.default_rng(SEED).integers(0, 129, 64))
    worst = 0.0
    for dname, (page_dtype, q_dtype) in dtypes.items():
        tol = F32_PAGED_TOL if dname == "float32" else BF16_TOL
        todo = [(g, *c) for g in (1, 2, 4, 8) for c in cases]
        todo.append((1, 64, 2, [0] + one_split[1:], "one_split", {}))
        for g, ps, m, lengths, vname, kw in todo:
            inp = paged_inputs(gen, dev, lengths=lengths, h=h, kk=h // g,
                               hd=hd, ps=ps, m=m, page_dtype=page_dtype,
                               q_dtype=q_dtype, share_kv=vname == "v_dim")
            args, kwargs = paged_call(inp, kw)
            sep = paged_attention_cuda(*args, **kwargs)
            again = paged_attention_cuda(*args, **kwargs)
            pf = decode_prefetch(inp["bt"], inp["lengths"])
            comb = paged_attention_cuda(*args, prefetch=pf, **kwargs)
            torch.cuda.synchronize()
            plain = paged_attention_plain(*args, **kwargs)
            err = (sep.float() - plain.float()).abs().max().item()
            same = torch.equal(sep, comb)
            repeat = torch.equal(sep, again)
            zero = bool((sep[0] == 0).all())
            log(f"K1 {dname:7s} g={g} {vname:15s} splits "
                f"{paged_plan_of(inp):18s} max_err={err:.3e} tol={tol:g} "
                f"combined==separate={same} repeat={repeat} len0_zero={zero}")
            check(err <= tol, f"K1 {dname} g={g} {vname}: max_err "
                  f"{err:.3e} > {tol:g}")
            check(same, f"K1 {dname} g={g} {vname}: the combined operand "
                  f"gives another result than separate ones")
            check(repeat, f"K1 {dname} g={g} {vname}: two calls differ")
            check(zero, f"K1 {dname} g={g} {vname}: a length-0 row is not "
                  f"exact zeros")
            worst = max(worst, err)
    return worst


def served_paged_shape(dev, *, h: int, copies: int = 1, lengths=None):
    """Decode batch 8, ``h`` heads of 128, page 64, mixed lengths up to
    1024, bf16 pages (the olmo-1b / codeqwen1.5-7b decode step); other
    ``lengths`` (e.g. one 2048-token row) on the same pool layout."""
    import torch
    gen = torch.Generator().manual_seed(SEED + h)
    lengths = lengths or [1024, 911, 777, 600, 433, 256, 129, 17]
    return [paged_inputs(gen, dev, lengths=lengths, h=h, kk=h, hd=128, ps=64,
                         m=32, page_dtype=torch.bfloat16,
                         q_dtype=torch.bfloat16) for _ in range(copies)]


def paged_bound_parts(inp, v_dim=None, window=None) -> tuple:
    """(bytes ms, operations ms) of one K1 call on these inputs (no
    chunk): each row's query sees its last ``min(length, window)``
    tokens (all of them without a window) and the kernel reads exactly
    those.  Bytes: the visible tokens' K/V (and int8 scales) once per
    (row, kv head) — where V is the leading ``v_dim`` features of the K
    slab (absorbed MLA) the slab once — the page ids of the pages
    holding them and each row's length, q and out, over HBM bandwidth.
    Operations: 2*(hd+vd) FLOPs per (query head, visible token) over
    the bf16 rate."""
    import torch
    q, k, v = inp["q"], inp["k"], inp["v"]
    b, h, hd = q.shape
    ps, kk = k.shape[1], k.shape[2]
    vd = v_dim or v.shape[-1]
    per_token = kk * hd * k.element_size()
    if v is not k:
        per_token += kk * vd * v.element_size()
    if k.dtype == torch.int8:
        per_token += kk * 2 * 2          # two bf16 scales per kv head
    lengths = inp["lengths"].tolist()
    first = [max(0, n - window) if window else 0 for n in lengths]
    tokens = sum(n - f for n, f in zip(lengths, first))
    pages = sum(-(-n // ps) - f // ps for n, f in zip(lengths, first))
    byts = (tokens * per_token + 4 * (pages + b)
            + (q.numel() + b * h * vd) * q.element_size())
    flops = 2 * h * (hd + vd) * tokens
    return byts / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3


# K1's timed shapes: (name, heads, lengths or None for the served mix)
PAGED_TIMED = (("B=8 H=16", 16, None), ("B=8 H=32", 32, None),
               ("B=1 H=16 len=2048", 16, [2048]))


def time_paged_attention(dev) -> dict:
    """K1 at olmo-1b's and codeqwen1.5-7b's served decode shapes (B=8,
    H=16 / 32, hd=128, page 64, bf16, lengths 17-1024; held against the
    plain version first) and at B=1 with one 2048-token row: the eager
    time (``time_cuda``, the method of every earlier row), the same
    calls captured in a CUDA graph (``time_cuda_graph``: the device's
    time, and proof that K1 captures), the bound, the plain version and
    the wrapper's host microseconds a call (:func:`k1_timed`).  Enough
    input copies rotate that their pages exceed the 50 MB L2.  Returns
    olmo's numbers and a row per shape."""
    from repro_torch.kernels.paged_attention import (decode_prefetch,
                                                     paged_attention_cuda,
                                                     paged_attention_plain)
    rows = []
    for name, h, lengths in PAGED_TIMED:
        one = served_paged_shape(dev, h=h, lengths=lengths)[0]
        args, _ = paged_call(one, {})
        out = paged_attention_cuda(*args, prefetch=decode_prefetch(
            one["bt"], one["lengths"]))
        err = (out.float() - paged_attention_plain(*args).float()
               ).abs().max().item()
        check(err <= BF16_TOL, f"K1 at {name}: max_err {err:.3e}")
        pool_bytes = 2 * one["k"].numel() * one["k"].element_size()
        copies = [one] + served_paged_shape(
            dev, h=h, lengths=lengths,
            copies=max(1, -(-160_000_000 // pool_bytes) - 1))
        row = {"shape": name, "max_abs_err": err,
               **k1_timed(copies, {}, iters=200, plain_iters=20)}
        log(f"K1 time at {name} hd=128 page=64 bf16: kernel {row['ms']:.4f} "
            f"ms, as a CUDA graph {row['graph_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.4f} ms, host {row['host_us']:.1f} us a call, "
            f"max_err {err:.3e}, {row['copies']} rotated copies")
        rows.append(row)
    first = rows[0]
    return {**{k: first[k] for k in ("ms", "graph_ms", "plain_ms",
                                     "bound_ms", "bound_by")},
            "served_err": max(r["max_abs_err"] for r in rows[:2]),
            "shapes": rows}


# K1's absorbed-latent (MLA) form at minicpm3-4b's decode shape: 40 query
# heads over one latent head of kv_lora + d_rope = 256 + 32, V the leading
# 256 features of the same slab, bf16 pages of 64, max_len 2048
MLA_K1 = dict(h=40, kk=1, hd=288, vd=256, ps=64, m=32)
MLA_K1_LENGTHS = (("B=8 served mix, len-0 row",
                   [0, 1024, 911, 777, 600, 433, 129, 17]),
                  ("B=1 len=2048", [2048]))
MLA_K1_TIMED = (("B=8 H=40 K=1 hd=288 v_dim=256",
                 [1024, 911, 777, 600, 433, 256, 129, 17]),
                ("B=1 H=40 K=1 hd=288 v_dim=256 len=2048", [2048]))


def mla_paged_inputs(gen, dev, lengths):
    """K1 operands at the MLA decode shape: q (B, 40, 288) and one bf16
    latent pool passed as both K and V."""
    import torch
    c = MLA_K1
    inp = paged_inputs(gen, dev, lengths=lengths, h=c["h"], kk=c["kk"],
                       hd=c["hd"], ps=c["ps"], m=c["m"],
                       page_dtype=torch.bfloat16, q_dtype=torch.bfloat16,
                       share_kv=True)
    inp["v"] = inp["k"]          # one tensor, as the MLA decode passes it
    return inp


def check_paged_mla(dev) -> float:
    """K1's absorbed-latent form (``v_pages is k_pages``, ``v_dim`` 256
    of a 288-wide slab, g = 40: five head tiles of 8 heads on the wide
    instantiation) against its plain version at the served mix of
    lengths with a length-0 row and at one 2048-token row: within 2e-2,
    separate == combined operands and two calls bitwise equal, the
    length-0 row exact zeros, and one replay of the call captured in a
    CUDA graph bitwise equal to the eager call (:func:`k1_four_ways`).
    Returns the max error."""
    import torch
    from repro_torch.kernels.paged_attention import (decode_prefetch,
                                                     paged_attention_plain)
    gen = torch.Generator().manual_seed(SEED + 40)
    worst = 0.0
    vd = {"v_dim": MLA_K1["vd"]}
    for name, lengths in MLA_K1_LENGTHS:
        inp = mla_paged_inputs(gen, dev, lengths)
        check(inp["v"] is inp["k"], "K1 MLA: V is not the K slab")
        args, kw = paged_call(inp, vd)
        sep, same = k1_four_ways(args, kw, decode_prefetch(inp["bt"],
                                                           inp["lengths"]))
        plain = paged_attention_plain(*args, **kw)
        err = (sep.float() - plain.float()).abs().max().item()
        zero = bool((sep[lengths.index(0)] == 0).all()) if 0 in lengths \
            else True
        log(f"K1 MLA {name:26s} splits {paged_plan_of(inp, 256):22s} "
            f"max_err={err:.3e} tol={BF16_TOL:g} "
            + " ".join(f"{k}={v}" for k, v in same.items())
            + f" len0_zero={zero}")
        check(err <= BF16_TOL, f"K1 MLA {name}: max_err {err:.3e}")
        check(all(same.values()), f"K1 MLA {name}: {same}")
        check(zero, f"K1 MLA {name}: a length-0 row is not exact zeros")
        worst = max(worst, err)
    return worst


def time_paged_mla(dev) -> list:
    """K1's absorbed-latent form at minicpm3-4b's decode shapes (B=8 at
    the served mix of lengths 17-1024, and B=1 at one 2048-token row):
    eager (``time_cuda``), as a CUDA graph, the plain version, the
    wrapper's host microseconds a call, and the bound from bytes (3.35
    TB/s) and from FLOPs (989 TFLOP/s bf16; the fp32 CUDA-core time at
    67 TFLOP/s beside it, which a SIMT kernel meets first), through
    :func:`k1_timed`.  Input copies rotate past the 50 MB L2.  Returns a
    row per shape."""
    import torch
    from repro_torch.kernels.paged_attention import (decode_prefetch,
                                                     paged_attention_cuda,
                                                     paged_attention_plain)
    gen = torch.Generator().manual_seed(SEED + 41)
    vd = {"v_dim": MLA_K1["vd"]}
    rows = []
    for name, lengths in MLA_K1_TIMED:
        one = mla_paged_inputs(gen, dev, lengths)
        pool_bytes = one["k"].numel() * one["k"].element_size()
        copies = [one] + [mla_paged_inputs(gen, dev, lengths) for _ in range(
            max(1, -(-160_000_000 // pool_bytes) - 1))]
        args, kw = paged_call(one, vd)
        out = paged_attention_cuda(*args, prefetch=decode_prefetch(
            one["bt"], one["lengths"]), **kw)
        err = (out.float() - paged_attention_plain(*args, **kw).float()
               ).abs().max().item()
        check(err <= BF16_TOL, f"K1 MLA at {name}: max_err {err:.3e}")
        row = {"shape": name, "max_abs_err": err,
               "plan": paged_plan_of(one, vd["v_dim"]),
               **k1_timed(copies, vd, iters=100, plain_iters=10)}
        row["fp32_simt_ops_ms"] = row["ops_ms"] * BF16_FLOPS / FP32_FLOPS
        log(f"K1 MLA time at {name} page=64 bf16: kernel {row['ms']:.4f} ms, "
            f"as a CUDA graph {row['graph_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}: bytes "
            f"{row['bytes_ms']:.4f} ms, bf16 FLOPs {row['ops_ms']:.4f} ms; "
            f"fp32 CUDA-core FLOPs {row['fp32_simt_ops_ms']:.4f} ms), plain "
            f"{row['plain_ms']:.4f} ms, host {row['host_us']:.1f} us a call, "
            f"plan {row['plan']}, max_err {err:.3e}, {row['copies']} "
            f"rotated copies")
        rows.append(row)
    return rows


# K1 at gemma2-27b's decode shape: 32 query heads over 16 KV heads of 128
# (g = 2), bf16 pages of 64, max_len 8192 (128 pages a row), its swa
# layers' window of 4096 and logit cap 50 at query scale 144^-1/2; rows
# 17-5100 long, three past the window
G2_K1 = dict(h=32, kk=16, hd=128, ps=64, m=128)
G2_K1_LENGTHS = [5100, 4608, 4097, 3000, 2048, 1024, 333, 17]
G2_ATTN = dict(window=4096, logit_cap=50.0, scale=144 ** -0.5)
# the cap-binding inputs: q times 16 (exact in bf16) spreads the logits to
# a std of about 15 (16 sqrt(128) / 12), the largest of a 4096-key row
# near 60, which the cap of 50 pulls to about 42; at the plain inputs'
# |s| <= 4 the cap moves a logit by 1e-3 and no check could see it
G2_CAP_Q_GAIN = 16.0


def g2_paged_inputs(gen, dev):
    import torch
    c = G2_K1
    return paged_inputs(gen, dev, lengths=G2_K1_LENGTHS, h=c["h"],
                        kk=c["kk"], hd=c["hd"], ps=c["ps"], m=c["m"],
                        page_dtype=torch.bfloat16, q_dtype=torch.bfloat16)


def gemma2_paged(dev) -> dict:
    """K1 at gemma2-27b's decode shape with its swa layers' window and
    logit cap (``G2_K1``): against its plain version (2e-2, per element
    ``BF16_FLASH_REL`` and per output vector ``BF16_ROW_REL_L2``), the
    bitwise checks of :func:`k1_four_ways`, and a row past the window
    differing from the same call without it by 10x its error (the
    window masks).  On the same pages with q scaled by
    ``G2_CAP_Q_GAIN``, so that the cap binds: against the plain version
    on q in fp32 per output vector, and differing from the call without
    the cap (the worst output vector's relative L2) by 10x that error
    (the cap is applied).  Then timed (:func:`k1_timed`:
    eager, as a CUDA graph, the plain version and the wrapper's host
    microseconds a call, input copies rotated past the 50 MB L2) beside
    its bound (the visible tokens: the last 4096 of a longer row).
    Returns the row."""
    import torch
    from repro_torch.kernels.paged_attention import (decode_prefetch,
                                                     paged_attention_cuda,
                                                     paged_attention_plain)
    gen = torch.Generator().manual_seed(SEED + 27)
    one = g2_paged_inputs(gen, dev)
    args, kw = paged_call(one, G2_ATTN)
    pf = decode_prefetch(one["bt"], one["lengths"])
    out, same = k1_four_ways(args, kw, pf)
    plain = paged_attention_plain(*args, **kw)
    errs = bf16_errors(out, plain)
    unmasked = paged_attention_cuda(*args, prefetch=pf, **{
        k: v for k, v in kw.items() if k != "window"})
    masks = (out[0].float() - unmasked[0].float()).abs().max().item()
    row0_err = (out[0].float() - plain[0].float()).abs().max().item()
    hot = (args[0] * G2_CAP_Q_GAIN,) + args[1:]
    capped = paged_attention_cuda(*hot, prefetch=pf, **kw)
    uncapped = paged_attention_cuda(*hot, prefetch=pf, **{
        k: v for k, v in kw.items() if k != "logit_cap"})
    # the plain version scales q in its own dtype (as the reference
    # does): at these logits bf16's rounding of q * scale moves a logit
    # by ~0.03 and the output by ~2%, so it gets q in fp32, which the
    # kernel scales in fp32
    cap_errs = bf16_errors(capped, paged_attention_plain(
        hot[0].float(), *hot[1:], **kw))
    cap_errs["row_rel_l2_bf16_q_plain"] = bf16_errors(
        capped, paged_attention_plain(*hot, **kw))["row_rel_l2"]
    caps = bf16_errors(uncapped, capped)["row_rel_l2"]
    log(f"K1 gemma2 B=8 H=32 K=16 window 4096 cap 50 splits "
        f"{paged_plan_of(one):18s} max_err={errs['max_abs_err']:.3e} "
        f"tol={BF16_TOL:g} rel_ratio={errs['rel_ratio']:.3f} row_rel_l2="
        f"{errs['row_rel_l2']:.3e} tol={BF16_ROW_REL_L2:g} "
        + " ".join(f"{k}={v}" for k, v in same.items())
        + f" row 0 (5100) with vs without the window {masks:.3e}; q x "
        f"{G2_CAP_Q_GAIN:g}: max_err={cap_errs['max_abs_err']:.3e} "
        f"rel_ratio={cap_errs['rel_ratio']:.3f} row_rel_l2="
        f"{cap_errs['row_rel_l2']:.3e} (against the plain version on bf16 q "
        f"{cap_errs['row_rel_l2_bf16_q_plain']:.3e}), with vs without the "
        f"cap (row_rel_l2) {caps:.3e}")
    check(errs["max_abs_err"] <= BF16_TOL and errs["rel_ratio"] <= 1.0
          and errs["row_rel_l2"] <= BF16_ROW_REL_L2,
          f"K1 gemma2: {errs}")
    check(all(same.values()), f"K1 gemma2: {same}")
    check(masks > 10 * row0_err, f"K1 gemma2: the 5100-token row's "
          f"output with and without the window differs by {masks:.3e}, "
          f"not 10x its error {row0_err:.3e}: the window does not mask")
    check(cap_errs["row_rel_l2"] <= BF16_ROW_REL_L2,
          f"K1 gemma2, q x {G2_CAP_Q_GAIN:g}: {cap_errs}")
    check(caps > 10 * cap_errs["row_rel_l2"], f"K1 gemma2, q x "
          f"{G2_CAP_Q_GAIN:g}: the output with and without the cap differs "
          f"by {caps:.3e} of its norm, not 10x its error "
          f"{cap_errs['row_rel_l2']:.3e}: the cap is not applied")
    pool_bytes = 2 * one["k"].numel() * one["k"].element_size()
    copies = [one] + [g2_paged_inputs(gen, dev) for _ in range(
        max(1, -(-160_000_000 // pool_bytes) - 1))]
    row = {"shape": "B=8 H=32 K=16 hd=128 page=64 window=4096 cap=50 "
                    "len=17..5100", **errs, "plan": paged_plan_of(one),
           "cap_bound": {"q_gain": G2_CAP_Q_GAIN, **cap_errs,
                         "capped_vs_uncapped": caps},
           **k1_timed(copies, G2_ATTN, iters=100, plain_iters=5),
           "library_ms": None,
           "library_none": "no library call pages K/V through block tables "
                           "with a window and a logit cap"}
    log(f"K1 time at gemma2's decode shape: kernel {row['ms']:.4f} ms, as a "
        f"CUDA graph {row['graph_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
        f"ms ({row['bound_by']}), plain {row['plain_ms']:.4f} ms, host "
        f"{row['host_us']:.1f} us a call, {row['copies']} rotated copies")
    return row


# K2's head form: (B, S, d, M, N, normalize); the first is the served probe
MUX_HEAD_CASES = ((1, 64, 128, 32, 2, False), (3, 1, 32, 8, 2, True),
                  (5, 17, 96, 24, 6, True), (2, 64, 128, 32, 16, False),
                  (2, 5, 30, 8, 3, True),       # d % 4 != 0: 4-byte loads
                  (2, 9, 64, 72, 40, True),     # M, N > 32: lanes loop
                  (1, 8, 4096, 32, 2, False))   # 132 KB of shared memory
MUX_META_CASES = ((10, 64, 6, True), (300, 32, 2, True), (7, 128, 16, True),
                  (1, 32, 2, False),
                  (1, 64, 6, False), (256, 64, 6, False),  # the image mux
                  (256, 64, 2, False))        # the trained pair mux
MUX_SERVED = MUX_HEAD_CASES[0]
# the probe's graphs against its eager functions, in this order, so a
# second shape follows a first: (B, S)
PROBE_SHAPES = ((1, 64), (1, 17), (3, 64))
# prompt lengths the zoo's probe first sees while a prefill runs on
# another thread (``check_capture_race``)
RACE_LENS = (23, 40, 57)


def check_mux_resources() -> dict:
    """K2's two forms (``mux_score_kernel<true>``, the head form on the
    probe's path, and ``<false>``, the meta form): ptxas's registers and
    spills from the build log; neither may spill."""
    found = ptxas_entries("mux_score", "mux_score_kernel")
    out = {}
    for form, tag in (("head", "ILb1E"), ("meta", "ILb0E")):
        hits = [k for k in found if tag in k]
        check(len(hits) == 1, f"no single ptxas entry for K2's {form} form "
              f"in the build log: {sorted(found)}")
        text = found[hits[0]]
        log(f"  mux_score {form} form: {text}")
        check("0 bytes spill stores, 0 bytes spill loads" in text,
              f"K2's {form} form spills: {text}")
        out[form] = text
    return out


def mux_inputs(gen, dev, b, s, d, m, n, *, misalign=False):
    """Random h (B, S, d), w_out (d, M) / sqrt(d), v (N, M) and cost^alpha
    (N,) drawn on the CPU from ``gen``; ``misalign`` puts h 4 bytes past a
    16-byte boundary (the kernel's 4-byte path)."""
    import torch
    flat = torch.randn((b * s * d + 1,), generator=gen).to(dev)
    h = (flat[1:] if misalign else flat[:-1]).view(b, s, d)
    w_out = (torch.randn((d, m), generator=gen) / d ** 0.5).to(dev)
    v = torch.randn((n, m), generator=gen).to(dev)
    cost = (torch.arange(1.0, n + 1) ** 0.5).to(dev)
    return h, w_out, v, cost


def check_mux_score(dev) -> float:
    """K2 against its plain versions: the head form (``mux_head_cuda``
    against ``mux_head_ref``) at ``MUX_HEAD_CASES`` and once with h off
    16-byte alignment, the meta form (``mux_score_cuda`` against
    ``mux_score_ref``) at ``MUX_META_CASES``, each within
    ``F32_MUX_TOL``, and a second call of each form bitwise equal to the
    first.  Returns the largest error."""
    import torch
    from repro_torch.kernels.mux_score import mux_head_cuda, mux_score_cuda
    from repro_torch.kernels.ref import mux_head_ref, mux_score_ref
    gen = torch.Generator().manual_seed(SEED + 20)
    worst = 0.0
    cases = [(c, False) for c in MUX_HEAD_CASES] + [(MUX_SERVED, True)]
    for (b, s, d, m, n, norm), misalign in cases:
        h, w_out, v, cost = mux_inputs(gen, dev, b, s, d, m, n,
                                       misalign=misalign)
        got = mux_head_cuda(h, w_out, v, cost, normalize=norm)
        again = mux_head_cuda(h, w_out, v, cost, normalize=norm)
        torch.cuda.synchronize()
        err = (got - mux_head_ref(h, w_out, v, cost, normalize=norm)
               ).abs().max().item()
        tag = (f"K2 head B={b} S={s} d={d} M={m} N={n} normalize={norm}"
               f"{' h misaligned' if misalign else ''}")
        log(f"{tag} max_err={err:.3e} tol={F32_MUX_TOL:g}")
        check(err <= F32_MUX_TOL, f"{tag}: max_err {err:.3e}")
        check(torch.equal(got, again), f"{tag}: two calls differ")
        worst = max(worst, err)
    for b, m, n, norm in MUX_META_CASES:
        meta = torch.randn((b, m), generator=gen).to(dev)
        v = torch.randn((n, m), generator=gen).to(dev)
        cost = torch.arange(1.0, n + 1).to(dev)
        got = mux_score_cuda(meta, v, cost, normalize=norm)
        again = mux_score_cuda(meta, v, cost, normalize=norm)
        torch.cuda.synchronize()
        err = (got - mux_score_ref(meta, v, cost, normalize=norm)
               ).abs().max().item()
        tag = f"K2 meta B={b} M={m} N={n} normalize={norm}"
        log(f"{tag} max_err={err:.3e} tol={F32_MUX_TOL:g}")
        check(err <= F32_MUX_TOL, f"{tag}: max_err {err:.3e}")
        check(torch.equal(got, again), f"{tag}: two calls differ")
        worst = max(worst, err)
    return worst


def mux_bound_ms(b, s, d, m, n) -> tuple:
    """(bound ms, bound_by) of one head-form call: h, w_out, v and cost
    read once and the weights written once over HBM bandwidth, against
    its fp32 operations (the pool's adds, the projection's FMAs, the dots)
    at the fp32 peak."""
    byts = 4 * (b * s * d + d * m + n * m + n + b * n)
    flops = b * s * d + 2 * b * d * m + 2 * b * n * m + 6 * b * n
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_mux_score(dev) -> dict:
    """K2 at the served probe shape (B=1, S=64, d=128, M=32, N=2,
    normalize=False): the head form eager (``time_cuda``), as a CUDA graph
    (``time_cuda_graph``, the device's time) and the wrapper's host
    microseconds a call; beside it, the same composed plain ops (mean,
    matmul, tanh, ``mux_score_ref``) eager and as a graph (columns, never
    a yardstick), and the meta form eager and as a graph at B=1, M=32,
    N=2.  The operands are 49 KB and stay in L2 (warm), as h does on the
    probe's path, where the trunk has just written it.  No single PyTorch
    call computes the head, so there is no library time."""
    import torch
    from repro_torch.kernels.mux_score import mux_head_cuda, mux_score_cuda
    from repro_torch.kernels.ref import mux_head_ref
    b, s, d, m, n, norm = MUX_SERVED
    h, w_out, v, cost = mux_inputs(torch.Generator().manual_seed(SEED + 21),
                                   dev, b, s, d, m, n)
    meta = torch.tanh(h.mean(1) @ w_out)

    def head(i):
        return mux_head_cuda(h, w_out, v, cost, normalize=norm)

    def plain(i):
        return mux_head_ref(h, w_out, v, cost, normalize=norm)

    def meta_form(i):
        return mux_score_cuda(meta, v, cost, normalize=norm)
    row = {"shape": f"B={b} S={s} d={d} M={m} N={n}",
           "ms": time_cuda(head, iters=1000),
           "graph_ms": time_cuda_graph(head, iters=100),
           "host_us": host_us(head),
           "plain_ms": time_cuda(plain, iters=1000),
           "plain_graph_ms": time_cuda_graph(plain, iters=100),
           "meta_ms": time_cuda(meta_form, iters=1000),
           "meta_graph_ms": time_cuda_graph(meta_form, iters=100)}
    row["bound_ms"], row["bound_by"] = mux_bound_ms(b, s, d, m, n)
    log(f"K2 head form at {row['shape']}: eager {row['ms']:.4f} ms, as a "
        f"CUDA graph {row['graph_ms']:.4f} ms, host {row['host_us']:.1f} us "
        f"a call, bound {row['bound_ms']:.3e} ms ({row['bound_by']}); plain "
        f"ops eager {row['plain_ms']:.4f} ms, as a graph "
        f"{row['plain_graph_ms']:.4f} ms; meta form eager "
        f"{row['meta_ms']:.4f} ms, as a graph {row['meta_graph_ms']:.4f} ms")
    return row


def probe_server(dev, vocab: int = 50_304):
    """A token-probe ``MuxServer`` at the served widths (d_model 128, 2
    layers, meta_dim 32, two models), random weights from a seeded
    generator, with a threshold between its weights on the prompts of
    ``PROBE_SHAPES`` (so ``select`` takes the thresholded path, as the
    zoo's does).  Returns (server, {(B, S): tokens on the device})."""
    import torch
    from repro_torch.core.multiplexer import init_mux, init_token_backbone
    from repro_torch.serving.mux_server import MuxServer, MuxServerConfig
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    backbone = init_token_backbone(gen, meta_dim=32, vocab_size=vocab,
                                   d_model=128, num_layers=2, device=dev)
    mux = init_mux(gen, backbone=backbone, model_names=["small", "large"],
                   costs={"small": 2.4e9, "large": 1.6e10}, meta_dim=32,
                   proj_dim=16, device=dev)
    rng = np.random.default_rng(SEED + 22)
    tokens = {bs: torch.as_tensor(rng.integers(0, vocab, bs).astype(np.int32),
                                  device=dev) for bs in PROBE_SHAPES}
    w = torch.cat([MuxServer(mux, [2.4e9, 1.6e10], device=dev).probe_eager(t)
                   for t in tokens.values()])[:, 0]
    thr = float(w.median())
    return MuxServer(mux, [2.4e9, 1.6e10], MuxServerConfig(threshold=thr),
                     device=dev), tokens


def check_probe_graphs(dev, server, tokens) -> dict:
    """The probe's and select's CUDA graphs against the eager functions
    they capture, at ``PROBE_SHAPES`` in order (the first call of a shape
    captures, the second replays): see :func:`graphed_probe_call`.
    Returns each call's figures, with its wall ms (the capture's is the
    stall the first probe of a new shape pays)."""
    out = {}
    for (b, s), t in tokens.items():
        want_w = server.probe_eager(t)
        want_a = server.select_eager(want_w)
        for call in ("capture", "replay"):
            out[f"B={b} S={s} {call}"] = graphed_probe_call(
                server, t, want_w, want_a, f"probe graph B={b} S={s} ({call})",
                capture=call == "capture")
    return out


def graphed_probe_call(server, t, want_w, want_a, tag, *, capture) -> dict:
    """One graphed probe + select on tokens ``t`` against the eager
    weights ``want_w`` and assignments ``want_a``: weights bitwise equal,
    or within 1e-6 with the reason logged; assignments equal.  K2's
    launches are measured by its wrapper's count: the probe graph's
    capture tallies what its wrappers launched (K2 once, nothing else),
    a first call counts its eager warm-up's K2 and its replay's, a later
    call its replay's alone.  Returns the call's figures."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    before = ops.launches["mux_score"]
    t0 = time.perf_counter()
    w = server.probe_weights(t)
    a = server.select(w)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    k2 = ops.launches["mux_score"] - before
    err = (w - want_w).abs().max().item()
    same = torch.equal(w, want_w)
    held = server._probe_graph.replay_launches(t)
    log(f"{tag}: {call_ms:.3f} ms, weights "
        f"{'bitwise equal' if same else f'max diff {err:.3e}'}, assignments "
        f"{a.tolist()} (eager {want_a.tolist()}), K2 launches {k2}, a replay "
        f"launches {held}")
    if not same:
        log(f"  {tag}: not bitwise: the graph's kernels are those of its "
            f"capture (a library may pick another algorithm under "
            f"capture); held within 1e-6")
    check(err <= 1e-6, f"{tag}: weights differ by {err:.3e}")
    check(torch.equal(a, want_a), f"{tag}: assignments {a.tolist()} != "
          f"eager {want_a.tolist()}")
    check(held == {"mux_score": 1}, f"{tag}: the probe graph's capture "
          f"tallied {held}, not one K2 launch")
    check(server._select_graph.replay_launches(w) == {},
          f"{tag}: the select graph launches a counted kernel")
    check(k2 == (2 if capture else 1), f"{tag}: {k2} K2 launches counted")
    return {"bitwise": same, "max_diff": err, "call_ms": call_ms}


def check_capture_race(dev, zoo) -> dict:
    """A capture racing a prefill: while a backend-style thread runs
    whole-prompt prefills of one 1024-token prompt on the zoo's first
    engine (``transformer.prefill``: K3, cuBLAS, the caching allocator),
    the zoo's server probes ``RACE_LENS`` prompt lengths under 64, each a
    new shape, so each first call captures (thread-local capture) while
    the other thread launches and allocates.  Each graphed probe is held
    as in :func:`check_probe_graphs`; every prefill made during the race
    is held against the same prefill run alone (bitwise, or within
    1e-2 x its largest logit with the difference logged, same argmax).
    Returns the calls' figures (the capture's wall ms under contention)
    and the prefills'."""
    import threading
    import torch
    from repro_torch.models import transformer as tf
    server, eng = zoo["server"], zoo["engines"][0]
    rng = np.random.default_rng(SEED + 23)
    prompt = torch.as_tensor(rng.integers(0, 50_304, (1, 1024)).astype(
        np.int32), device=dev)

    def prefill():
        return tf.prefill(eng.params, eng.cfg, prompt,
                          cache_len=1024)[0].float()
    want = prefill()
    toks = {s: torch.as_tensor(rng.integers(0, 50_304, (1, s)).astype(
        np.int32), device=dev) for s in RACE_LENS}
    eager = {s: server.probe_eager(t) for s, t in toks.items()}
    torch.cuda.synchronize()
    started, stop = threading.Event(), threading.Event()
    got, errors = [], []

    def racer():
        try:
            while not stop.is_set() or len(got) < 2:
                started.set()
                out = prefill()
                torch.cuda.current_stream().synchronize()
                got.append(out)
        except BaseException as e:       # reported by the main thread
            errors.append(e)
            started.set()

    th = threading.Thread(target=racer, name="prefill-racer")
    th.start()
    started.wait()
    calls = {}
    try:
        for s, t in toks.items():
            w = eager[s]
            calls[f"B=1 S={s} capture"] = graphed_probe_call(
                server, t, w, server.select_eager(w),
                f"capture race B=1 S={s} (capture)", capture=True)
    finally:
        stop.set()
        th.join()
    check(not errors, f"capture race: the prefill thread raised "
          f"{errors[0]!r}" if errors else "")
    diffs = [(g - want).abs().max().item() for g in got]
    bitwise = sum(torch.equal(g, want) for g in got)
    scale = want.abs().max().item()
    log(f"capture race: {len(got)} prefills on the other thread, {bitwise} "
        f"bitwise equal to the lone prefill, max diff {max(diffs):.3e} "
        f"(largest logit {scale:.3e})")
    for g, d in zip(got, diffs):
        check(bool(torch.isfinite(g).all()) and d <= 1e-2 * scale
              and torch.equal(g.argmax(-1), want.argmax(-1)),
              f"capture race: a prefill differs by {d:.3e} from the lone "
              f"prefill")
    for s, t in toks.items():
        w = eager[s]
        calls[f"B=1 S={s} replay"] = graphed_probe_call(
            server, t, w, server.select_eager(w),
            f"capture race B=1 S={s} (replay)", capture=False)
    return {"calls": calls, "prefills": len(got),
            "prefills_bitwise": bitwise, "prefill_max_diff": max(diffs)}


def time_probe(dev, server, tokens) -> dict:
    """The whole probe (weights + select) at B=1, S=64, eager
    (``probe_eager`` + ``select_eager``) against graphed
    (``probe_weights`` + ``select``, one replay of each graph, the
    tokens already on the card): ms a call by CUDA events (the stream's
    time, host gaps included), host microseconds a call, and from
    ``torch.profiler`` over 20 calls the device's busy ms and its kernel
    and copy launches a probe."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t = tokens[(1, 64)]
    fns = {"eager": lambda i: server.select_eager(server.probe_eager(t)),
           "graph": lambda i: server.select(server.probe_weights(t))}
    rows = {}
    for name, fn in fns.items():
        row = {"ms": time_cuda(fn, iters=200), "host_us": host_us(fn)}
        for i in range(3):
            fn(i)
        torch.cuda.synchronize()
        calls = 20
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(i)
            torch.cuda.synchronize()
        dev_rows = _device_rows(prof)
        k2_rows = sum(c for _, c, k in dev_rows if "mux_score_kernel" in k)
        check(k2_rows == calls, f"probe {name}: the profile shows "
              f"{k2_rows} K2 launches in {calls} probes")
        row["device_busy_ms"] = sum(r[0] for r in dev_rows) / calls
        row["launches"] = sum(r[1] for r in dev_rows) / calls
        row["top"] = [[round(ms / calls, 5), c // calls, k]
                      for ms, c, k in dev_rows[:6]]
        log(f"probe {name} at B=1 S=64: {row['ms']:.4f} ms a call (events), "
            f"host {row['host_us']:.1f} us, device busy "
            f"{row['device_busy_ms']:.4f} ms, {row['launches']:g} device "
            f"launches a probe; top {row['top']}")
        rows[name] = row
    return rows


def flash_inputs(gen, dev, b, s, t, h, kk, hd, vd, dtype):
    """Random q (B, S, H, hd), k (B, T, K, hd), v (B, T, K, vd) drawn on
    the CPU from ``gen``."""
    import torch
    return [torch.randn(shape, generator=gen).to(dtype).to(dev)
            for shape in ((b, s, h, hd), (b, t, kk, hd), (b, t, kk, vd))]


# (b, s, t, h, kk, hd, vd, window, chunk, cap)
FLASH_CASES = {
    # tests/test_kernels.py's sweep
    "sweep gqa": (2, 128, 128, 4, 2, 64, 64, None, None, None),
    "sweep window": (1, 256, 256, 4, 4, 64, 64, 64, None, None),
    "sweep mqa+cap": (2, 96, 96, 4, 1, 32, 32, None, None, 50.0),
    "sweep chunk": (1, 256, 256, 8, 2, 64, 64, None, 96, None),
    "sweep kv>q vd<hd": (2, 64, 192, 4, 2, 64, 32, None, None, None),
    # GQA groups with S and T off the 64-row / 32-key tiles
    "g=1 off-tile": (1, 100, 100, 16, 16, 128, 128, None, None, None),
    "g=2 off-tile": (2, 77, 150, 16, 8, 128, 128, None, None, None),
    "g=4 off-tile": (1, 130, 130, 16, 4, 128, 128, None, None, None),
    "g=8 off-tile": (1, 201, 233, 16, 2, 128, 96, None, None, None),
    "g=8 hd=256": (1, 70, 70, 8, 1, 256, 256, None, None, None),
    # rows fully masked inside the first live tile
    "window masked rows": (1, 128, 128, 4, 1, 32, 32, 8, None, None),
    "chunk masked rows": (1, 200, 200, 4, 2, 64, 64, None, 40, None),
    # hd < vd: the tensor-core variant pads both to 128, so K's second
    # 64-column chunk lies wholly outside k and TMA fills it with zeros
    "hd<vd": (1, 96, 96, 4, 2, 64, 128, None, None, None),
    # the last q tile walks 5 key tiles: the 2-stage ring wraps oddly
    "odd key tiles": (1, 320, 320, 2, 2, 128, 128, None, None, None),
    # one visible key per row, S off the tiles, g = 2: P is the identity
    # and out = V exactly
    "one key per row": (1, 130, 130, 4, 2, 128, 128, 1, None, None),
}
# cases also run without the causal rule (every row sees every key)
FLASH_NONCAUSAL = ("sweep gqa", "sweep kv>q vd<hd")
# the page-padded prompt lengths of the served trace, B=1, bf16
FLASH_SERVED = [(1, s, s, h, h, 128, 128, None, None, None)
                for h in (16, 32) for s in (128, 448, 1024)]
# minicpm3-4b's whole-prompt prefill: MLA expanded to 40 heads of q/k
# width d_nope + d_rope = 96 and v width 64 (the wgmma variant pads both
# to 128)
FLASH_MLA = [(1, s, s, 40, 40, 96, 64, None, None, None)
             for s in (128, 448, 1024)]


def check_flash_attention(dev) -> float:
    """K3 against its plain version over the cases above (fp32: the
    SIMT variant, bf16: the tensor-core variant; the causal rule, and
    without it for ``FLASH_NONCAUSAL``) and the served shapes (bf16).
    Every bf16 element is also held to ``BF16_FLASH_REL`` beside its
    plain value, which a kernel that drops or repeats one key tile of a
    long row fails.  With one visible key per row the output must be
    that key's V row, bit for bit.  Each call counts one launch, under
    the variant the plan names, in a counter of its own (not the main
    path's).  Returns the max error."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     flash_plan,
                                                     wgmma_block_k)
    gen = torch.Generator().manual_seed(SEED)
    dtypes = (torch.float32, torch.bfloat16)
    cases = [(n, c, d, True) for n, c in FLASH_CASES.items() for d in dtypes]
    cases += [(f"{n} non-causal", FLASH_CASES[n], d, False)
              for n in FLASH_NONCAUSAL for d in dtypes]
    cases += [(f"served H={c[3]} S={c[1]}", c, torch.bfloat16, True)
              for c in FLASH_SERVED]
    cases += [(f"MLA H=40 S={c[1]} 96/64", c, torch.bfloat16, True)
              for c in FLASH_MLA]
    # the odd case's last q tile sees keys 0 .. S-1 (no window or chunk)
    s_odd = FLASH_CASES["odd key tiles"][1]
    odd_walk = (s_odd - 1) // wgmma_block_k() + 1
    check(odd_walk % 2 == 1 and odd_walk > 2,
          f"K3 odd key tiles: the last q tile walks {odd_walk} key tiles, "
          f"not an odd number above the ring's 2 stages")
    rel_abs, rel = BF16_FLASH_REL
    worst = 0.0
    for name, case, dtype, causal in cases:
        b, s, t, h, kk, hd, vd, window, chunk, cap = case
        q, k, v = flash_inputs(gen, dev, b, s, t, h, kk, hd, vd, dtype)
        kw = dict(causal=causal, window=window, chunk=chunk, logit_cap=cap)
        plan = flash_plan(q.shape, k.shape, v.shape, dtype, causal=causal,
                          window=window, chunk=chunk)
        check(plan.variant == ("simt" if dtype == torch.float32 else "wgmma"),
              f"K3 {name}: {dtype} planned on the {plan.variant} variant")
        counts = {"flash_attention": 0, "flash_attention_wgmma": 0,
                  "flash_attention_simt": 0}
        got = flash_attention_cuda(q, k, v, counts=counts, **kw)
        torch.cuda.synchronize()
        check(counts["flash_attention"] == 1
              and counts["flash_attention_" + plan.variant] == 1
              and sum(counts.values()) == 2,
              f"K3 {name}: the wrapper counted {counts}, not one launch "
              f"of the {plan.variant} variant")
        want = flash_attention_plain(q, k, v, **kw)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        tol = F32_FLASH_TOL if dtype == torch.float32 else BF16_TOL
        dname = "float32" if dtype == torch.float32 else "bf16"
        ratio = (diff / (rel_abs + rel * want.float().abs())).max().item()
        log(f"K3 {name:24s} {dname:7s} {plan.variant:5s} max_err={err:.3e} "
            f"tol={tol:g}" + (f" rel_ratio={ratio:.3f}"
                              if dtype == torch.bfloat16 else ""))
        check(err <= tol, f"K3 {name} {dname}: max_err {err:.3e} > {tol:g}")
        if dtype == torch.bfloat16:
            check(ratio <= 1.0,
                  f"K3 {name} bf16: an element is {ratio:.3f}x its limit "
                  f"{rel_abs:g} + {rel:g} |plain|")
        if window == 1:
            check(s == t and torch.equal(got, v.repeat_interleave(h // kk,
                                                                  dim=2)),
                  f"K3 {name} {dname}: one visible key per row, but the "
                  f"output is not that key's V row")
        worst = max(worst, err)
    return worst


def flash_bound_ms(s, t, h, kk, hd, vd, elem) -> tuple:
    """(bound ms, bound_by) of one causal K3 call with S == T and no
    window: q, k, v and out moved once over HBM bandwidth; 2*(hd+vd)
    FLOPs per (query head, visible key) — the live causal half,
    S*(S+1)/2 pairs — over the bf16 tensor-core rate."""
    byts = elem * (s * h * hd + t * kk * (hd + vd) + s * h * vd)
    flops = 2 * (hd + vd) * h * (s * (s + 1) // 2)
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k3_timed(copies, kw, *, iters: int, plain_iters: int,
             reps: int = 5) -> dict:
    """K3 with ``kw`` over the rotated input ``copies``: eager
    (``time_cuda``, ``iters`` calls), the same calls captured in one
    CUDA graph replayed ``reps`` times (an extra column), and the plain
    version."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    n = len(copies)

    def kernel(i):
        return flash_attention_cuda(*copies[i % n], **kw)
    return {"ms": time_cuda(kernel, iters=iters),
            "graph_ms": time_cuda_graph(kernel, iters=iters, reps=reps),
            "plain_ms": time_cuda(lambda i: flash_attention_plain(
                *copies[i % n], **kw), iters=plain_iters, warmup=1)}


def time_flash_attention(dev) -> dict:
    """K3 at every served prefill shape (``FLASH_SERVED``: B=1, S=T in
    {128, 448, 1024}, H=K in {16, 32}, hd 128, bf16, causal: the
    tensor-core variant; ``FLASH_MLA``: minicpm3-4b's expanded MLA
    prefill, H=K=40, hd 96, vd 64) beside its bound, its plain version and one
    library call (``scaled_dot_product_attention(is_causal=True)``,
    where S == T makes its bottom-right causal rule equal the kernel's
    top-left one; timed here only, never on the port's path).  ``ms``
    and ``library_ms`` are ``time_cuda`` times (CUDA events around calls
    made one after another from Python, the method of every earlier
    row); ``graph_ms`` and ``library_graph_ms`` time the same calls
    captured in a CUDA graph, an extra column.  Enough input copies
    rotate (at least 3, at least 150 MB) that the L2 does not hold the
    next call's operands.  At the largest shape (codeqwen1.5-7b, S =
    1024, H = 32) also the model's ``blocked_attention`` on the card
    (what the whole-prompt prefill ran before K3; not a plain version
    of the kernel, which scales q in fp32) and the SIMT variant on fp32
    copies of the same inputs; at the smallest, the wrapper's host
    microseconds per call for each variant.  The kernel's and the plain
    version's times come from :func:`k3_timed`.  Returns the largest
    MHA shape's numbers, a row per MHA shape and a row per MLA shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.attention import blocked_attention
    gen = torch.Generator().manual_seed(SEED + 7)
    rows = []
    for b, s, t, h, kk, hd, vd, *_ in FLASH_SERVED + FLASH_MLA:
        copy_bytes = 2 * (s * h * hd + t * kk * (hd + vd) + s * h * vd)
        n = max(3, -(-150_000_000 // copy_bytes))
        copies = [flash_inputs(gen, dev, b, s, t, h, kk, hd, vd,
                               torch.bfloat16) for _ in range(n)]
        heads_first = [[x.transpose(1, 2) for x in c] for c in copies]

        def kernel(i):
            return flash_attention_cuda(*copies[i % n])

        def sdpa(i):
            return F.scaled_dot_product_attention(*heads_first[i % n],
                                                  is_causal=True)
        iters = max(50, 2 * n)
        row = {"S": s, "H": h, "hd": hd, "vd": vd, "copies": n,
               **k3_timed(copies, {}, iters=iters, plain_iters=10),
               "library_ms": time_cuda(sdpa, iters=iters),
               "library_graph_ms": time_cuda_graph(sdpa, iters=iters)}
        row["bound_ms"], row["bound_by"] = flash_bound_ms(s, t, h, kk, hd,
                                                          vd, 2)
        row["sdpa_vs_kernel_max_abs"] = (
            sdpa(0).transpose(1, 2).float() - kernel(0).float()
        ).abs().max().item()
        log(f"K3 time at B=1 S=T={s} H={h} hd={hd} vd={vd} bf16 (wgmma): "
            f"kernel {row['ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms "
            f"({row['ms'] / row['library_ms']:.2f}x); as CUDA graphs "
            f"{row['graph_ms']:.4f} / {row['library_graph_ms']:.4f} ms; "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); plain "
            f"{row['plain_ms']:.4f} ms; |sdpa - kernel| "
            f"{row['sdpa_vs_kernel_max_abs']:.3e}")
        if not rows:                # the smallest shape: the host's share
            fp32 = [[x.float() for x in c] for c in copies]
            row["host_us_wgmma"] = host_us(kernel)
            row["host_us_simt"] = host_us(
                lambda i: flash_attention_cuda(*fp32[i % n]))
            log(f"K3 wrapper host time per call at S=T={s} H={h}: wgmma "
                f"(bf16) {row['host_us_wgmma']:.1f} us, SIMT (fp32) "
                f"{row['host_us_simt']:.1f} us")
        rows.append(row)
    mla_rows = rows[len(FLASH_SERVED):]
    rows = rows[:len(FLASH_SERVED)]
    big = rows[-1]
    b, s, t, h, kk, hd, vd, *_ = FLASH_SERVED[-1]
    copies = [flash_inputs(gen, dev, b, s, t, h, kk, hd, vd, torch.bfloat16)
              for _ in range(3)]
    big["blocked_attention_ms"] = time_cuda(
        lambda i: blocked_attention(*copies[i % 3]), iters=10)
    fp32 = [[x.float() for x in c] for c in copies]
    big["simt_fp32_ms"] = time_cuda(
        lambda i: flash_attention_cuda(*fp32[i % 3]), iters=10)
    log(f"K3 at S=T={s} H={h}: blocked_attention "
        f"{big['blocked_attention_ms']:.4f} ms; SIMT variant on fp32 "
        f"copies {big['simt_fp32_ms']:.4f} ms")
    return {**{k: big[k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by")},
            "shapes": rows, "mla_shapes": mla_rows}


# K3 at gemma2-27b's whole-prompt prefill: a 5100-token prompt padded to
# page 64, 32 query heads over 16 KV heads of 128, logit cap 50 at query
# scale 144^-1/2, with the swa layers' window of 4096 and without (the
# full layers)
G2_K3 = (1, 5120, 5120, 32, 16, 128, 128)
COMPILE_CACHE = Path(__file__).resolve().parent / "build" / "torch_compile"


def visible_pairs(s: int, window=None) -> int:
    """(query, key) pairs a causal S == T prefill attends, under a
    sliding window of ``window`` keys where given."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flex_softcap(copies, *, window, logit_cap, scale):
    """The library call beside K3 at gemma2's prefill: torch's
    ``flex_attention`` compiled once for this mask (timed here only,
    never on the port's path) with a tanh softcap ``score_mod``, a
    causal block mask (with the sliding window where given) and grouped
    query heads, on heads-first copies of ``copies``.  Its compile
    caches go under ``build/`` and compile in this process.  Returns
    ``fn(i)``, copy ``i``'s output as (B, H, S, vd)."""
    import os
    import torch
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(COMPILE_CACHE / sub))
    inductor_config.compile_threads = 1
    q0, k0, _ = copies[0]

    def visible(b, h, q, kv):
        causal = q >= kv
        return causal & (q - kv < window) if window else causal

    def softcap(score, b, h, q, kv):
        return torch.tanh(score / logit_cap) * logit_cap
    mask = create_block_mask(visible, None, None, q0.shape[1], k0.shape[1],
                             device=q0.device)
    flex = torch.compile(flex_attention, dynamic=False)
    heads_first = [[x.transpose(1, 2).contiguous() for x in c]
                   for c in copies]
    n = len(copies)

    def library(i):
        return flex(*heads_first[i % n], score_mod=softcap, block_mask=mask,
                    scale=scale, enable_gqa=True)
    return library


def gemma2_flash(dev) -> list:
    """K3 at gemma2-27b's prefill shape (``G2_K3``), with the window and
    without: against its plain version (2e-2, per element
    ``BF16_FLASH_REL`` and per output vector ``BF16_ROW_REL_L2``), one
    launch of the tensor-core variant each, the windowed output
    differing from the full one on the rows past the window; then timed
    (:func:`k3_timed`: eager, as a CUDA graph and the plain version)
    beside the bound (2*(hd+vd) FLOPs per (query head, visible pair)
    over the bf16 rate, or q, k, v and out once over HBM) and the
    library call :func:`flex_softcap` (its output held to the plain
    version within 2e-2 first).  With the window, on q scaled by
    ``G2_CAP_Q_GAIN`` so that the cap binds: against the plain version
    per output vector, and differing from the call without the cap (the
    worst output vector's relative L2) by 10x that error (the cap is
    applied).  Returns a row per mask."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    gen = torch.Generator().manual_seed(SEED + 28)
    b, s, t, h, kk, hd, vd = G2_K3
    copy_bytes = 2 * (s * h * hd + t * kk * (hd + vd) + s * h * vd)
    n = max(3, -(-150_000_000 // copy_bytes))
    copies = [flash_inputs(gen, dev, b, s, t, h, kk, hd, vd, torch.bfloat16)
              for _ in range(n)]
    rows, outs = [], {}
    for window in (4096, None):
        kw = dict(window=window, logit_cap=G2_ATTN["logit_cap"],
                  scale=G2_ATTN["scale"])
        counts = {"flash_attention": 0, "flash_attention_wgmma": 0,
                  "flash_attention_simt": 0}
        got = flash_attention_cuda(*copies[0], counts=counts, **kw)
        torch.cuda.synchronize()
        want = flash_attention_plain(*copies[0], **kw)
        errs = bf16_errors(got, want)
        late_err = (got[:, 4096:].float() - want[:, 4096:].float()
                    ).abs().max().item()     # the rows past the window
        library = flex_softcap(copies, **kw)
        lib_errs = bf16_errors(library(0).transpose(1, 2), want)
        del want
        outs[window] = got
        tag = f"window={window}" if window else "full"
        check(counts == {"flash_attention": 1, "flash_attention_wgmma": 1,
                         "flash_attention_simt": 0},
              f"K3 gemma2 {tag}: the wrapper counted {counts}")
        check(errs["max_abs_err"] <= BF16_TOL and errs["rel_ratio"] <= 1.0
              and errs["row_rel_l2"] <= BF16_ROW_REL_L2,
              f"K3 gemma2 {tag}: {errs}")
        check(lib_errs["max_abs_err"] <= BF16_TOL,
              f"K3 gemma2 {tag}: flex_attention is "
              f"{lib_errs['max_abs_err']:.3e} off the plain version: not "
              f"the kernel's function")
        pairs = visible_pairs(s, window)
        t_ops = 2 * (hd + vd) * h * pairs / BF16_FLOPS * 1e3
        t_bytes = copy_bytes / HBM_BYTES_PER_S * 1e3
        row = {"S": s, "H": h, "K": kk, "hd": hd, "window": window,
               "logit_cap": kw["logit_cap"], "copies": n, **errs,
               "max_abs_err_past_4096": late_err,
               "visible_pairs": pairs,
               **k3_timed(copies, kw, iters=30, plain_iters=2, reps=3),
               "bytes_ms": t_bytes, "ops_ms": t_ops,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": time_cuda(library, iters=30),
               "library": "flex_attention (compiled; softcap score_mod, "
                          "causal" + (" + window" if window else "")
                          + " block mask, enable_gqa)",
               "library_errs": lib_errs}
        del library
        log(f"K3 gemma2 B=1 S=T={s} H={h} K={kk} hd={hd} cap 50 {tag}: "
            f"max_err={errs['max_abs_err']:.3e} rel_ratio="
            f"{errs['rel_ratio']:.3f} row_rel_l2={errs['row_rel_l2']:.3e}; "
            f"kernel {row['ms']:.4f} ms, as a CUDA graph "
            f"{row['graph_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}, {pairs / 1e6:.2f} M pairs), plain "
            f"{row['plain_ms']:.4f} ms, flex_attention "
            f"{row['library_ms']:.4f} ms ({row['ms'] / row['library_ms']:.2f}"
            f"x; max_err {lib_errs['max_abs_err']:.3e}, row_rel_l2 "
            f"{lib_errs['row_rel_l2']:.3e})")
        rows.append(row)
    masked = (outs[4096][:, 4096:].float() - outs[None][:, 4096:].float()
              ).abs().max().item()
    early = (outs[4096][:, :4096].float() - outs[None][:, :4096].float()
             ).abs().max().item()
    log(f"K3 gemma2: rows past 4096 with vs without the window differ by "
        f"{masked:.3e}, rows below it by {early:.3e}")
    check(masked > 10 * rows[0]["max_abs_err_past_4096"]
          and early <= BF16_TOL,
          f"K3 gemma2: the window does not mask the rows past it "
          f"({masked:.3e}) or changes rows below it ({early:.3e})")
    del outs
    kw = dict(window=4096, logit_cap=G2_ATTN["logit_cap"],
              scale=G2_ATTN["scale"])
    hot = [copies[0][0] * G2_CAP_Q_GAIN, *copies[0][1:]]
    capped = flash_attention_cuda(*hot, **kw)
    uncapped = flash_attention_cuda(*hot, **{**kw, "logit_cap": None})
    cap_errs = bf16_errors(capped, flash_attention_plain(*hot, **kw))
    caps = bf16_errors(uncapped, capped)["row_rel_l2"]
    log(f"K3 gemma2 window=4096, q x {G2_CAP_Q_GAIN:g}: max_err="
        f"{cap_errs['max_abs_err']:.3e} rel_ratio={cap_errs['rel_ratio']:.3f}"
        f" row_rel_l2={cap_errs['row_rel_l2']:.3e} tol={BF16_ROW_REL_L2:g}; "
        f"with vs without the cap (row_rel_l2) {caps:.3e}")
    check(cap_errs["row_rel_l2"] <= BF16_ROW_REL_L2,
          f"K3 gemma2, q x {G2_CAP_Q_GAIN:g}: {cap_errs}")
    check(caps > 10 * cap_errs["row_rel_l2"], f"K3 gemma2, q x "
          f"{G2_CAP_Q_GAIN:g}: the output with and without the cap differs "
          f"by {caps:.3e} of its norm, not 10x its error "
          f"{cap_errs['row_rel_l2']:.3e}: the cap is not applied")
    rows[0]["cap_bound"] = {"q_gain": G2_CAP_Q_GAIN, **cap_errs,
                            "capped_vs_uncapped": caps}
    return rows


def tiny_mla_config():
    """minicpm3-4b's MLA widths (40 heads, kv_lora 256 + d_rope 32, value
    heads of 64) in a 2-layer fp32 model of d_model 128: K1's latent
    form runs its wide instantiation in fp32 with five head tiles."""
    import math
    from repro_torch.configs import get_config
    return get_config("minicpm3-4b").with_(
        name="tiny-mla-check", num_layers=2, d_model=128, d_ff=256,
        vocab_size=128, q_lora=64, residual_scale=1.4 / math.sqrt(2),
        compute_dtype="float32", param_dtype="float32",
        kv_cache_dtype="float32")


def tiny_moe_config():
    """olmoe-1b-7b's blocks (qk-norm, an MoE MLP under softmax-then-top-k
    routing) in a 2-layer fp32 model of d_model 64 with 4 experts, top-2:
    an 8-token prefill routes 16 assignments into buckets of
    C = int(1.25 * 8 * 2 / 4) = 5, so capacity drops there, and decode
    is dropless."""
    from repro_torch.configs import get_config
    return get_config("olmoe-1b-7b").with_(
        name="tiny-moe-check", num_layers=2, d_model=64, d_ff=64,
        vocab_size=128, num_heads=4, num_kv_heads=4, head_dim=16,
        num_experts=4, num_experts_per_tok=2, moe_d_ff=64,
        compute_dtype="float32", param_dtype="float32",
        kv_cache_dtype="float32")


def window_layers(cfg) -> int:
    """Layers that attend through a sliding window (K1 / K3 count their
    launches under ``*_window``)."""
    return cfg.num_groups * sum(
        spec.mixer == "attn" and spec.attn_kind == "swa"
        and cfg.window is not None for spec in cfg.pattern)


def check_model_against_cpu(dev, cfg=None) -> float:
    """A tiny fp32 model (GQA g = 2 with a window layer, or ``cfg``: the
    MLA one of :func:`tiny_mla_config`, the MoE one of
    :func:`tiny_moe_config`): prefill (through K3's SIMT variant on the
    card) + teacher-forced paged decode (through K1; an MLA layer's
    through its latent form) on the card, against the same weights on
    the CPU (plain path).  Returns the max logit difference."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    cfg = cfg or tiny_gqa_config()
    params = tf.init_params(cfg, torch.Generator().manual_seed(SEED),
                            device="cpu")
    gparams = _to_device(params, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(SEED))
    bt = torch.arange(1, 11, dtype=torch.int32).reshape(2, 5)
    runs = {}
    for p, d in ((params, torch.device("cpu")), (gparams, dev)):
        ops.reset_launches()
        caches = tf.init_caches(cfg, num_pages=11, page_size=4, device=d)
        logits = [tf.prefill_paged(p, cfg, toks[:, :8].to(d), caches,
                                   bt.to(d))[0]]
        for i in range(8, 20):
            pos = torch.tensor([i, i], device=d)
            logits.append(tf.decode_step(p, cfg, toks[:, i:i + 1].to(d),
                                         caches, pos,
                                         block_tables=bt.to(d))[0])
        runs[d.type] = torch.cat([x.float().cpu() for x in logits], 1)
    worst = (runs["cpu"] - runs["cuda"]).abs().max().item()
    log(f"{cfg.name} on the card vs CPU: max logit diff {worst:.3e} "
        f"tol={MODEL_TOL:g}; card launches {ops.launches}")
    check(worst <= MODEL_TOL, f"{cfg.name} card vs CPU: {worst:.3e}")
    mla = sum(spec.mixer == "mla" for spec in cfg.pattern) * cfg.num_groups
    check(ops.launches["paged_attention_latent"] == mla * 12,
          f"{cfg.name}: K1's latent form launched "
          f"{ops.launches['paged_attention_latent']} times for 12 decode "
          f"steps of {mla} MLA layers")
    check(ops.launches["flash_attention"] == cfg.num_layers
          == ops.launches["flash_attention_simt"],
          f"tiny model: flash_attention launched "
          f"{ops.launches['flash_attention']} times "
          f"({ops.launches['flash_attention_simt']} on the SIMT variant) for "
          f"one fp32 prefill of {cfg.num_layers} layers")
    check(ops.launches["paged_attention"] == cfg.num_layers * 12,
          f"tiny model: paged_attention launched "
          f"{ops.launches['paged_attention']} times for 12 decode steps")
    swa = window_layers(cfg)
    check(ops.launches["paged_attention_window"] == swa * 12
          and ops.launches["flash_attention_window"] == swa,
          f"{cfg.name}: {ops.launches['flash_attention_window']} windowed "
          f"K3 and {ops.launches['paged_attention_window']} windowed K1 "
          f"launches for one prefill and 12 steps of {swa} swa layers")
    return worst


def scan_inputs(gen, dev, b, s, d, n, x_dtype, h0=False):
    """Random K4 operands drawn on the CPU from ``gen`` (distributed as
    in the JAX sweep: dt = softplus(N(0,1)), A = -exp(N(0,1)/2)); x in
    ``x_dtype``, the rest fp32."""
    import torch
    import torch.nn.functional as F
    out = [torch.randn((b, s, d), generator=gen).to(x_dtype),
           F.softplus(torch.randn((b, s, d), generator=gen)),
           torch.randn((b, s, n), generator=gen),
           torch.randn((b, s, n), generator=gen),
           -torch.exp(torch.randn((d, n), generator=gen) * 0.5),
           torch.randn((d,), generator=gen)]
    if h0:
        out.append(torch.randn((b, d, n), generator=gen))
    return [t.to(dev) for t in out]


def scan_err(got, want) -> tuple:
    """(max abs error, whether every element is within SCAN_ATOL +
    SCAN_RTOL * |want|)."""
    diff = (got - want).abs()
    ok = bool((diff <= SCAN_ATOL + SCAN_RTOL * want.abs()).all())
    return diff.max().item() if diff.numel() else 0.0, ok


# (b, s, d_in, n)
SCAN_CASES = {
    # tests/test_kernels.py's sweep
    "sweep 1": (2, 128, 64, 16),
    "sweep 2": (1, 256, 128, 8),
    "sweep 3": (2, 64, 32, 4),
    # S and d_in off every tile (16-64 steps, 64 / lanes channels); d_in
    # 129, 300 and 1001 defeat 16-byte copies of bf16 x rows, 129 and
    # 1001 those of fp32 rows too
    "off-tile n=16": (1, 1000, 200, 16),
    "off-tile n=8": (2, 77, 300, 8),
    "off-tile n=5": (3, 33, 129, 5),
    "n=64": (1, 100, 72, 64),
    "d_in=1001 n=12": (1, 300, 1001, 12),
    "S=3 n=1": (2, 3, 40, 1),
    "S=1": (2, 1, 8192, 16),
    "S=0": (2, 0, 256, 16),
    # a long sequence: 64 tiles through each block's ring
    "4096 steps": (1, 4096, 256, 16),
}
SCAN_SERVED = (2, 1024, 8192, 16)      # falcon-mamba-7b prefill, phase 6
SCAN_SERVED_B1 = (1, 1024, 8192, 16)   # one request (launch/serve --batch 1)


def check_selective_scan(dev) -> float:
    """K4 against its plain version: the cases above and the served
    shapes at B=2 and B=1, with fp32 and bf16 x (served: bf16), zero
    and random start states, h0 chaining (the two halves of a sequence,
    the second from the first's h_final, equal one scan of the whole),
    and two calls bitwise equal.  Returns the max error."""
    import torch
    from repro_torch.kernels.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    gen = torch.Generator().manual_seed(SEED)
    worst = 0.0

    def held(name, got, want):
        nonlocal worst
        for part, g, w in zip(("y", "h_final"), got, want):
            check(g.shape == w.shape and bool(torch.isfinite(g).all()),
                  f"K4 {name} {part}: shape {tuple(g.shape)} vs "
                  f"{tuple(w.shape)}, or not finite")
            err, ok = scan_err(g, w)
            log(f"K4 {name:36s} {part:7s} max_err={err:.3e} "
                f"tol={SCAN_ATOL:g}+{SCAN_RTOL:g}|want|")
            check(ok, f"K4 {name} {part}: max_err {err:.3e} off tolerance")
            worst = max(worst, err)

    def twice(name, *args):
        got = selective_scan_cuda(*args)
        again = selective_scan_cuda(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"K4 {name}: two calls differ")
        return got

    cases = [(f"{n_} {d_}", c, dt) for n_, c in SCAN_CASES.items()
             for d_, dt in (("float32", torch.float32),
                            ("bf16", torch.bfloat16))]
    cases += [("served bf16", SCAN_SERVED, torch.bfloat16),
              ("served B=1 bf16", SCAN_SERVED_B1, torch.bfloat16)]
    for name, (b, s, d, n), x_dtype in cases:
        inp = scan_inputs(gen, dev, b, s, d, n, x_dtype, h0=True)
        held(name, twice(name, *inp[:6]), selective_scan_ref(*inp[:6]))
        # a random start state
        held(name + " h0", twice(name + " h0", *inp),
             selective_scan_ref(*inp))
        if s < 64:
            continue
        x, dt, bm, cm, a, dv, _ = inp
        cut = s // 2 + 3
        y1, h1 = selective_scan_cuda(x[:, :cut].contiguous(),
                                     dt[:, :cut].contiguous(),
                                     bm[:, :cut].contiguous(),
                                     cm[:, :cut].contiguous(), a, dv)
        y2, h2 = selective_scan_cuda(x[:, cut:].contiguous(),
                                     dt[:, cut:].contiguous(),
                                     bm[:, cut:].contiguous(),
                                     cm[:, cut:].contiguous(), a, dv, h1)
        torch.cuda.synchronize()
        held(name + " chained", (torch.cat([y1, y2], 1), h2),
             selective_scan_ref(*inp[:6]))
    return worst


def check_scan_resources() -> dict:
    """K4's ptxas resources from the build log: every instantiation of
    ``selective_scan_kernel`` (x dtype x lanes a channel) is logged, the
    served one (bf16 x, n = 16 on 2 lanes:
    ``selective_scan_kernel<__nv_bfloat16, 2>``) must be there, and none
    may spill."""
    found = ptxas_entries("selective_scan", "selective_scan_kernel")
    for key, text in found.items():
        log(f"  selective_scan {key}: {text}")
    served = [k for k in found
              if "selective_scan_kernelI13__nv_bfloat16Li2EE" in k]
    check(len(served) == 1, f"no single ptxas entry for K4's served "
          f"instantiation in the build log: {sorted(found)}")
    spills = {k: v for k, v in found.items()
              if "0 bytes spill stores, 0 bytes spill loads" not in v}
    check(not spills, f"K4 spills: {spills}")
    log(f"  selective_scan served kernel (bf16 x, 2 lanes): "
        f"{found[served[0]]} ({len(found)} instantiations, none spills)")
    return {"served": found[served[0]], "instantiations": len(found)}


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def scan_bound_ms(inp, h0: bool = False) -> tuple:
    """(bound ms, bound_by) of one K4 call on these inputs: x, dt, B, C,
    A, D (and h0) read once and y, h_final written once, over HBM
    bandwidth; against the larger of one exponential per (t, d, n) at
    the SFU rate (16 a clock per SM at the card's maximum SM clock) and
    3 fp32 FMAs per (t, d, n) at the fp32 peak."""
    import torch
    x, dt, bm, cm, a, dv = inp[:6]
    b, s, d = x.shape
    n = bm.shape[-1]
    byts = sum(t.numel() * t.element_size() for t in (x, dt, bm, cm))
    byts += 4 * (a.numel() + dv.numel() + b * s * d + b * d * n * (1 + h0))
    steps = b * s * d * n
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_exp = steps / (SFU_EXP_PER_CLOCK_PER_SM * sms * sm_clock_hz()) * 1e3
    t_fma = 2 * 3 * steps / FP32_FLOPS * 1e3
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = max(t_exp, t_fma)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_selective_scan(dev) -> dict:
    """K4 at the served prefill shape of falcon-mamba-7b (B=2, S=1024,
    d_in=8192, n=16, bf16 x, fp32 dt/B/C, a start state h0, as
    ``mamba_forward`` passes ``cache["h"]``) and at B=1 (one request):
    the eager time (``time_cuda``, CUDA events, the method of every
    earlier row), the same calls captured in a CUDA graph
    (``time_cuda_graph``: the device's time, and proof that K4
    captures), the bound, the plain version and the wrapper's host
    microseconds a call.  No single PyTorch call computes a selective
    scan, so there is no library time.  Input copies (~100 / ~50 MB
    each) rotate so the L2 does not hold the next call's operands.
    Calls only ``selective_scan_cuda(x, dt, B, C, A, D, h0)``, so it
    also times a parent's K4 in the same call.  Returns B=2's numbers
    and a row per shape."""
    import torch
    from repro_torch.kernels.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    gen = torch.Generator().manual_seed(SEED + 9)
    rows = []
    for name, shape, n_copies in (("B=2", SCAN_SERVED, 2),
                                  ("B=1", SCAN_SERVED_B1, 3)):
        copies = [scan_inputs(gen, dev, *shape, torch.bfloat16, h0=True)
                  for _ in range(n_copies)]

        def kernel(i):
            return selective_scan_cuda(*copies[i % n_copies])
        row = {"shape": name, "copies": n_copies,
               "ms": time_cuda(kernel, iters=50),
               "graph_ms": time_cuda_graph(kernel, iters=20),
               "plain_ms": time_cuda(
                   lambda i: selective_scan_ref(*copies[i % n_copies]),
                   iters=3, warmup=1),
               "host_us": host_us(kernel)}
        row["bound_ms"], row["bound_by"] = scan_bound_ms(copies[0], h0=True)
        log(f"K4 time at {name} S=1024 d_in=8192 n=16 (bf16 x, h0): kernel "
            f"{row['ms']:.4f} ms, as a CUDA graph {row['graph_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.4f} ms, host {row['host_us']:.1f} us a call")
        rows.append(row)
        del copies
    first = rows[0]
    return {**{k: first[k] for k in ("ms", "graph_ms", "plain_ms",
                                     "bound_ms", "bound_by")},
            "shapes": rows}


def check_mamba_against_cpu(dev) -> float:
    """A tiny fp32 falcon-mamba model: ``prefill`` (through K4 on the
    card) + teacher-forced ring decode on the card, against the same
    weights on the CPU (plain path).  Returns the max logit
    difference."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    cfg = get_smoke_config("falcon-mamba-7b").with_(
        compute_dtype="float32", d_model=64, d_inner=128, dt_rank=8,
        vocab_size=128)
    params = tf.init_params(cfg, torch.Generator().manual_seed(SEED),
                            device="cpu")
    gparams = _to_device(params, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 48),
                         generator=torch.Generator().manual_seed(SEED))
    runs = {}
    for p, d in ((params, torch.device("cpu")), (gparams, dev)):
        ops.reset_launches()
        logits, caches = tf.prefill(p, cfg, toks[:, :40].to(d), cache_len=48)
        logits = [logits]
        for i in range(40, 48):
            logits.append(tf.decode_step(p, cfg, toks[:, i:i + 1].to(d),
                                         caches, i)[0])
        runs[d.type] = torch.cat([x.float().cpu() for x in logits], 1)
    worst = (runs["cpu"] - runs["cuda"]).abs().max().item()
    log(f"tiny falcon-mamba on the card vs CPU: max logit diff {worst:.3e} "
        f"tol={MODEL_TOL:g}; card launches {ops.launches}")
    check(worst <= MODEL_TOL, f"tiny falcon-mamba card vs CPU: {worst:.3e}")
    check(ops.launches["selective_scan"] == cfg.num_layers,
          f"tiny falcon-mamba: selective_scan launched "
          f"{ops.launches['selective_scan']} times for one prefill of "
          f"{cfg.num_layers} layers")
    return worst


# ---------------------------------------------------------------------------
# phases 3 and 4: the served paths
# ---------------------------------------------------------------------------

def make_prompts(rng, vocab: int):
    """8 prompts of 128-1024 tokens; prompts 4 and 5 share a 256-token
    prefix (prefix sharing); most lengths are not page multiples, so
    the admission after a probe prewarm maps a partly filled boundary
    page and the first decode step copies it (copy-on-write)."""
    lengths = [128, 1024, 333, 700, 459, 789, 512, 901]
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]
    prompts[5][:256] = prompts[4][:256]
    return prompts


def make_sched_prompts(rng, vocab: int, n: int = 16):
    """``n`` prompts of 128-1024 tokens; prompts 2, 6, 9 and 13 share a
    256-token prefix."""
    lengths = rng.integers(128, 1025, n)
    shared = (2, 6, 9, 13)
    lengths[list(shared)] = np.maximum(lengths[list(shared)], 320)
    prompts = [rng.integers(0, vocab, int(k)).astype(np.int32)
               for k in lengths]
    for i in shared[1:]:
        prompts[i][:256] = prompts[shared[0]][:256]
    return prompts


def build_zoo(dev, cfgs, num_pages, calib, *, max_len=2048, decode_batch=8,
              vocab=50_304, dtype=None, on_logits=None) -> dict:
    """The zoo (one paged Engine per config, random weights from seeded
    generators) and a token-probe mux whose threshold splits the
    ``calib`` prompts between the models.  ``on_logits`` sees every
    logits tensor an engine samples from."""
    import torch
    from repro_torch.core.multiplexer import init_mux, init_token_backbone
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.serving.mux_server import MuxServer, MuxServerConfig

    t0 = time.perf_counter()
    engines, costs = [], []
    for i, (cfg, pages) in enumerate(zip(cfgs, num_pages)):
        gen = torch.Generator(device=dev).manual_seed(SEED + i)
        params = tf.init_params(cfg, gen, device=dev, dtype=dtype)
        n_params = sum(t.numel() for t in _leaves(params))
        costs.append(2.0 * n_params)
        eng = Engine(cfg, params, ServeConfig(max_len=max_len), device=dev)
        if on_logits is not None:
            eng._sample_rows = _watch(eng._sample_rows, on_logits)
        engines.append(eng)
        log(f"{cfg.name}: {n_params / 1e9:.3f}B params, {pages} pages")
    gen = torch.Generator(device=dev).manual_seed(SEED + 100)
    backbone = init_token_backbone(gen, meta_dim=32, vocab_size=vocab,
                                   d_model=128, num_layers=2, device=dev)
    names = [c.name for c in cfgs]
    mux = init_mux(gen, backbone=backbone, model_names=names,
                   costs=dict(zip(names, costs)), meta_dim=32, proj_dim=16,
                   device=dev)
    probe = np.stack([p[:64] for p in calib])
    w = MuxServer(mux, costs, device=dev).probe_weights(probe)[:, 0]
    uniq = np.unique(w.cpu().numpy())
    check(len(uniq) >= 2, "the probe gives every prompt the same weight")
    k = len(uniq) // 2
    threshold = float((uniq[k - 1] + uniq[k]) / 2)
    server = MuxServer(mux, costs, MuxServerConfig(threshold=threshold),
                       engines=engines, device=dev)
    # capture the served probe's graphs (B=1, 64 tokens) before the runs,
    # so that no timed request pays a capture, as the reference's
    # scheduler warms its jit cache before traffic
    server.select(server.probe_weights(probe[:1]))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"engines": engines, "costs": costs, "server": server,
            "num_pages": list(num_pages), "decode_batch": decode_batch,
            "threshold": threshold, "setup_s": time.perf_counter() - t0}


def init_pools(zoo) -> dict:
    """Fresh page pools (and engine counters) for a served run, and on
    the card both paged decode steps captured before it (as a backend's
    warmup does), so that every step of the run replays a graph.
    Returns each engine's capture seconds by step."""
    stalls = {}
    for eng, pages in zip(zoo["engines"], zoo["num_pages"]):
        eng.init_paged(num_pages=pages, page_size=64,
                       decode_batch=zoo["decode_batch"], logit_cache=8)
        stalls[eng.cfg.name] = eng.capture_decode_steps()
    if zoo["engines"][0].device.type == "cuda":
        import torch
        log(f"pools made and decode steps captured: "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    return stalls


def _eager(step):
    """The function a graphed step captured (a CPU engine's step is that
    function already)."""
    return getattr(step, "fn", step)


def same_logits(tag, got, want) -> dict:
    """A graphed step's logits against the eager step's on the same
    inputs: bitwise equal, or within ``BF16_TOL`` with the reason logged;
    the argmax (the greedy token) of every row equal either way."""
    import torch
    same = torch.equal(got, want)
    err = (got.float() - want.float()).abs().max().item()
    if not same:
        log(f"  {tag}: logits not bitwise equal (max diff {err:.3e}): the "
            f"graph runs the kernels of its capture, and a library may pick "
            f"another algorithm under capture; held within {BF16_TOL:g}")
    check(err <= BF16_TOL, f"{tag}: graphed logits differ by {err:.3e}")
    check(torch.equal(got.argmax(-1), want.argmax(-1)),
          f"{tag}: graphed tokens {got.argmax(-1).tolist()} != eager "
          f"{want.argmax(-1).tolist()}")
    return {"bitwise": same, "max_diff": err}


class ShadowStep:
    """Stands in for an engine's graphed paged step: runs the eager step
    (the function the graph captured) and then the graph on the same
    operand, holds their logits together (``same_logits``) and returns
    the graph's.  Both write the same k/v into the same slots (and a COW
    step copies the same source page again), so the eager call leaves
    the graph's inputs as they were."""

    def __init__(self, graphed, tag: str):
        self.graphed, self.tag, self.calls = graphed, tag, []

    def __call__(self, packed):
        want = _eager(self.graphed)(packed)
        got = self.graphed(packed)
        self.calls.append(same_logits(
            f"{self.tag} step {len(self.calls)}", got, want))
        return got


K1_FORMS = ("paged_attention", "paged_attention_int8",
            "paged_attention_latent", "paged_attention_window")
K3_COUNTS = ("flash_attention", "flash_attention_wgmma",
             "flash_attention_window")


def k1_step_tally(eng) -> dict:
    """The K1 launches one paged decode step of ``eng`` makes, by form
    (``ops.launches``' keys): one a layer, each also under
    ``paged_attention_int8`` where the layer's pool is int8, under
    ``paged_attention_latent`` where the layer is MLA (the absorbed
    latent form) and under ``paged_attention_window`` where it is a swa
    layer.  Forms with no launch are left out, as a capture's tally
    leaves them."""
    import torch
    cfg, g = eng.cfg, eng.cfg.num_groups
    want = {"paged_attention": cfg.num_layers,
            "paged_attention_int8": sum(
                g for i in range(len(cfg.pattern))
                if eng._paged_caches[f"p{i}"]["k"].dtype == torch.int8),
            "paged_attention_latent": sum(
                g for spec in cfg.pattern if spec.mixer == "mla"),
            "paged_attention_window": window_layers(cfg)}
    return {k: n for k, n in want.items() if n}


def check_decode_graphs(dev, zoo, new_tokens: int = 6) -> dict:
    """The paged decode steps as CUDA graphs against the eager steps on
    each engine of the zoo, at full width: fresh pools with both steps
    captured (``init_pools``; each capture must tally one K1 launch a
    layer, by form: ``k1_step_tally``), then requests A, B = A's prompt
    (333 tokens: B maps A's partly filled boundary page) and C in one
    batch with 5 inactive rows until done, every step through
    :class:`ShadowStep` (the first step copies on write for A and not
    for B); then one sampled request (temperature 0.8) through
    ``generate_paged`` twice graphed and once eager: the same tokens.  Returns each engine's figures: capture
    seconds, steps compared, bitwise or not, and the sampled request's
    ms a step graphed and eager."""
    import torch
    rng = np.random.default_rng(SEED + 31)
    stalls = init_pools(zoo)
    out = {}
    for eng in zoo["engines"]:
        name, layers = eng.cfg.name, eng.cfg.num_layers
        graphs = {"paged_decode": eng._paged_decode,
                  "paged_decode_cow": eng._paged_decode_cow}
        for key, width in (("paged_decode", 2), ("paged_decode_cow", 4)):
            if dev.type != "cuda":
                break                     # a CPU rehearsal captures nothing
            held = graphs[key].replay_launches(torch.zeros(
                (zoo["decode_batch"], width + eng._max_pages),
                dtype=torch.int32, device=dev))
            check(held == k1_step_tally(eng),
                  f"{name} {key}: the capture tallied {held}, not "
                  f"{k1_step_tally(eng)} ({layers} layers)")
        shadows = {k: ShadowStep(g, f"{name} {k}") for k, g in graphs.items()}
        eng._paged_decode = shadows["paged_decode"]
        eng._paged_decode_cow = shadows["paged_decode_cow"]
        vocab = eng.cfg.vocab_size
        a = rng.integers(0, vocab, 333).astype(np.int32)
        c = rng.integers(0, vocab, 459).astype(np.int32)
        try:
            seqs = [eng.prefill_into_pages(p, max_new_tokens=new_tokens)
                    for p in (a, a, c)]
            cow0 = eng.cow_count
            eng.decode_step_batch(seqs)
            check(eng.cow_count - cow0 == 1, f"{name}: the first step made "
                  f"{eng.cow_count - cow0} copies on write, not 1")
            while not all(s.done for s in seqs):
                eng.decode_step_batch([s for s in seqs if not s.done])
        finally:
            eng._paged_decode = graphs["paged_decode"]
            eng._paged_decode_cow = graphs["paged_decode_cow"]
        for s in seqs:
            eng.pool.release(s)
        calls = {k: sh.calls for k, sh in shadows.items()}
        check(len(calls["paged_decode_cow"]) == 1
              and len(calls["paged_decode"]) == new_tokens - 2,
              f"{name}: {len(calls['paged_decode_cow'])} COW and "
              f"{len(calls['paged_decode'])} plain steps compared")
        prompt = rng.integers(0, vocab, 200).astype(np.int32)

        def sampled():
            r = eng.generate_paged(prompt, max_new_tokens=16,
                                   seed=SEED + 7, temperature=0.8)
            return (r["tokens"][len(prompt):].tolist(),
                    r["decode_s"] * 1e3 / 15)
        runs = [sampled(), sampled()]
        eng._paged_decode = _eager(graphs["paged_decode"])
        eng._paged_decode_cow = _eager(graphs["paged_decode_cow"])
        try:
            runs.append(sampled())
        finally:
            eng._paged_decode = graphs["paged_decode"]
            eng._paged_decode_cow = graphs["paged_decode_cow"]
        toks = [r[0] for r in runs]
        check(toks[0] == toks[1] == toks[2], f"{name}: a sampled request "
              f"gave {toks} (graphed, graphed again, eager)")
        check(eng.pool.pages_in_use == 0,
              f"{name}: {eng.pool.pages_in_use} pages held")
        out[name] = {
            "capture_s": stalls[name],
            "steps_compared": {k: len(v) for k, v in calls.items()},
            "bitwise": all(c["bitwise"] for v in calls.values() for c in v),
            "max_diff": max(c["max_diff"] for v in calls.values() for c in v),
            "sampled_tokens": toks[0],
            "sampled_ms_per_step": {"graph": [runs[0][1], runs[1][1]],
                                    "eager": runs[2][1]}}
        log(f"decode graphs, {name}: {json.dumps(out[name])}")
    return out


def _host_timed(fn, host_us: list):
    """``fn`` that appends the host microseconds of each call to
    ``host_us`` (a graph replay or an eager step returns once its work is
    queued)."""
    def timed(*args):
        t = time.perf_counter()
        out = fn(*args)
        host_us.append((time.perf_counter() - t) * 1e6)
        return out
    return timed


def serve(dev, zoo, prompts, *, new_tokens=32, profile_step=None,
          eager=False):
    """The direct path: each prompt through ``MuxServer.probe`` ->
    ``prefill_into_pages`` in the selected engine, then each engine's
    ``decode_step_batch`` loop until every request has ``new_tokens``.
    ``profile_step`` (an index) runs that decode step of each engine
    under ``torch.profiler``.  ``eager`` runs each engine's paged steps
    as the functions its graphs captured, called directly (the port's
    step before it was graphed, kept here to measure against).  Returns
    the run's statistics, with each request's tokens in prompt order and
    each engine's step times (host clock to the sampled ids) and host
    microseconds a step call."""
    import torch
    from repro_torch.kernels import ops

    engines, server = zoo["engines"], zoo["server"]
    captures = init_pools(zoo)
    ops.reset_launches()
    seqs = [[] for _ in engines]
    order, assign = [], []
    prefill_ms = []
    for prompt in prompts:
        t = time.perf_counter()
        m = int(server.probe(prompt[None])["assign"][0])
        seq = engines[m].prefill_into_pages(prompt, max_new_tokens=new_tokens)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        seqs[m].append(seq)
        order.append(seq)
        assign.append(m)
    per_engine = []
    for eng, running in zip(engines, seqs):
        graphs = eng._paged_decode, eng._paged_decode_cow
        host = []
        eng._paged_decode, eng._paged_decode_cow = (
            _host_timed(_eager(g) if eager else g, host) for g in graphs)
        try:
            per_engine.append(_decode_all(dev, eng, running, profile_step))
        finally:
            eng._paged_decode, eng._paged_decode_cow = graphs
        per_engine[-1]["host_us_per_step"] = float(np.median(host))
        per_engine[-1]["capture_s"] = captures.get(eng.cfg.name)
        per_engine[-1]["step_tally"] = k1_step_tally(eng)
        for s in running:
            check(len(s.tokens) == new_tokens,
                  f"{eng.cfg.name}: a request made {len(s.tokens)} tokens")
            eng.pool.release(s)
        eng.shed_prewarmed()
        per_engine[-1]["pages_in_use_after"] = eng.pool.pages_in_use
    launches = dict(ops.launches)
    return {"prefill_ms": prefill_ms, "assign": assign,
            "engines": per_engine, "launches": launches, "eager": eager,
            "tokens": [list(s.tokens) for s in order],
            "split": {e["model"]: e["requests"] for e in per_engine}}


def _decode_all(dev, eng, running, profile_step) -> dict:
    """``decode_step_batch`` on ``running`` until every request is done;
    the statistics of the loop."""
    import torch
    from repro_torch.kernels import ops
    before = {k: ops.launches[k] for k in K1_FORMS}
    t = time.perf_counter()
    steps = 0
    active = list(running)
    prof, prof_s, prof_tokens = None, 0.0, 0
    step_ms = []                      # unprofiled steps, host clock
    while active:
        tp = time.perf_counter()
        if steps == profile_step:     # kept out of the decode rate
            prof = profile_decode_step(eng, active)
            prof_s, prof_tokens = time.perf_counter() - tp, len(active)
        else:
            eng.decode_step_batch(active)   # syncs: ids reach the host
            step_ms.append((time.perf_counter() - tp) * 1e3)
        steps += 1
        active = [s for s in active if not s.done]
    if prof is not None:
        # the profiler slows the host; idle share is taken against
        # the median unprofiled step of the same batch
        prof["unprofiled_step_ms"] = float(np.median(step_ms))
        prof["idle_share"] = 1.0 - (prof["device_busy_ms"]
                                    / prof["unprofiled_step_ms"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t - prof_s
    tokens = sum(len(s.tokens) - 1 for s in running) - prof_tokens
    padded = sum(eng.pool.pages_for(s.prompt_len) * eng.pool.page_size
                 for s in running)
    return {
        "model": eng.cfg.name, "requests": len(running),
        "decode_steps": steps, "decode_tokens": tokens,
        "decode_s": dt,
        "decode_tokens_per_s": tokens / dt if dt > 0 else 0.0,
        "median_step_ms": float(np.median(step_ms)),
        "paged_attention_launches":
            ops.launches["paged_attention"] - before["paged_attention"],
        "k1_by_form": {k: ops.launches[k] - before[k] for k in K1_FORMS
                       if ops.launches[k] - before[k]},
        "cow": eng.cow_count,
        "prompt_tokens_padded": padded,
        "prefill_tokens_computed": eng.prefill_tokens_computed,
        "logit_cache_hits": eng.logit_cache_hits,
        "whole_prompt_prefills": eng.whole_prompt_prefills,
        "profile": prof}


def serve_scheduler(dev, zoo, prompts, *, new_tokens=32, rate=4.0,
                    prewarm=True) -> dict:
    """The scheduler path, the serving entry point users call:
    ``PagedLLMScheduler`` over one ``InProcessBackend`` per engine,
    whole-prompt prefill (``prefill_chunk_pages=0``).  ``select_fn`` is
    the mux: with ``prewarm`` it is ``MuxServer.probe``, which runs the
    selected engine's prefill inside ``submit`` on the event loop, so
    the admission that follows is a logit-cache hit; without it,
    ``probe_weights`` + ``select`` only, so every prefill runs in the
    admission on the backend's executor thread.  The prompts arrive
    open-loop at Poisson times (``traffic.arrival_times``, seed
    ``SEED``), each asking for ``new_tokens`` greedy tokens.  Returns
    the outputs, the launch counts of the run, the whole-prompt
    prefills made off the main thread and the scheduler's metrics."""
    import asyncio
    import threading

    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.scheduler import (PagedLLMConfig,
                                               PagedLLMScheduler,
                                               TrafficConfig, arrival_times,
                                               replay)

    engines, server = zoo["engines"], zoo["server"]
    init_pools(zoo)
    steps = [0] * len(engines)
    executor_prefills = [0] * len(engines)
    for m, eng in enumerate(engines):       # count each engine's steps
        def counted(seqs, _step=eng.decode_step_batch, _m=m):
            steps[_m] += 1
            return _step(seqs)

        def prefill(seq, *, chunk_tokens=None, _chunk=eng.prefill_chunk,
                    _eng=eng, _m=m):
            before = _eng.whole_prompt_prefills
            out = _chunk(seq, chunk_tokens=chunk_tokens)
            if threading.current_thread() is not threading.main_thread():
                executor_prefills[_m] += _eng.whole_prompt_prefills - before
            return out
        eng.decode_step_batch = counted
        eng.prefill_chunk = prefill

    def select(x) -> int:
        x = np.asarray(x)[None]
        if prewarm:
            return int(server.probe(x)["assign"][0])
        return int(server.select(server.probe_weights(x))[0])

    sched = PagedLLMScheduler(
        engines, PagedLLMConfig(max_new_tokens=new_tokens,
                                prefill_chunk_pages=0),
        select_fn=select, costs=zoo["costs"])
    times = arrival_times(TrafficConfig(rate=rate, num_requests=len(prompts),
                                        seed=SEED))

    async def run():
        async with sched:
            futs = await replay(sched.submit, prompts, times)
            return await asyncio.gather(*futs)

    ops.reset_launches()
    t0 = time.perf_counter()
    outs = asyncio.run(run())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(ops.launches)
    snap = sched.snapshot()
    per_engine = []
    for m, eng in enumerate(engines):
        del eng.decode_step_batch           # the class's methods again
        del eng.prefill_chunk
        busy = sched.metrics.per_model_busy_s[m]
        done = sched.metrics.per_model_completed[m]
        tokens = done * (new_tokens - 1)    # the first comes from prefill
        eng.shed_prewarmed()                # a cache, not a request
        per_engine.append({
            "model": eng.cfg.name, "requests": done, "decode_steps": steps[m],
            "whole_prompt_prefills": eng.whole_prompt_prefills,
            "executor_whole_prompt_prefills": executor_prefills[m],
            "logit_cache_hits": eng.logit_cache_hits,
            "cow": eng.cow_count, "step_tally": k1_step_tally(eng),
            "ttft_p50_ms": snap["ttft_p50_ms_by_model"][m],
            "ttft_p99_ms": snap["ttft_p99_ms_by_model"][m],
            "decode_tokens_per_s": tokens / busy if busy > 0 else 0.0,
            "pages_in_use_after": eng.pool.pages_in_use})
    return {"outs": outs, "launches": launches, "engines": per_engine,
            "prewarm": prewarm, "wall_s": wall_s, "completed": snap["completed"],
            "failed": snap["failed"],
            "mixed_admission_batches": snap["mixed_admission_batches"],
            "decode_batches": snap["decode_batches"],
            "ttft_p50_ms": snap["ttft_p50_ms"],
            "ttft_p99_ms": snap["ttft_p99_ms"]}


def profile_decode_step(eng, active) -> dict:
    """One decode step under torch.profiler: device time by kernel (the
    key_averages rows of device events; a CPU op's row repeats its
    kernels' time and is left out) and the profiled step's host-clock
    time, which the profiler inflates (``serve`` sets the idle share
    against an unprofiled step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.decode_step_batch(active)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    paged = sum(r[0] for r in rows if "paged_attention_kernel" in r[2])
    return {"profiled_step_ms": wall_ms, "device_busy_ms": busy,
            "paged_attention_ms": paged,
            "top": [{"ms": ms, "calls": n, "name": k}
                    for ms, n, k in rows[:8]]}


def profile_prefill(eng, rng, n_tokens: int, repeats: int = 3) -> dict:
    """Where a whole-prompt prefill's time goes: ``repeats`` unprofiled
    admissions of fresh random ``n_tokens`` prompts (no logit-cache hit,
    no shared prefix, so each takes the flash-attention branch; host
    clock around a synchronised call), then one more under
    torch.profiler for device time by kernel.  The idle share is taken
    against the median unprofiled admission."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    vocab = eng.cfg.vocab_size

    def admit():
        seq = eng.prefill_into_pages(
            rng.integers(0, vocab, n_tokens).astype(np.int32),
            max_new_tokens=1)
        torch.cuda.synchronize()
        eng.pool.release(seq)

    wall = []
    for _ in range(repeats):
        t = time.perf_counter()
        admit()
        wall.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        admit()
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    k3 = sum(r[0] for r in rows if "flash_attention" in r[2])
    step = float(np.median(wall))
    return {"model": eng.cfg.name, "prompt_tokens": n_tokens,
            "unprofiled_ms": wall, "device_busy_ms": busy,
            "flash_attention_ms": k3, "idle_share": 1.0 - busy / step,
            "top": [{"ms": ms, "calls": n, "name": k}
                    for ms, n, k in rows[:6]]}


def _device_rows(prof):
    """(ms, calls, name) of every device event row of a profile,
    largest first (a CPU op's row repeats its kernels' time and is left
    out)."""
    from torch.autograd import DeviceType
    rows = [(e.device_time_total / 1e3, e.count, e.key[:80])
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.device_time_total > 0]
    return sorted(rows, reverse=True)


def serve_ring(dev, arch, *, prompt_len, new_tokens, batch=2, step_times=0,
               profile=False, on_logits=None) -> dict:
    """Phase 6, the launcher's path: ``launch.serve.build_engine`` (the
    published config, random bf16 weights from ``SEED``) ->
    ``Engine.generate`` on ``batch`` random prompts of ``prompt_len``
    tokens for ``new_tokens`` greedy tokens, twice (the first call
    allocates the engine's ring caches and captures their decode step);
    the launch counts and the ``tf.prefill`` calls are read over these
    two runs.  Then once more with the ring's step run eagerly (the
    function its graph captured): the same tokens.  Then ``step_times``
    ring decode steps from one prefill, eager and graphed (:func:`
    ring_steps`).  With ``profile``, last, one prefill and one graphed
    and one eager decode step under torch.profiler.  Returns the numbers
    and launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    eng = serve.build_engine(arch, smoke=False, seed=SEED, device=dev,
                             max_len=prompt_len + new_tokens)
    sync()
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(eng.params))
    log(f"{arch}: {n_params / 1e9:.3f}B params (bf16), setup {setup_s:.1f} s")
    if on_logits is not None:
        eng._pick = _watch(eng._pick, on_logits)
    prompts = torch.randint(0, eng.cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(SEED + 3),
                            dtype=torch.int32)
    prefills = [0]
    real_prefill = tf.prefill

    def counted(*args, **kw):
        prefills[0] += 1
        return real_prefill(*args, **kw)

    tf.prefill = counted        # Engine.generate calls it through the module
    try:
        ops.reset_launches()
        runs = [eng.generate(prompts, max_new_tokens=new_tokens)
                for _ in range(2)]
        launches, n_prefills = dict(ops.launches), prefills[0]
    finally:
        tf.prefill = real_prefill
    ring = eng._rings[batch]
    graphed = ring.decode
    ring.decode = _eager(graphed)
    try:
        eager_run = eng.generate(prompts, max_new_tokens=new_tokens)
    finally:
        ring.decode = graphed
    check(all(torch.equal(r["tokens"], eager_run["tokens"]) for r in runs),
          f"{arch}: generate's tokens with the graphed ring step differ "
          f"from the eager step's")
    steps = ring_steps(dev, eng, prompts, step_times) if step_times else None
    if steps is not None and on_logits is not None:
        on_logits(steps["last_logits"])
    prof = None
    if profile:
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with tprofile(activities=acts) as p_prefill:
            logits, _ = tf.prefill(eng.params, eng.cfg, prompts.to(dev),
                                   caches=ring.caches)
            sync()
        tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        pos = torch.full((1,), prompt_len, dtype=torch.long, device=dev)
        rows_s = {}
        for name, step in (("graph", graphed), ("eager", _eager(graphed))):
            step(tok, pos)                # warm, outside the window
            sync()
            with tprofile(activities=acts) as p_step:
                step(tok, pos)
                sync()
            rows_s[name] = _device_rows(p_step)
        rows_p = _device_rows(p_prefill)
        busy_p = sum(r[0] for r in rows_p)
        busy_s = {k: sum(r[0] for r in v) for k, v in rows_s.items()}
        k4 = sum(r[0] for r in rows_p if "selective_scan_kernel" in r[2])
        prefill_ms = runs[-1]["prefill_s"] * 1e3
        prof = {"prefill_device_busy_ms": busy_p,
                "prefill_selective_scan_ms": k4,
                "prefill_selective_scan_share": k4 / busy_p,
                "prefill_idle_share": 1.0 - busy_p / prefill_ms,
                "step_device_busy_ms": busy_s["graph"],
                "eager_step_device_busy_ms": busy_s["eager"],
                "step_launches": sum(r[1] for r in rows_s["graph"]),
                "eager_step_launches": sum(r[1] for r in rows_s["eager"]),
                "top_prefill": [{"ms": ms, "calls": n, "name": k}
                                for ms, n, k in rows_p[:6]],
                "top_step": [{"ms": ms, "calls": n, "name": k}
                             for ms, n, k in rows_s["graph"][:6]]}
        if steps is not None:
            for name in ("graph", "eager"):
                key = "step_idle_share" if name == "graph" else \
                    "eager_step_idle_share"
                prof[key] = 1.0 - busy_s[name] / steps[name]["median_ms"]
    out = {"model": arch, "layers": eng.cfg.num_layers,
           "window_layers": window_layers(eng.cfg), "params": n_params,
           "batch": batch, "prompt_len": prompt_len, "new_tokens": new_tokens,
           "tokens_shapes": [tuple(r["tokens"].shape) for r in runs],
           "prompts_kept": all(torch.equal(r["tokens"][:, :prompt_len].cpu(),
                                           prompts) for r in runs),
           "ids_in_vocab": all(bool(((r["tokens"] >= 0) & (
               r["tokens"] < eng.cfg.vocab_size)).all()) for r in runs),
           "prefill_ms": [r["prefill_s"] * 1e3 for r in runs],
           "decode_tokens_per_s": [r["tokens_per_s"] for r in runs],
           "eager_decode_tokens_per_s": eager_run["tokens_per_s"],
           "capture_s": eng.capture_s.get(f"ring_decode_b{batch}"),
           "median_decode_step_ms": (steps["graph"]["median_ms"]
                                     if steps else None),
           "steps": ({k: v for k, v in steps.items() if k != "last_logits"}
                     if steps else None),
           "prefills": n_prefills, "launches": launches, "profile": prof}
    del eng, ring, graphed
    return out


def ring_steps(dev, eng, prompts, n: int) -> dict:
    """``n`` ring decode steps after one prefill into the engine's ring
    caches, twice from the same state: the caches after the prefill are
    kept aside and put back before each run, so the eager run (the
    function the graph captured, called directly) and the graphed run
    start equal.  Each step is timed alone from a synchronise to one
    (host clock, ms), with the host microseconds of the call itself;
    each run feeds its own greedy tokens.  The two runs' logits are held
    together step by step (``same_logits``).  Returns both runs' median
    ms and host us a step, and the comparison."""
    import torch
    from repro_torch.models import transformer as tf
    ring = eng._rings[prompts.shape[0]]
    p = prompts.shape[1]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    logits, _ = tf.prefill(eng.params, eng.cfg, prompts.to(dev),
                           caches=ring.caches)
    first = logits[:, 0]
    kept = {k: {n_: t.clone() for n_, t in v.items()}
            for k, v in ring.caches.items()}
    positions = torch.arange(p, p + n, dtype=torch.long, device=dev)
    out = {}
    for name, step in (("eager", _eager(ring.decode)), ("graph", ring.decode)):
        for k, v in kept.items():
            for n_, t in v.items():
                ring.caches[k][n_].copy_(t)
        tok = first.argmax(-1, keepdim=True).to(torch.int32)
        ms, host, seen = [], [], []
        for i in range(n):
            sync()
            t = time.perf_counter()
            lg = step(tok, positions[i:i + 1])
            host.append((time.perf_counter() - t) * 1e6)
            tok = lg.argmax(-1, keepdim=True).to(torch.int32)
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
            seen.append(lg)
        out[name] = {"median_ms": float(np.median(ms)),
                     "host_us": float(np.median(host)), "logits": seen}
    cmp = [same_logits(f"{eng.cfg.name} ring step {i}", g, e)
           for i, (g, e) in enumerate(zip(out["graph"].pop("logits"),
                                          out["eager"].pop("logits")))]
    out["bitwise"] = all(c["bitwise"] for c in cmp)
    out["max_diff"] = max(c["max_diff"] for c in cmp)
    out["last_logits"] = lg
    log(f"{eng.cfg.name} ring steps (B={prompts.shape[0]}, {n} steps from "
        f"one prefill): eager {out['eager']}, graph {out['graph']}, "
        f"bitwise {out['bitwise']}, max diff {out['max_diff']:.3e}")
    return out


def check_ring(run, *, scan: bool) -> None:
    """Checks of a ``serve_ring`` run: the output shapes, the prompts
    kept and every id in the vocabulary, and each prefill launched the
    scan (mamba) or flash attention's tensor-core variant (attention) in
    every layer and nothing else; no paged decode kernel ran."""
    name, layers = run["model"], run["layers"]
    want_shape = (run["batch"], run["prompt_len"] + run["new_tokens"])
    check(all(s == want_shape for s in run["tokens_shapes"]),
          f"{name}: generate gave tokens of shapes {run['tokens_shapes']}, "
          f"expected {want_shape}")
    check(run["prompts_kept"] and run["ids_in_vocab"],
          f"{name}: generate changed its prompts or made ids outside the "
          f"vocabulary")
    got = run["launches"]
    k3 = 0 if scan else layers * run["prefills"]
    want = {"selective_scan": layers * run["prefills"] if scan else 0,
            "flash_attention": k3, "flash_attention_wgmma": k3,
            "flash_attention_simt": 0,
            "flash_attention_window": run["window_layers"] * run["prefills"],
            "paged_attention": 0, "paged_attention_int8": 0,
            "paged_attention_latent": 0, "paged_attention_window": 0,
            "mux_score": 0, "flash_attention_bwd": 0}
    check(run["prefills"] > 0 and got == want,
          f"{name}: launches {got} for {run['prefills']} prefills of "
          f"{layers} layers, expected {want}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def _watch(sample_rows, on_logits):
    def wrapped(logits, *args, **kw):
        on_logits(logits)
        return sample_rows(logits, *args, **kw)
    return wrapped


def live_cuda_tensors(top: int = 6) -> list:
    """(GB, shape, dtype) of the largest CUDA tensors the garbage
    collector can reach, for a report of what still holds device
    memory."""
    import torch
    found = []
    for obj in gc.get_objects():
        try:
            if torch.is_tensor(obj) and obj.is_cuda:
                found.append((obj.numel() * obj.element_size() / 1e9,
                              tuple(obj.shape), str(obj.dtype)))
        except ReferenceError:
            continue
    return sorted(found, reverse=True)[:top]


def check_wgmma_prefills(tag, launches) -> None:
    """Every K3 launch of a bf16 served path took the tensor-core
    variant (the per-variant counts of ``ops.launches``)."""
    check(launches["flash_attention_wgmma"] == launches["flash_attention"]
          and launches["flash_attention_simt"] == 0,
          f"{tag}: of {launches['flash_attention']} flash_attention "
          f"launches, {launches['flash_attention_wgmma']} on the tensor-core "
          f"variant and {launches['flash_attention_simt']} on the SIMT one")


def check_served(stats, cfgs) -> None:
    by_model = {e["model"]: e for e in stats["engines"]}
    k3_want = k3_window = 0
    for cfg in cfgs:
        e = by_model[cfg.name]
        check(e["requests"] > 0, f"{cfg.name} received no request")
        check(e["pages_in_use_after"] == 0,
              f"{cfg.name}: {e['pages_in_use_after']} pages still held")
        want = cfg.num_layers * e["decode_steps"]
        check(e["paged_attention_launches"] == want,
              f"{cfg.name}: paged_attention launched "
              f"{e['paged_attention_launches']} times, expected "
              f"{cfg.num_layers} layers x {e['decode_steps']} steps = {want}")
        forms = {k: n * e["decode_steps"] for k, n in e["step_tally"].items()}
        check(e["k1_by_form"] == forms,
              f"{cfg.name}: K1 launched {e['k1_by_form']} by form, expected "
              f"{forms} ({e['decode_steps']} steps)")
        k3_want += cfg.num_layers * e["whole_prompt_prefills"]
        k3_window += window_layers(cfg) * e["whole_prompt_prefills"]
    check(stats["launches"]["flash_attention"] == k3_want > 0
          and stats["launches"]["flash_attention_window"] == k3_window,
          f"direct path: flash_attention launched "
          f"{stats['launches']['flash_attention']} times "
          f"({stats['launches']['flash_attention_window']} windowed), "
          f"expected layers x whole-prompt prefills = {k3_want} "
          f"({k3_window} in swa layers)")
    check_wgmma_prefills("direct path", stats["launches"])
    check(stats["launches"]["mux_score"] == len(stats["prefill_ms"]),
          f"direct path: mux_score launched {stats['launches']['mux_score']} "
          f"times for {len(stats['prefill_ms'])} probes")
    check(any(e["cow"] > 0 for e in stats["engines"]),
          "no copy-on-write ran")
    check(any(e["prefill_tokens_computed"] < e["prompt_tokens_padded"]
              for e in stats["engines"]), "no prefix sharing ran")


def check_scheduler(run, prompts, cfgs, new_tokens) -> None:
    """Checks of a ``serve_scheduler`` run; without the prewarm, every
    whole-prompt prefill must have run in an admission on a backend's
    executor thread and no admission may hit the logit cache."""
    tag = "scheduler" if run["prewarm"] else "scheduler (no prewarm)"
    check(run["completed"] == len(prompts) and run["failed"] == 0,
          f"{tag}: {run['completed']} of {len(prompts)} requests "
          f"completed, {run['failed']} failed")
    for prompt, out in zip(prompts, run["outs"]):
        out = np.asarray(out)
        check(out.shape == (len(prompt) + new_tokens,)
              and bool((out[:len(prompt)] == prompt).all()),
              f"{tag}: an output of shape {out.shape} is not its "
              f"prompt ({len(prompt)}) + {new_tokens} tokens")
    by_model = {e["model"]: e for e in run["engines"]}
    k1_want = dict.fromkeys(K1_FORMS, 0)
    k3_want = k3_window = 0
    for cfg in cfgs:
        e = by_model[cfg.name]
        check(e["pages_in_use_after"] == 0,
              f"{tag}: {cfg.name} holds {e['pages_in_use_after']} pages "
              f"after the run")
        if not run["prewarm"]:
            check(e["logit_cache_hits"] == 0 and e[
                "executor_whole_prompt_prefills"] == e[
                "whole_prompt_prefills"],
                  f"{tag}: {cfg.name} made {e['whole_prompt_prefills']} "
                  f"whole-prompt prefills, "
                  f"{e['executor_whole_prompt_prefills']} of them on an "
                  f"executor thread, with {e['logit_cache_hits']} "
                  f"logit-cache hits")
        for k, n in e["step_tally"].items():
            k1_want[k] += n * e["decode_steps"]
        k3_want += cfg.num_layers * e["whole_prompt_prefills"]
        k3_window += window_layers(cfg) * e["whole_prompt_prefills"]
    got = run["launches"]
    check(got["flash_attention"] == k3_want > 0
          and got["flash_attention_window"] == k3_window,
          f"{tag}: flash_attention launched {got['flash_attention']} "
          f"times ({got['flash_attention_window']} windowed), expected "
          f"layers x whole-prompt prefills = {k3_want} ({k3_window} in "
          f"swa layers)")
    check_wgmma_prefills(tag, got)
    check({k: got[k] for k in K1_FORMS} == k1_want
          and k1_want["paged_attention"] > 0,
          f"{tag}: K1 launched {({k: got[k] for k in K1_FORMS})} by form, "
          f"expected layers x decode steps = {k1_want}")
    check(got["mux_score"] == len(prompts),
          f"{tag}: mux_score launched {got['mux_score']} times for "
          f"{len(prompts)} requests")
    check(run["mixed_admission_batches"] > 0,
          f"{tag}: no decode batch mixed requests admitted at "
          "different times")


def serve_direct(dev, zoo, prompts, cfgs, *, new_tokens=32):
    """Phase 3 with the engines' graphed steps, then with the eager ones
    (``serve(eager=True)``): each run passes ``check_served`` and every
    request's tokens are the same in both.  Returns the graphed run's
    statistics and each model's [graphed, eager] median step ms, host
    microseconds a step call and decode tokens/s."""
    runs = {}
    for eager in (False, True):
        stats = serve(dev, zoo, prompts, new_tokens=new_tokens, eager=eager)
        log(f"direct path ({'eager' if eager else 'graphed'} steps): mux "
            f"split {stats['split']}, launches {stats['launches']}")
        for e in stats["engines"]:
            log(f"  {json.dumps(e)}")
        check_served(stats, cfgs)
        runs[eager] = stats
    check(runs[False]["tokens"] == runs[True]["tokens"],
          "direct path: the graphed steps' tokens differ from the eager "
          "steps'")
    return runs[False], {
        e["model"]: {k: [e[k], ee[k]] for k in (
            "median_step_ms", "host_us_per_step", "decode_tokens_per_s")}
        for e, ee in zip(runs[False]["engines"], runs[True]["engines"])}


# phase 6: (arch, prompt tokens, new tokens, mamba)
RING_RUNS = (("falcon-mamba-7b", 1024, 32, True), ("olmo-1b", 256, 8, False))


def decode_graph_checks(dev) -> dict:
    """The engine's decode graphs alone (README's command): the zoo of
    phases 3-5, ``check_decode_graphs``, phase 3 graphed and eager
    (``serve_direct``), then phase 6's ring paths, each with its eager
    ``generate`` and its eager-against-graphed steps.  Prints and returns
    the ``decode_graphs`` figures."""
    import torch
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    cfgs = [get_config("olmo-1b"), get_config("codeqwen1.5-7b")]
    prompts = make_prompts(np.random.default_rng(SEED), 50_304)
    zoo = build_zoo(dev, cfgs, [512, 256], prompts, dtype=torch.bfloat16)
    out = {"paged": check_decode_graphs(dev, zoo)}
    _, out["direct"] = serve_direct(dev, zoo, prompts, cfgs)
    del zoo
    gc.collect()
    torch.cuda.empty_cache()
    for arch, plen, new, scan in RING_RUNS:
        r = serve_ring(dev, arch, prompt_len=plen, new_tokens=new,
                       step_times=16)
        check_ring(r, scan=scan)
        out[arch] = {k: r[k] for k in ("decode_tokens_per_s",
                                       "eager_decode_tokens_per_s",
                                       "capture_s", "steps")}
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"decode_graphs": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 9: MLA (minicpm3-4b) and an int8 pool (olmo-1b) served
# ---------------------------------------------------------------------------

MLA_PAGES = (512, 512)       # pages of 64: 1.17 GB / 2.18 GB of pool
CHUNK_TOL = 2e-2             # first-token logits, chunked vs whole prompt
PROMPT_VOCAB = 50_304        # olmo-1b's vocabulary, which both models take


def phase9_cfgs():
    """minicpm3-4b at its published config and olmo-1b with an int8
    pool."""
    from repro_torch.configs import get_config
    return [get_config("minicpm3-4b"),
            get_config("olmo-1b").with_(kv_cache_dtype="int8")]


def check_phase9_pools(zoo) -> dict:
    """minicpm3-4b's pool holds bf16 latent pages (one head of
    kv_lora + d_rope, V a width-1 slab) though nothing asked for int8
    there, and olmo-1b's holds int8 pages with bf16 scales."""
    import torch
    out = {}
    for eng in zoo["engines"]:
        slabs = eng._paged_caches["p0"]
        out[eng.cfg.name] = {k: [str(v.dtype), list(v.shape)]
                             for k, v in slabs.items()}
        if eng.cfg.pattern[0].mixer == "mla":
            width = eng.cfg.kv_lora + eng.cfg.d_rope
            check(slabs["k"].dtype == torch.bfloat16
                  and slabs["k"].shape[-2:] == (1, width)
                  and slabs["v"].shape[-1] == 1 and set(slabs) == {"k", "v"},
                  f"{eng.cfg.name}: pool {out[eng.cfg.name]} is not a bf16 "
                  f"latent pool of width {width}")
        else:
            check(slabs["k"].dtype == torch.int8
                  and slabs["k_scale"].dtype == torch.bfloat16,
                  f"{eng.cfg.name}: pool {out[eng.cfg.name]} is not int8")
    log(f"phase 9 pools: {json.dumps(out)}")
    return out


def check_chunked_prefill(dev, zoo, n_tokens: int = 1024, chunk: int = 256,
                          new_tokens: int = 8) -> dict:
    """On each engine, one ``n_tokens`` prompt admitted whole
    (``begin_prefill`` + one ``prefill_chunk``: K3) and, on a fresh pool,
    in chunks of ``chunk`` (the q_offset tail path: each chunk attends
    over the block-table gather of the pool), then ``new_tokens`` greedy
    tokens each.  The first-token logits must agree within
    ``CHUNK_TOL`` and the tokens be the same, or the reason is logged;
    a chunked path that computed something else (logits off by more than
    a tenth of their norm) fails.  An MoE model routes each chunk on its
    own (its capacity follows the chunk's length, as in the JAX
    package), so there the difference is logged and not held; its
    logits must still be finite and its pool drain."""
    import torch
    rng = np.random.default_rng(SEED + 93)
    prompt = rng.integers(0, PROMPT_VOCAB, n_tokens).astype(np.int32)
    out = {}
    for eng, pages in zip(zoo["engines"], zoo["num_pages"]):
        name, res = eng.cfg.name, {}
        for how, size in (("whole", None), ("chunked", chunk)):
            eng.init_paged(num_pages=pages, page_size=64,
                           decode_batch=zoo["decode_batch"], logit_cache=8)
            eng.capture_decode_steps()
            before = eng.whole_prompt_prefills
            t = time.perf_counter()
            seq = eng.begin_prefill(prompt, max_new_tokens=new_tokens)
            calls = 1
            while not eng.prefill_chunk(seq, chunk_tokens=size):
                calls += 1
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            row = torch.from_numpy(eng._logit_cache_get(
                eng._prompt_key(seq.prompt)).copy())
            while not seq.done:
                eng.decode_step_batch([seq])
            eng.pool.release(seq)
            check(eng.pool.pages_in_use == 0,
                  f"{name} {how} prefill: {eng.pool.pages_in_use} pages held")
            res[how] = {"row": row, "tokens": list(seq.tokens),
                        "calls": calls, "ms": ms,
                        "whole_prefills": eng.whole_prompt_prefills - before}
        w, c = res["whole"], res["chunked"]
        check(w["calls"] == 1 and w["whole_prefills"] == 1
              and c["calls"] == -(-n_tokens // chunk)
              and c["whole_prefills"] == 0,
              f"{name}: whole {w['calls']} call(s) / {w['whole_prefills']} "
              f"K3 prefill(s), chunked {c['calls']} / {c['whole_prefills']}")
        check(bool(torch.isfinite(w["row"]).all())
              and bool(torch.isfinite(c["row"]).all()),
              f"{name}: chunked-prefill logits not finite")
        err = (w["row"] - c["row"]).abs().max().item()
        rel = ((w["row"] - c["row"]).norm() / w["row"].norm()).item()
        same = w["tokens"] == c["tokens"]
        moe = any(spec.mlp == "moe" for spec in eng.cfg.pattern)
        check(moe or rel <= 0.1, f"{name}: chunked prefill's first-token "
              f"logits are {rel:.3f} of their norm off the whole prompt's")
        if moe:
            log(f"  {name}: chunked prefill max logit diff {err:.3e}, "
                f"{rel:.3f} of the norm, tokens "
                f"{'equal' if same else 'differ'}: by design, each chunk "
                f"of {chunk} routes on its own with capacity "
                f"int({eng.cfg.capacity_factor} * {chunk} * "
                f"{eng.cfg.num_experts_per_tok} / {eng.cfg.num_experts}), "
                f"the whole prompt with its {n_tokens} tokens' (the JAX "
                f"package's dispatch)")
        elif err > CHUNK_TOL or not same:
            reason = (f"{name}: chunked prefill max logit diff {err:.3e} "
                      f"(tol {CHUNK_TOL:g}), tokens "
                      f"{'equal' if same else 'differ'} ({w['tokens']} whole, "
                      f"{c['tokens']} chunked): bf16 through "
                      f"{eng.cfg.num_layers} layers, the chunks' K/V from "
                      f"GEMMs of {chunk} rows and their attention in fp32 "
                      f"over the gathered pool, the whole prompt's from "
                      f"GEMMs of {n_tokens} rows and K3 (bf16 P), round "
                      f"differently")
            if eng._paged_caches["p0"]["k"].dtype == torch.int8:
                reason += ("; and each chunk reads the earlier chunks' K/V "
                           "back from the int8 pool, quantised, where the "
                           "whole prompt attends over K/V as computed")
            log("  " + reason)
        out[name] = {"max_logit_diff": err, "rel_l2": rel,
                     "tokens_equal": same, "chunks": c["calls"],
                     "whole_ms": w["ms"], "chunked_ms": c["ms"],
                     "first_token": [w["tokens"][0], c["tokens"][0]],
                     "routed_by_chunk": moe}
        log(f"chunked prefill, {name}: {json.dumps(out[name])}")
    return out


def replay_direct(dev, zoo, prompts, *, new_tokens: int = 32) -> list:
    """The direct path's tokens for ``prompts``, in their order: each
    through ``MuxServer.probe`` (which prewarms the selected engine) ->
    ``prefill_into_pages``, every request held until all are admitted,
    then each engine's requests decoded ``decode_batch`` at a time (a
    decode step's rows do not depend on each other: the step's shape is
    fixed).  Each pool must drain."""
    engines, server = zoo["engines"], zoo["server"]
    init_pools(zoo)
    seqs = []
    for prompt in prompts:
        m = int(server.probe(prompt[None])["assign"][0])
        seqs.append((m, engines[m].prefill_into_pages(
            prompt, max_new_tokens=new_tokens)))
    cap = zoo["decode_batch"]
    for m, eng in enumerate(engines):
        mine = [s for mm, s in seqs if mm == m]
        for i in range(0, len(mine), cap):
            active = mine[i:i + cap]
            while active:
                eng.decode_step_batch(active)
                active = [s for s in active if not s.done]
    for m, s in seqs:
        engines[m].pool.release(s)
    for eng in engines:
        eng.shed_prewarmed()
        check(eng.pool.pages_in_use == 0, f"{eng.cfg.name}: "
              f"{eng.pool.pages_in_use} pages held after the replay")
    return [list(s.tokens) for _, s in seqs]


def serve_zoo(dev, zoo, cfgs, prompts, sched_prompts, finite, tag, *,
              new_tokens: int = 32) -> dict:
    """Phase 9's flow on a zoo at full width behind the token-probe mux:
    the decode graphs' checks, the direct path graphed and eager, the
    scheduler path, the same prompts again on the direct path (the
    scheduler's tokens must equal it), a chunked prefill on each engine,
    every sampled logit finite.  Returns the figures, with per model the
    admission ms, TTFT p50 / p99, decode tokens/s and median step ms
    graphed / eager."""
    out = {"decode_graphs": check_decode_graphs(dev, zoo)}
    direct, out["direct_steps"] = serve_direct(dev, zoo, prompts, cfgs,
                                               new_tokens=new_tokens)
    sched = serve_scheduler(dev, zoo, sched_prompts, new_tokens=new_tokens)
    log(f"{tag}, scheduler path: {sched['completed']} requests in "
        f"{sched['wall_s']:.2f} s, {sched['decode_batches']} decode batches "
        f"({sched['mixed_admission_batches']} mixed), launches "
        f"{sched['launches']}")
    for e in sched["engines"]:
        log(f"  {json.dumps(e)}")
    check_scheduler(sched, sched_prompts, cfgs, new_tokens)
    replay = replay_direct(dev, zoo, sched_prompts, new_tokens=new_tokens)
    differ = [i for i, (p, o, t) in enumerate(zip(
        sched_prompts, sched["outs"], replay))
        if list(np.asarray(o)[len(p):]) != t]
    check(not differ, f"{tag}: the scheduler's tokens differ from the "
          f"direct path's on the same prompts for requests {differ}")
    out["chunked_prefill"] = check_chunked_prefill(dev, zoo)
    check(finite["seen"] > 0 and finite["bad"] == 0,
          f"{tag}: {finite['bad']} of {finite['seen']} logits tensors not "
          f"finite")
    by_model = {}
    for m, eng in enumerate(zoo["engines"]):
        name = eng.cfg.name
        se = next(e for e in sched["engines"] if e["model"] == name)
        de = next(e for e in direct["engines"] if e["model"] == name)
        by_model[name] = {
            "admission_ms": [ms for ms, a in zip(direct["prefill_ms"],
                                                 direct["assign"]) if a == m],
            "ttft_p50_ms": se["ttft_p50_ms"], "ttft_p99_ms": se["ttft_p99_ms"],
            "decode_tokens_per_s": {"direct": de["decode_tokens_per_s"],
                                    "scheduler": se["decode_tokens_per_s"]},
            "median_step_ms": {
                "graph": out["direct_steps"][name]["median_step_ms"][0],
                "eager": out["direct_steps"][name]["median_step_ms"][1]},
            "requests": {"direct": de["requests"],
                         "scheduler": se["requests"]},
            "k1_by_form_direct": de["k1_by_form"]}
    out.update(by_model=by_model, direct_launches=direct["launches"],
               scheduler_launches=sched["launches"],
               scheduler_ttft_ms=[sched["ttft_p50_ms"], sched["ttft_p99_ms"]])
    return out


def free_zoo(tag: str) -> float:
    """After a zoo's last reference is dropped: collect, empty the
    cache, and hold the device memory still allocated under 1 GB.
    Returns it in GB."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    log(f"{tag} freed: {held:.3f} GB allocated; largest live CUDA tensors "
        f"{live_cuda_tensors()}")
    check(held < 1.0, f"{tag} still holds {held:.2f} GB of device memory")
    return held


def mla_phase(dev, on_logits, finite, profile: bool) -> dict:
    """Phase 9: minicpm3-4b (MLA, K1's latent form, bf16 latent pool)
    and olmo-1b (int8 pool, K1's int8 form) at full width behind the
    token-probe mux: :func:`serve_zoo` and the pools' dtypes, then the
    launcher's ring path on minicpm3-4b.  Returns the phase's
    figures."""
    import torch
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    finite.update(bad=0, seen=0)
    cfgs = phase9_cfgs()
    new_tokens = 32
    prompts = make_prompts(np.random.default_rng(SEED + 90), PROMPT_VOCAB)
    sched_prompts = make_sched_prompts(np.random.default_rng(SEED + 91),
                                       PROMPT_VOCAB)
    zoo = build_zoo(dev, cfgs, list(MLA_PAGES), prompts + sched_prompts,
                    vocab=PROMPT_VOCAB, dtype=torch.bfloat16,
                    on_logits=on_logits)
    log(f"phase 9 zoo: setup {zoo['setup_s']:.1f} s, threshold "
        f"{zoo['threshold']:.6f}")
    out = serve_zoo(dev, zoo, cfgs, prompts, sched_prompts, finite,
                    "phase 9", new_tokens=new_tokens)
    out["pools"] = check_phase9_pools(zoo)
    if profile:
        rng = np.random.default_rng(SEED + 94)
        out["prefill_profile"] = profile_prefill(zoo["engines"][0], rng,
                                                 1024)
        log(f"  phase 9 prefill profile {json.dumps(out['prefill_profile'])}")
        prof_run = serve(dev, zoo, prompts, new_tokens=new_tokens,
                         profile_step=2)
        out["decode_step_profile"] = {e["model"]: e["profile"]
                                      for e in prof_run["engines"]}
        for name, p in out["decode_step_profile"].items():
            log(f"  phase 9 graphed decode step profile {name}: "
                f"{json.dumps(p)}")
    del zoo
    gc.collect()
    torch.cuda.empty_cache()
    finite.update(bad=0, seen=0)
    ops.reset_launches()
    ring = serve_ring(dev, "minicpm3-4b", prompt_len=512, new_tokens=16,
                      step_times=16, profile=profile, on_logits=on_logits)
    log(f"phase 9, minicpm3-4b ring path: {json.dumps(ring)}")
    check_ring(ring, scan=False)
    check(finite["seen"] > 0 and finite["bad"] == 0,
          f"phase 9 ring: {finite['bad']} of {finite['seen']} logits tensors "
          f"not finite")
    out["ring"] = {k: ring[k] for k in RING_KEYS}
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 9, MLA and int8 pools served: {out['wall_s']:.1f} s wall")
    return out


RING_KEYS = ("prefill_ms", "decode_tokens_per_s", "eager_decode_tokens_per_s",
             "median_decode_step_ms", "capture_s", "steps", "prefills",
             "launches", "profile")


# ---------------------------------------------------------------------------
# Phase 10: the zoo's remaining models served (gemma2-27b, olmoe-1b-7b)
# ---------------------------------------------------------------------------

ZOO_MAX_LEN = 8192           # gemma2's zoo: prompts past its 4096 window
# pages of 64: olmo-1b 3.2 GB, gemma2-27b 7.7 GB (46 layers x 2 x 16 x 128
# bf16 = 0.377 MB a token) beside 54.5 GB of gemma2 weights
ZOO_A_PAGES = (384, 320)
ZOO_B_PAGES = (512, 512)     # olmo-1b 4.3 GB, olmoe-1b-7b 4.3 GB
LONG_PROMPTS = (4608, 5100)  # gemma2 past its window, not page multiples
WINDOW_TOKENS = 8            # greedy tokens of the ring / paged cross-check


def zoo_a_cfgs():
    from repro_torch.configs import get_config
    return [get_config("olmo-1b"), get_config("gemma2-27b")]


def zoo_b_cfgs():
    from repro_torch.configs import get_config
    return [get_config("olmo-1b"), get_config("olmoe-1b-7b")]


def weights_read(eng) -> dict:
    """The weight bytes one paged decode step reads, over HBM bandwidth:
    every parameter but an untied embedding table (a step gathers B of
    its rows); with MoE also the bytes one token's top-k experts would
    read, where the reference's dispatch runs every expert."""
    cfg = eng.cfg
    total = sum(t.numel() * t.element_size() for t in _leaves(eng.params))
    if not cfg.tie_embeddings:
        total -= eng.params["embed"].numel() * eng.params["embed"].element_size()
    out = {"weights_read_gb": total / 1e9,
           "weights_read_ms": total / HBM_BYTES_PER_S * 1e3}
    experts = sum(t.numel() * t.element_size()
                  for blk in eng.params["blocks"].values() if "moe" in blk
                  for k, t in blk["moe"].items() if k in ("up", "gate", "down"))
    if experts:
        active = total - experts * (1 - cfg.num_experts_per_tok
                                    / cfg.num_experts)
        out.update(expert_weights_gb=experts / 1e9,
                   active_weights_gb=active / 1e9,
                   active_weights_ms=active / HBM_BYTES_PER_S * 1e3)
    return out


def serve_long_prompts(dev, eng, pages: int) -> dict:
    """gemma2's engine alone, whatever the mux would pick: prompts past
    its 4096-token window admitted whole (K3 with the window in every
    swa layer) on a fresh pool, then decoded together (K1 with the
    window).  Checks the launches by layer kind: K3 layers x prefills,
    ``flash_attention_window`` swa layers x prefills, K1 layers x steps,
    ``paged_attention_window`` swa layers x steps; every logit finite;
    the pool drains.  Returns each prefill's ms and the launches."""
    import torch
    from repro_torch.kernels import ops
    cfg, lengths, new_tokens = eng.cfg, LONG_PROMPTS, WINDOW_TOKENS
    rng = np.random.default_rng(SEED + 104)
    prompts = [rng.integers(0, PROMPT_VOCAB, n).astype(np.int32)
               for n in lengths]
    eng.init_paged(num_pages=pages, page_size=64, decode_batch=8,
                   logit_cache=8)
    eng.capture_decode_steps()
    ops.reset_launches()
    seqs, prefill_ms = [], []
    for p in prompts:
        t = time.perf_counter()
        seqs.append(eng.prefill_into_pages(p, max_new_tokens=new_tokens))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
    prefilled = dict(ops.launches)
    steps = 0
    while not all(s.done for s in seqs):
        eng.decode_step_batch([s for s in seqs if not s.done])
        steps += 1
    launches = dict(ops.launches)
    for s in seqs:
        check(len(s.tokens) == new_tokens,
              f"{cfg.name}: a long prompt made {len(s.tokens)} tokens")
        eng.pool.release(s)
    check(eng.pool.pages_in_use == 0,
          f"{cfg.name}: {eng.pool.pages_in_use} pages held after the long "
          f"prompts")
    n, swa = len(prompts), window_layers(cfg)
    want = {"flash_attention": cfg.num_layers * n,
            "flash_attention_wgmma": cfg.num_layers * n,
            "flash_attention_window": swa * n,
            "paged_attention": cfg.num_layers * steps,
            "paged_attention_window": swa * steps}
    got = {k: launches[k] for k in want}
    check(swa > 0 and got == want and prefilled["paged_attention"] == 0,
          f"{cfg.name} long prompts: launches {got}, expected {want} "
          f"({n} prefills, {steps} steps, {swa} swa layers)")
    out = {"prompt_tokens": list(lengths), "prefill_ms": prefill_ms,
           "decode_steps": steps, "launches": got}
    log(f"{cfg.name} past its window: {json.dumps(out)}")
    return out


def window_cross_check(dev, eng, pages: int) -> dict:
    """One prompt past the window on both of gemma2's cache paths: the
    paged path (``prefill_into_pages``: K3 over the page-padded prompt,
    then K1 decode steps with the window over the pool) and the same
    engine's ``generate`` (the ring path: K3 over the prompt, the swa
    layers' 4096-slot ring wrapped by the prefill, the full layers'
    holding everything, ring decode steps), each feeding its own greedy
    tokens.  The first-token logits must agree within ``CHUNK_TOL`` and
    the tokens be the same, or the reason is logged; logits more than a
    tenth of their norm apart, at the first token or at a step both
    paths reached with the same tokens, fail."""
    import torch
    n_tokens, new_tokens = LONG_PROMPTS[-1], WINDOW_TOKENS
    rng = np.random.default_rng(SEED + 105)
    prompt = rng.integers(0, PROMPT_VOCAB, n_tokens).astype(np.int32)
    eng.init_paged(num_pages=pages, page_size=64, decode_batch=8,
                   logit_cache=8)
    eng.capture_decode_steps()
    paged, ring = [], []
    sample_rows = eng._sample_rows

    def recorded(logits, *args, **kw):
        paged.append(torch.as_tensor(logits)[0].float().cpu())
        return sample_rows(logits, *args, **kw)
    eng._sample_rows = recorded
    try:
        seq = eng.prefill_into_pages(prompt, max_new_tokens=new_tokens)
        while not seq.done:
            eng.decode_step_batch([seq])
    finally:
        eng._sample_rows = sample_rows
    eng.pool.release(seq)
    pick = eng._pick

    def picked(logits, *args, **kw):
        ring.append(logits[0].float().cpu())
        return pick(logits, *args, **kw)
    eng._pick = picked
    try:
        res = eng.generate(prompt[None], max_new_tokens=new_tokens)
    finally:
        eng._pick = pick
    ring_tokens = res["tokens"][0, n_tokens:].tolist()
    check(len(paged) == len(ring) == new_tokens,
          f"{eng.cfg.name}: {len(paged)} paged and {len(ring)} ring logits "
          f"rows for {new_tokens} tokens")
    steps = []
    for i, (a, b) in enumerate(zip(paged, ring)):
        if i and seq.tokens[:i] != ring_tokens[:i]:
            break                    # the paths fed different tokens
        steps.append({"max_diff": (a - b).abs().max().item(),
                      "rel_l2": ((a - b).norm() / a.norm()).item()})
    same = seq.tokens == ring_tokens
    first = steps[0]
    worst = max(st["rel_l2"] for st in steps)
    check(bool(all(torch.isfinite(x).all() for x in paged + ring)),
          f"{eng.cfg.name}: non-finite logits on the paged or ring path")
    check(worst <= 0.1, f"{eng.cfg.name}: the paged and ring paths' logits "
          f"are {worst:.3f} of their norm apart past the window")
    if first["max_diff"] > CHUNK_TOL or not same:
        log(f"  {eng.cfg.name} window cross-check: first-token max logit "
            f"diff {first['max_diff']:.3e} (tol {CHUNK_TOL:g}), tokens "
            f"{'equal' if same else 'differ'} (paged {seq.tokens}, ring "
            f"{ring_tokens}): bf16 through {eng.cfg.num_layers} layers, the "
            f"paged prefill's GEMMs over {-(-n_tokens // 64) * 64} padded "
            f"rows and the ring's over {n_tokens}; decode attends through "
            f"K1 over bf16 pages (bf16 P) on one path and in fp32 over the "
            f"ring on the other")
    out = {"prompt_tokens": n_tokens, "first_token": [seq.tokens[0],
                                                      ring_tokens[0]],
           "tokens_equal": same, "steps_compared": len(steps),
           "first_max_diff": first["max_diff"],
           "first_rel_l2": first["rel_l2"], "worst_rel_l2": worst,
           "by_step": steps, "ring_prefill_ms": res["prefill_s"] * 1e3}
    log(f"{eng.cfg.name} window cross-check: {json.dumps(out)}")
    return out


def zoo_phase(dev, on_logits, finite, profile: bool) -> dict:
    """Phase 10, the rest of the reference's single-card LLM zoo served:
    zoo A, olmo-1b + gemma2-27b at their published configs (random bf16
    weights, both engines at ``max_len`` 8192), through
    :func:`serve_zoo`, gemma2's prompts past its window
    (:func:`serve_long_prompts`) and its paged against its ring path
    there (:func:`window_cross_check`); then zoo B, olmo-1b +
    olmoe-1b-7b, through :func:`serve_zoo` and olmoe on the launcher's
    ring path.  Returns the phase's figures."""
    import torch
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    out = {}
    for key, cfgs, pages, max_len in (("A", zoo_a_cfgs(), ZOO_A_PAGES,
                                       ZOO_MAX_LEN),
                                      ("B", zoo_b_cfgs(), ZOO_B_PAGES, 2048)):
        finite.update(bad=0, seen=0)
        tag = f"phase 10 zoo {key}"
        prompts = make_prompts(np.random.default_rng(SEED + 100),
                               PROMPT_VOCAB)
        sched_prompts = make_sched_prompts(np.random.default_rng(SEED + 101),
                                           PROMPT_VOCAB)
        zoo = build_zoo(dev, cfgs, list(pages), prompts + sched_prompts,
                        max_len=max_len, vocab=PROMPT_VOCAB,
                        dtype=torch.bfloat16, on_logits=on_logits)
        built = torch.cuda.memory_allocated() / 1e9
        log(f"{tag} ({', '.join(c.name for c in cfgs)}): setup "
            f"{zoo['setup_s']:.1f} s, threshold {zoo['threshold']:.6f}, "
            f"{built:.3f} GB allocated")
        res = serve_zoo(dev, zoo, cfgs, prompts, sched_prompts, finite, tag)
        res.update(setup_s=zoo["setup_s"], memory_gb_built=built,
                   max_len=max_len, pages=list(pages))
        for name, read in [(e.cfg.name, weights_read(e))
                           for e in zoo["engines"]]:
            res["by_model"][name].update(read)
        big = zoo["engines"][1]
        if key == "A":
            res["long_prompts"] = serve_long_prompts(dev, big, pages[1])
            res["window_cross_check"] = window_cross_check(dev, big, pages[1])
        if profile:
            rng = np.random.default_rng(SEED + 106)
            res["prefill_profile"] = profile_prefill(big, rng, 1024)
            log(f"  {tag} prefill profile "
                f"{json.dumps(res['prefill_profile'])}")
            prof_run = serve(dev, zoo, prompts, profile_step=2)
            res["decode_step_profile"] = {e["model"]: e["profile"]
                                          for e in prof_run["engines"]}
            for name, p in res["decode_step_profile"].items():
                log(f"  {tag} graphed decode step profile {name}: "
                    f"{json.dumps(p)}")
        res["memory_gb_peak"] = torch.cuda.max_memory_allocated() / 1e9
        check(finite["seen"] > 0 and finite["bad"] == 0,
              f"{tag}: {finite['bad']} of {finite['seen']} logits tensors "
              f"not finite")
        out[key] = res
        del zoo, big
        res["memory_gb_freed"] = free_zoo(tag)
        torch.cuda.reset_peak_memory_stats()
    finite.update(bad=0, seen=0)
    ops.reset_launches()
    ring = serve_ring(dev, "olmoe-1b-7b", prompt_len=512, new_tokens=16,
                      step_times=16, profile=profile, on_logits=on_logits)
    log(f"phase 10, olmoe-1b-7b ring path: {json.dumps(ring)}")
    check_ring(ring, scan=False)
    check(finite["seen"] > 0 and finite["bad"] == 0,
          f"phase 10 ring: {finite['bad']} of {finite['seen']} logits "
          f"tensors not finite")
    out["olmoe_ring"] = {k: ring[k] for k in RING_KEYS}
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 10, the zoo's remaining models served: {out['wall_s']:.1f} s "
        f"wall")
    return out


# ---------------------------------------------------------------------------
# Phase 11: speculative multiplexed decoding (SpeculativeBackend)
# ---------------------------------------------------------------------------

SPEC_DRAFT_K = 4
SPEC_NEW_TOKENS = 24
SPEC_MAX_LEN = 2048
SPEC_PAGES = (160, 160)      # target (32 layers, 2.7 GB), draft (1.3 GB)
SPEC_EASY = (128, 160, 200, 256, 300, 384, 459, 512)     # k = SPEC_DRAFT_K
SPEC_HARD = (1024, 1024)                                 # k = 0, plain
SPEC_RATE = 4.0              # Poisson arrivals a second
SPEC_ACCEPT_MIN = 0.9        # the structural pair's accepted / drafted
SPEC_NEAR_TIE = 0.0625       # plain margin a first divergence may have
SPEC_LOGIT_ABS = 0.1         # |spec - plain| logit, over compared positions
SPEC_LOGIT_REL = 0.03        # ||spec - plain|| / ||plain||, each position
SPEC_TIMED = 10              # calls a timed step (median host ms)


def spec_cfgs():
    """(draft, target): olmo-1b at its published config, and the same
    layers followed by as many again (the target's depth)."""
    from repro_torch.configs import get_config
    d = get_config("olmo-1b")
    return d, d.with_(name=f"{d.name}-x2", num_layers=2 * d.num_layers)


def surgery_params(dparams, extra):
    """Target params: the draft's layers followed by ``extra``'s (another
    draw of the draft's config) with their attention ``wo`` and MLP
    ``down`` zeroed, so that they add exactly 0 to the residual stream;
    the draft's embedding and final norm (olmo-1b ties its head), so
    the target's logits are the draft's at twice the layers.  The weight
    surgery of ``benchmarks/bench_spec_decode.py``."""
    import torch

    def cat(d, e, name):
        if isinstance(d, dict):
            return {k: cat(d[k], e[k], k) for k in d}
        return torch.cat([d, torch.zeros_like(e) if name in ("wo", "down")
                          else e], 0)
    out = {k: v for k, v in dparams.items() if k != "blocks"}
    out["blocks"] = cat(dparams["blocks"], extra["blocks"], "blocks")
    return out


def spec_prompts(rng, vocab: int) -> list:
    """8 easy prompts (128-512 tokens) and 2 hard ones (1024), shuffled."""
    lens = list(SPEC_EASY) + list(SPEC_HARD)
    return [rng.integers(0, vocab, lens[i]).astype(np.int32)
            for i in rng.permutation(len(lens))]


def spec_k(prompt) -> int:
    """The draft length a prompt gets: a length threshold, as the JAX
    benchmark's ``probe_k`` stands in for the mux probe's score."""
    return 0 if len(prompt) >= SPEC_HARD[0] else SPEC_DRAFT_K


def spec_engine(dev, cfg, params, pages, *, max_len, lazy):
    from repro_torch.serving.engine import Engine, ServeConfig
    eng = Engine(cfg, params, ServeConfig(max_len=max_len), device=dev)
    eng.init_paged(num_pages=pages, page_size=64, decode_batch=8,
                   span_reclaim=not lazy, lazy_decode_alloc=lazy)
    return eng


class StepLog:
    """Counts an engine's decode steps and the K1 launches they make
    (``ops.launches`` read around each call: the phase's device calls
    run one at a time); with ``logits``, keeps each row's logits by
    (prompt bytes, token index) on the device and counts non-finite
    entries (read once, after the run)."""

    def __init__(self, eng, logits=None):
        self.eng, self.logits = eng, logits
        self.steps = self.k1 = self.seen = 0
        self.nonfinite = 0
        self._rows = None
        eng.decode_step_batch = self._decode
        if logits is not None:
            eng._sample_rows = self._sample

    def _decode(self, seqs):
        from repro_torch.kernels import ops
        before = ops.launches["paged_attention"]
        self._rows = list(seqs)
        try:
            return type(self.eng).decode_step_batch(self.eng, seqs)
        finally:
            self._rows = None
            self.steps += 1
            self.k1 += ops.launches["paged_attention"] - before

    def _sample(self, logits, seeds, positions, temps=None):
        import torch
        rows = self._rows
        if rows:
            live = logits[:len(rows)].clone()
            self.seen += 1
            self.nonfinite = self.nonfinite + (~torch.isfinite(live)).sum()
            for r, seq in enumerate(rows):
                self.logits[(seq.prompt.tobytes(), len(seq.tokens))] = \
                    live[r]
        return type(self.eng)._sample_rows(self.eng, logits, seeds,
                                           positions, temps=temps)

    def close(self) -> None:
        self.eng.__dict__.pop("decode_step_batch", None)
        self.eng.__dict__.pop("_sample_rows", None)


class VerifyLog:
    """Holds each verify step's logits against the plain run's where the
    fed context (the row's tokens and the drafts before an offset)
    equals the plain stream's: by (prompt bytes, token index), the
    largest |verify - plain| logit difference and its norm over the
    plain logits' norm (one host read a step)."""

    def __init__(self, eng, plain_logits, plain_tokens):
        self.eng, self.plain, self.ptoks = eng, plain_logits, plain_tokens
        self.diffs = {}
        self._rows = None
        self._inner = eng._paged_verify
        eng.verify_step_batch = self._verify
        eng._paged_verify = self._step

    def _verify(self, rows, *, width):
        self._rows = list(rows)
        try:
            return type(self.eng).verify_step_batch(self.eng, rows,
                                                    width=width)
        finally:
            self._rows = None

    def _step(self, packed):
        import torch
        logits = self._inner(packed)
        keys, got, want = [], [], []
        for i, (seq, drafts) in enumerate(self._rows or ()):
            pk = seq.prompt.tobytes()
            ctx = list(seq.tokens) + [int(d) for d in drafts]
            for r in range(len(drafts) + 1):
                t = len(seq.tokens) + r
                if (pk, t) in self.plain and ctx[:t] == self.ptoks[pk][:t]:
                    keys.append((pk, t))
                    got.append(logits[i, r])
                    want.append(self.plain[(pk, t)])
        if keys:
            want = torch.stack(want).float()
            d = torch.stack(got).float() - want
            stats = torch.stack([d.abs().amax(-1), d.norm(dim=-1)
                                 / want.norm(dim=-1)], -1).cpu().numpy()
            for key, (mx, rel) in zip(keys, stats):
                self.diffs[key] = (float(mx), float(rel))
        return logits

    def close(self) -> None:
        self.eng.__dict__.pop("verify_step_batch", None)
        self.eng._paged_verify = self._inner


class VerifyShadow:
    """Stands in for the target's graphed verify step: call ``at`` goes
    through a :class:`ShadowStep` (the eager step, then the graph, on
    the same operand); every other call replays the graph alone."""

    def __init__(self, graphed, at: int):
        self.graphed, self.at, self.calls = graphed, at, 0
        self.shadow = ShadowStep(graphed, "phase 11 verify")

    def __call__(self, packed):
        self.calls += 1
        step = self.shadow if self.calls == self.at else self.graphed
        return step(packed)

    @property
    def result(self):
        return self.shadow.calls[0] if self.shadow.calls else None


def spec_serve(dev, backend, prompts, logs) -> dict:
    """The prompts through ``PagedLLMScheduler`` over ``backend`` (one
    model, whole-prompt prefill), open-loop at Poisson ``SPEC_RATE``
    (seed ``SEED``), ``SPEC_NEW_TOKENS`` greedy tokens each, after the
    scheduler's warmup (captures included).  ``logs`` makes the
    :class:`StepLog` of each engine once warmup is done.  Returns the
    tokens, the snapshot, the launches and the step logs of the run."""
    import asyncio

    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.scheduler import (PagedLLMConfig,
                                               PagedLLMScheduler,
                                               TrafficConfig, arrival_times,
                                               replay)
    sched = PagedLLMScheduler(
        backends=[backend], cfg=PagedLLMConfig(
            max_new_tokens=SPEC_NEW_TOKENS, prefill_chunk_pages=0))
    t0 = time.perf_counter()
    sched.warmup(sorted({len(p) for p in prompts}))
    warm_s = time.perf_counter() - t0
    times = arrival_times(TrafficConfig(rate=SPEC_RATE,
                                        num_requests=len(prompts), seed=SEED))
    steps = logs()

    async def run():
        async with sched:
            futs = await replay(sched.submit, prompts, times)
            return await asyncio.gather(*futs)

    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        outs = asyncio.run(run())
    finally:
        for log_ in steps.values():
            log_.close()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = sched.snapshot()
    busy = sched.metrics.per_model_busy_s[0]         # decode sweeps
    check(snap["completed"] == len(prompts) and snap["failed"] == 0,
          f"spec phase: {snap['completed']} of {len(prompts)} answered, "
          f"{snap['failed']} failed")
    return {"tokens": [list(np.asarray(o)[len(p):])
                       for p, o in zip(prompts, outs)],
            "snap": snap, "launches": dict(ops.launches), "steps": steps,
            "wall_s": wall, "warmup_s": warm_s,
            "decode_tokens_per_s": snap["tokens_generated"] / busy,
            "decode_batches": snap["decode_batches"]}


def decode_diffs(logits, plain_logits, got, want, prompts) -> dict:
    """The spec run's decode-step logits against the plain run's where
    the committed context equals the plain stream's (the target decodes
    the rows that do not speculate, over K/V that verify steps wrote):
    by (prompt bytes, token index), as ``VerifyLog.diffs``."""
    toks = {p.tobytes(): (g, w) for p, g, w in zip(prompts, got, want)}
    out = {}
    for (pk, t), row in logits.items():
        g, w = toks[pk]
        if (pk, t) in plain_logits and g[:t] == w[:t]:
            want = plain_logits[(pk, t)].float()
            d = row.float() - want
            out[(pk, t)] = (float(d.abs().max()),
                            float(d.norm() / want.norm()))
    return out


def same_stream(tag, prompts, got, want, plain_logits, diffs) -> dict:
    """Each request's spec tokens against the plain target's, and the
    spec logits against the plain logits where the fed context equals
    the plain stream's (``diffs``, from verify and decode steps alike):
    the largest |spec - plain| difference within ``SPEC_LOGIT_ABS`` and
    that of every position within ``SPEC_LOGIT_REL`` of the plain
    logits' norm.  The tokens are equal, or first different at a
    near-tie, which is logged and allowed: where the plain logit of the
    plain pick exceeds that of the spec pick by at most
    ``SPEC_NEAR_TIE``.  Any other divergence fails.  Returns the
    differences' summary and the near-ties."""
    import torch
    check(len(diffs) > 0, f"{tag}: no position compared with plain")
    mxs = [mx for mx, _ in diffs.values()]
    rels = [r for _, r in diffs.values()]
    out = {"positions_compared": len(diffs), "max_abs_diff": max(mxs),
           "median_max_abs_diff": float(np.median(mxs)),
           "max_rel_norm_diff": max(rels), "near_ties": []}
    check(out["max_abs_diff"] <= SPEC_LOGIT_ABS
          and out["max_rel_norm_diff"] <= SPEC_LOGIT_REL,
          f"{tag}: spec logits against plain where the contexts agree: "
          f"max {out['max_abs_diff']:.4g} (limit {SPEC_LOGIT_ABS:g}), rel "
          f"norm {out['max_rel_norm_diff']:.3g} (limit {SPEC_LOGIT_REL:g}) "
          f"over {len(diffs)} positions")
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        check(len(g) == len(w) == SPEC_NEW_TOKENS,
              f"{tag}: request {i} made {len(g)} / {len(w)} tokens")
        if g == w:
            continue
        j = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        row = plain_logits[(p.tobytes(), j)].float()
        top, idx = torch.topk(row, 2)
        gap = float(row[w[j]] - row[g[j]])
        mx, rel = diffs.get((p.tobytes(), j), (float("nan"), float("nan")))
        msg = (f"{tag}: request {i} ({len(p)} tokens) first differs from "
               f"plain decode at token {j} ({g[j]} != {w[j]}): plain logits "
               f"{gap:.4g} apart (limit {SPEC_NEAR_TIE:g}; plain top-2 "
               f"{top.tolist()}, ids {idx.tolist()}), spec against plain "
               f"there max {mx:.4g}, rel norm {rel:.3g}")
        check(gap <= SPEC_NEAR_TIE, msg)
        log(f"  near-tie: {msg}")
        out["near_ties"].append({"request": i, "token": j, "gap": gap,
                                 "top": float(top[0]), "max_abs_diff": mx,
                                 "rel_norm_diff": rel})
    return out


def spec_timings(dev, target, draft, prompts) -> dict:
    """On 8 live rows of the easy prompts: ``verify_step_batch`` at
    (8, draft_k + 1) graphed and eager, the target's and the draft's
    decode steps graphed (median host ms of ``SPEC_TIMED`` calls, each
    to its picks on the host)."""
    easy = [p for p in prompts if spec_k(p)][:8]

    def median_ms(fn):
        fn()
        out = []
        for _ in range(SPEC_TIMED):
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
        return float(np.median(out))

    out = {}
    rows = [target.prefill_into_pages(p, max_new_tokens=SPEC_NEW_TOKENS)
            for p in easy]
    vrows = [(s, [int(s.last_token)] * SPEC_DRAFT_K) for s in rows]
    width = SPEC_DRAFT_K + 1
    graph = target._paged_verify
    out["verify_ms"] = {"graph": median_ms(
        lambda: target.verify_step_batch(vrows, width=width))}
    target._paged_verify = _eager(graph)
    try:
        out["verify_ms"]["eager"] = median_ms(
            lambda: target.verify_step_batch(vrows, width=width))
    finally:
        target._paged_verify = graph
    out["target_step_ms"] = median_ms(lambda: target.decode_step_batch(rows))
    for s in rows:
        target.pool.release(s)
    drows = [draft.prefill_into_pages(p, max_new_tokens=SPEC_NEW_TOKENS)
             for p in easy]
    out["draft_step_ms"] = median_ms(lambda: draft.decode_step_batch(drows))
    for s in drows:
        draft.pool.release(s)
    return out


def spec_rates(dev, target, make_draft, prompts) -> dict:
    """Decode tokens/s of the plain target and of the structural pair
    through ``spec_serve`` with no logging (the checked runs clone every
    decode step's logits and read each verify step's differences on the
    host): plain, spec, spec, plain, each on fresh pools and a fresh
    draft engine."""
    from repro_torch.serving.backend import InProcessBackend
    from repro_torch.serving.spec_decode import SpeculativeBackend
    out = {"plain": [], "spec": []}
    for kind in ("plain", "spec", "spec", "plain"):
        target.init_paged(num_pages=SPEC_PAGES[0], page_size=64,
                          decode_batch=8)
        backend = InProcessBackend(target)
        if kind == "spec":
            backend = SpeculativeBackend(backend, make_draft(),
                                         draft_k=SPEC_DRAFT_K, k_fn=spec_k)
        out[kind].append(spec_serve(dev, backend, prompts,
                                    dict)["decode_tokens_per_s"])
        del backend
        gc.collect()
    out["speedup"] = float(np.mean(out["spec"]) / np.mean(out["plain"]))
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def spec_phase(dev) -> dict:
    """Phase 11: speculative multiplexed decoding at full width under
    ``PagedLLMScheduler``, ``SpeculativeBackend(InProcessBackend(target),
    draft)`` against a plain ``InProcessBackend`` on the same target.
    Returns the phase's figures."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serving.backend import InProcessBackend
    from repro_torch.serving.spec_decode import SpeculativeBackend

    t0 = time.perf_counter()
    dcfg, tcfg = spec_cfgs()
    params = [tf.init_params(dcfg, torch.Generator(device=dev).manual_seed(
        SEED + 200 + i), device=dev, dtype=torch.bfloat16) for i in range(2)]
    tparams = surgery_params(params[0], params[1])
    target = spec_engine(dev, tcfg, tparams, SPEC_PAGES[0],
                         max_len=SPEC_MAX_LEN, lazy=False)
    draft_len = -(-(SPEC_MAX_LEN + SPEC_DRAFT_K) // 64) * 64
    prompts = spec_prompts(np.random.default_rng(SEED + 201), dcfg.vocab_size)
    layers = {"target": tcfg.num_layers, "draft": dcfg.num_layers}
    out = {"card": card(), "draft_k": SPEC_DRAFT_K,
           "prompt_lens": [len(p) for p in prompts],
           "weights_read": {"target": weights_read(target)}}

    # plain: every token one target decode step
    plain_logits = {}
    plain = spec_serve(dev, InProcessBackend(target), prompts,
                       lambda: {"target": StepLog(target, plain_logits)})
    plain_tokens = {p.tobytes(): t for p, t in zip(prompts, plain["tokens"])}
    log_ = plain["steps"]["target"]
    bad = int(log_.nonfinite)
    check(log_.seen > 0 and bad == 0,
          f"spec phase plain: {bad} logits not finite over {log_.seen} steps")
    check(target.pool.pages_in_use == 0,
          f"spec phase plain: {target.pool.pages_in_use} pages held")
    out["plain"] = {"decode_batches": plain["decode_batches"],
                    "wall_s": plain["wall_s"]}
    log(f"phase 11 plain target: {json.dumps(out['plain'])}")

    for pair, dparams in (("structural", params[0]), ("diverse", params[1])):
        draft = spec_engine(dev, dcfg, dparams, SPEC_PAGES[1],
                            max_len=draft_len, lazy=True)
        target.init_paged(num_pages=SPEC_PAGES[0], page_size=64,
                          decode_batch=8)
        spec = SpeculativeBackend(InProcessBackend(target), draft,
                                  draft_k=SPEC_DRAFT_K, k_fn=spec_k)
        shadow, spec_logits = {}, {}

        def logs():
            if pair == "structural":       # one verify call, mid-run
                shadow["v"] = VerifyShadow(target._paged_verify, 3)
                target._paged_verify = shadow["v"]
            return {"target": StepLog(target, spec_logits),
                    "draft": StepLog(draft),
                    "verify": VerifyLog(target, plain_logits, plain_tokens)}
        try:
            run = spec_serve(dev, spec, prompts, logs)
        finally:
            if "v" in shadow:
                target._paged_verify = shadow["v"].graphed
        stats = spec.stats()
        k1 = {name: (lg.steps, lg.k1) for name, lg in run["steps"].items()
              if name != "verify"}
        accept = stats["accepted_tokens"] / max(stats["draft_tokens"], 1)
        row = {"draft_tokens": stats["draft_tokens"],
               "accepted_tokens": stats["accepted_tokens"],
               "acceptance": accept,
               "spec_fallbacks": stats["spec_fallbacks"],
               "verify_rounds": stats["verify_rounds"],
               "peak_draft_pages": stats["draft_pool"]["peak_pages_in_use"],
               "decode_batches": run["decode_batches"],
               "wall_s": run["wall_s"], "warmup_s": run["warmup_s"],
               "steps": {name: s for name, (s, _) in k1.items()},
               "k1_launches": run["launches"]["paged_attention"],
               "tokens_equal_plain": sum(
                   g == w for g, w in zip(run["tokens"], plain["tokens"]))}
        if pair == "structural":
            row["verify_graph_vs_eager"] = shadow["v"].result
            row["verify_capture_s"] = target.capture_s.get(
                f"paged_verify_w{SPEC_DRAFT_K + 1}")
            row.update(spec_timings(dev, target, draft, prompts))
            out["weights_read"]["draft"] = weights_read(draft)
        log(f"phase 11 {pair} pair ({out['card']}): {json.dumps(row)}")
        diffs = decode_diffs(spec_logits, plain_logits, run["tokens"],
                             plain["tokens"], prompts)
        row["verify_positions_compared"] = len(run["steps"]["verify"].diffs)
        check(row["verify_positions_compared"] > 0,
              f"spec phase {pair}: no verify position compared with plain")
        diffs.update(run["steps"]["verify"].diffs)
        row["against_plain"] = same_stream(
            f"phase 11 {pair}", prompts, run["tokens"], plain["tokens"],
            plain_logits, diffs)
        check(not spec._spec_dead, f"spec phase {pair}: speculation was "
              f"turned off by a draft-engine error")
        check(stats["pool"]["pages_in_use"] == 0
              and stats["draft_pool"]["pages_in_use"] == 0,
              f"spec phase {pair}: pages held after the run: target "
              f"{stats['pool']['pages_in_use']}, draft "
              f"{stats['draft_pool']['pages_in_use']}")
        for name, (steps, n) in k1.items():
            check(steps > 0 and n == layers[name] * steps,
                  f"spec phase {pair}: {n} K1 launches over {steps} {name} "
                  f"steps of {layers[name]} layers")
        check(run["launches"]["paged_attention"] == sum(n for _, n in
                                                        k1.values()),
              f"spec phase {pair}: K1 launched {run['launches']} beyond "
              f"the decode steps {k1}: a verify step launched K1")
        if pair == "structural":
            check(accept >= SPEC_ACCEPT_MIN,
                  f"spec phase: structural acceptance {accept:.3f} < "
                  f"{SPEC_ACCEPT_MIN}")
            v = row["verify_graph_vs_eager"]
            check(v is not None and v["bitwise"],
                  f"spec phase: the verify graph against the eager verify "
                  f"step: {v}")
            if dev.type == "cuda":
                tally = target._paged_verify.replay_launches(torch.zeros(
                    (8, SPEC_DRAFT_K + 2 + target._max_pages),
                    dtype=torch.int32, device=dev))
                check(not tally, f"spec phase: a verify step launches "
                      f"{tally}")
        else:
            check(stats["spec_fallbacks"] >= 1,
                  "spec phase: the diverse pair never fell back")
        out[pair] = row
        del spec, draft
        gc.collect()
    out["rates"] = spec_rates(dev, target, lambda: spec_engine(
        dev, dcfg, params[0], SPEC_PAGES[1], max_len=draft_len, lazy=True),
        prompts)
    log(f"phase 11 decode tokens/s, no logging ({out['card']}): "
        f"{json.dumps(out['rates'])}")
    del target, tparams, params, plain_logits
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 11, speculative decoding: {out['wall_s']:.1f} s wall")
    return out


# ---------------------------------------------------------------------------
# Phase 7: the paper's image mux (CNN zoo, 4-conv probe, K2's meta form)
# ---------------------------------------------------------------------------

IMAGE_TOL = 1e-4            # zoo logits / embeddings, card vs CPU (fp32)
IMAGE_W_TOL = 1e-5          # mux weights, card vs CPU and graph vs eager
SERVE_B = 256               # paper_mux.config().batch_size
SCHED_LOADS = (("poisson", 400.0), ("bursty", 200.0))   # bench_scheduler
SCHED_REQUESTS = 192


def build_image_mux(dev) -> dict:
    """The port's ``paper_mux.config()`` at full width: the six zoo CNNs
    (32x32x3 images, 10 classes) and the 4-conv mux backbone (meta_dim
    64, proj_dim 32), random fp32 weights from a seeded generator, costs
    from ``zoo_costs``, and ``eval_samples`` images drawn from ``SEED``
    (normal, as ``bench_scheduler.py`` draws its requests)."""
    import torch
    from repro_torch.configs import paper_mux
    from repro_torch.core.multiplexer import init_image_backbone, init_mux
    from repro_torch.models import cnn
    cfg = paper_mux.config()
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    zoo = cnn.init_zoo(gen, num_classes=cfg.num_classes, names=cfg.zoo,
                       device=dev)
    costs = cfg.costs()
    mux = init_mux(gen, backbone=init_image_backbone(
        gen, meta_dim=cfg.meta_dim, device=dev), model_names=list(cfg.zoo),
        costs=costs, meta_dim=cfg.meta_dim, proj_dim=cfg.proj_dim,
        device=dev)
    images = np.random.default_rng(SEED).standard_normal(
        (cfg.eval_samples, cfg.image_size, cfg.image_size, 3)
    ).astype(np.float32)
    return {"cfg": cfg, "zoo": zoo, "mux": mux,
            "costs": [costs[n] for n in cfg.zoo], "images": images}


def image_server(im, dev, *, threshold=None, zoo=None, mux=None):
    """A ``MuxServer`` over the image zoo (``model_fns``: each CNN's
    logits) on ``dev``; ``zoo`` / ``mux`` default to the card's params."""
    from repro_torch.models import cnn
    from repro_torch.serving.mux_server import MuxServer, MuxServerConfig
    zoo = im["zoo"] if zoo is None else zoo
    names = im["cfg"].zoo
    fns = [lambda xs, n=n: cnn.cnn_forward(
        zoo[n], xs, convs_per_stage=cnn.ZOO_SPECS[n]["convs_per_stage"])[0]
        for n in names]
    return MuxServer(im["mux"] if mux is None else mux, im["costs"],
                     MuxServerConfig(threshold=threshold), device=dev,
                     model_fns=fns)


def check_image_against_cpu(dev, im) -> float:
    """Every zoo CNN's logits and embeddings and ``serve``'s weights on 16
    images, card against CPU (the same params copied), within
    ``IMAGE_TOL`` / ``IMAGE_W_TOL``; the assignments equal where the top
    two weights are apart.  Returns the largest logit / embedding
    difference."""
    import torch
    from repro_torch.models import cnn
    cpu = torch.device("cpu")
    x = im["images"][:16]
    zoo_c, mux_c = _to_device(im["zoo"], cpu), _to_device(im["mux"], cpu)
    worst = 0.0
    for n in im["cfg"].zoo:
        cps = cnn.ZOO_SPECS[n]["convs_per_stage"]
        got = cnn.cnn_forward(im["zoo"][n], torch.from_numpy(x).to(dev),
                              convs_per_stage=cps)
        want = cnn.cnn_forward(zoo_c[n], torch.from_numpy(x),
                               convs_per_stage=cps)
        err = max((g.cpu() - w).abs().max().item()
                  for g, w in zip(got, want))
        log(f"image zoo {n} on the card vs CPU: max logit / embedding diff "
            f"{err:.3e} tol={IMAGE_TOL:g}")
        check(err <= IMAGE_TOL, f"image zoo {n} card vs CPU: {err:.3e}")
        worst = max(worst, err)
    got = image_server(im, dev).serve(x)
    want = image_server(im, cpu, zoo=zoo_c, mux=mux_c).serve(x)
    w_err = (got["weights"].cpu() - want["weights"]).abs().max().item()
    top = want["weights"].sort(-1).values
    clear = (top[:, -1] - top[:, -2]) > IMAGE_W_TOL
    same = torch.equal(got["assign"].cpu()[clear], want["assign"][clear])
    log(f"image serve on the card vs CPU: max weight diff {w_err:.3e} "
        f"tol={IMAGE_W_TOL:g}, assignments equal on {int(clear.sum())} "
        f"clear rows of 16: {same}")
    check(w_err <= IMAGE_W_TOL and same,
          f"image serve card vs CPU: weights {w_err:.3e}, assign {same}")
    return worst


def same_step(tag, got, want) -> bool:
    """The graphed batch step against the eager one on the same batch:
    bitwise, or weights within ``IMAGE_W_TOL`` and outputs within
    ``IMAGE_TOL`` with the same routing, the reason logged."""
    import torch
    names = ("output", "assign", "kept", "weights", "flops")
    if all(torch.equal(g, w) for g, w in zip(got, want)):
        return True
    diffs = {n: (g.double() - w.double()).abs().max().item()
             for n, g, w in zip(names, got, want)}
    log(f"  {tag}: graphed step not bitwise equal to the eager one "
        f"({diffs}): the graph's kernels are those of its capture (a "
        f"library may pick another algorithm under capture); held within "
        f"{IMAGE_W_TOL:g} / {IMAGE_TOL:g}")
    check(diffs["weights"] <= IMAGE_W_TOL and diffs["output"] <= IMAGE_TOL
          and diffs["assign"] == 0 and diffs["kept"] == 0,
          f"{tag}: graphed step differs from eager: {diffs}")
    return False


def serve_images(dev, im, server, policy: str) -> dict:
    """``MuxServer.serve`` on the ``eval_samples`` images in batches of
    ``SERVE_B``: every output finite, ``assign`` equal to ``select`` on the
    returned weights, ``flops`` equal to ``costs[assign]``, the capacity
    rule (under a threshold every row kept; under argmax a model keeps
    min(its rows, capacity) and an overflowed row is zero), K2 launched
    once a serve (its first call also warms up) and the serve graph's
    capture tallying one K2 launch, the graphed step against the eager
    ``_batch_step`` on every batch.  Times the step graphed and eager
    (CUDA events, the images on the card) and the host microseconds a
    step call, and the wall ms of ``serve`` a batch (host images in,
    host reads of the meter out)."""
    import torch
    from repro_torch.kernels import ops
    xs = im["images"]
    costs = torch.tensor(im["costs"], device=dev)
    n = len(im["costs"])
    cap = (SERVE_B if server.cfg.threshold is not None
           else max(1, int(server.cfg.capacity_factor * SERVE_B / n)))
    walls, k2, flops, called, bitwise = [], [], [], [], 0
    for i in range(len(xs) // SERVE_B):
        x = xs[i * SERVE_B:(i + 1) * SERVE_B]
        torch.cuda.synchronize()
        before = ops.launches["mux_score"]
        t0 = time.perf_counter()
        res = server.serve(x)
        walls.append((time.perf_counter() - t0) * 1e3)
        k2.append(ops.launches["mux_score"] - before)
        tag = f"image serve {policy} batch {i}"
        out, assign, kept = res["output"], res["assign"], res["kept"]
        check(bool(torch.isfinite(out).all())
              and bool(torch.isfinite(res["weights"]).all()),
              f"{tag}: non-finite output")
        check(torch.equal(assign, server.select_eager(res["weights"])),
              f"{tag}: assign is not select on the returned weights")
        check(torch.equal(res["flops"], costs[assign.long()]),
              f"{tag}: flops != costs[assign]")
        counts = torch.bincount(assign.long(), minlength=n)
        kept_by = torch.bincount(assign.long()[kept], minlength=n)
        check(torch.equal(kept_by, counts.clamp(max=cap)),
              f"{tag}: kept {kept_by.tolist()} of {counts.tolist()} at "
              f"capacity {cap}")
        check(not bool(out[~kept].any()), f"{tag}: a dropped row is not 0")
        xd = torch.from_numpy(x).to(dev)
        bitwise += same_step(tag, server._step_graph(xd),
                             server._batch_step(xd))
        flops.append(res["mean_flops"])
        called.append(res["called_fraction"])
    check(k2[0] == 2 and all(c == 1 for c in k2[1:]),
          f"image serve {policy}: K2 launches a serve {k2}")
    check(server._step_graph.replay_launches(xd) == {"mux_score": 1},
          f"image serve {policy}: the serve graph's capture tallied "
          f"{server._step_graph.replay_launches(xd)}")
    step = {"graph": lambda j: server._step_graph(xd),
            "eager": lambda j: server._batch_step(xd)}
    row = {"policy": policy, "capacity": cap, "batches": len(walls),
           "k2_launches": k2, "bitwise_batches": bitwise,
           "serve_wall_ms": walls,
           "serve_wall_ms_median": float(np.median(walls[1:])),
           "mean_flops": float(np.mean(flops)),
           "called_fraction": np.mean(called, axis=0).tolist(),
           "rows_kept": int(kept.sum())}
    for name, fn in step.items():
        row[f"step_{name}_ms"] = time_cuda(fn, iters=20)
        row[f"step_{name}_host_us"] = host_us(fn, calls=20)
    row["images_per_s"] = SERVE_B / (row["serve_wall_ms_median"] / 1e3)
    row["saving_factor"] = max(im["costs"]) / row["mean_flops"]
    log(f"image serve {policy} (capacity {cap}): step graphed "
        f"{row['step_graph_ms']:.3f} ms / eager {row['step_eager_ms']:.3f} "
        f"ms a batch of {SERVE_B} (host {row['step_graph_host_us']:.0f} / "
        f"{row['step_eager_host_us']:.0f} us a call); serve wall "
        f"{row['serve_wall_ms_median']:.3f} ms, {row['images_per_s']:.0f} "
        f"images/s; mean_flops {row['mean_flops']:.4g}, saving "
        f"{row['saving_factor']:.3f}x vs always-largest, called "
        f"{[round(c, 4) for c in row['called_fraction']]}; K2 {k2}; "
        f"graphed step bitwise equal to eager on {bitwise} of "
        f"{len(walls)} batches")
    return row


def image_threshold(server, x) -> float:
    """A threshold on the cheapest model's weight in the widest gap of
    the middle half of its sorted values on ``x``: a quarter to three
    quarters of the rows clear it, so at least two models get traffic."""
    import torch
    w0 = server.probe_eager(torch.from_numpy(x).to(server.device))[:, 0]
    w0 = np.sort(w0.cpu().numpy())
    lo = len(w0) // 4
    i = lo + int(np.argmax(np.diff(w0[lo:len(w0) - lo + 1])))
    return float((w0[i] + w0[i + 1]) / 2)


def graph_signatures(server) -> dict:
    return {name: len(g._graphs) for name, g in server.graphs().items()}


def serve_image_scheduler(dev, im, server) -> dict:
    """``bench_scheduler.py``'s setup at the paper's size: ``MuxScheduler``
    (``SchedulerConfig(max_batch_size=8, max_wait_ms=4.0,
    default_slo_ms=250.0)``) over one ``InProcessMuxBackend`` per zoo
    model, ``SCHED_REQUESTS`` images arriving at Poisson 400/s and bursty
    200/s, ``warmup`` before the traffic.  ``server`` is the thresholded
    one: under argmax the random mux sends every image to one model, so
    only one worker would run.  Checks: every request
    completes, bitwise equal to ``reference_output(x,
    reference_assignment(x))``; K2 launched once a probe chunk (one a
    request at ``probe_batch_size`` 1); no graph captured after
    ``warmup``.  Returns each load's snapshot figures."""
    import asyncio

    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.scheduler import (MuxScheduler,
                                               SchedulerConfig,
                                               TrafficConfig, arrival_times,
                                               replay)
    xs = im["images"][:SCHED_REQUESTS]
    runs = {}
    for pattern, rate in SCHED_LOADS:
        sched = MuxScheduler(server, SchedulerConfig(
            max_batch_size=8, max_wait_ms=4.0, default_slo_ms=250.0))
        t0 = time.perf_counter()
        sched.warmup(xs[0])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        sigs = graph_signatures(server)
        times = arrival_times(TrafficConfig(rate=rate, pattern=pattern,
                                            num_requests=len(xs), seed=SEED))

        async def run():
            async with sched:
                futures = await replay(sched.submit, list(xs), times)
                return await asyncio.gather(*futures)
        before = ops.launches["mux_score"]
        t0 = time.perf_counter()
        outputs = asyncio.run(run())
        wall = time.perf_counter() - t0
        k2 = ops.launches["mux_score"] - before
        tag = f"image scheduler {pattern}@{rate:g}"
        check(graph_signatures(server) == sigs,
              f"{tag}: graphs captured after warmup: {sigs} -> "
              f"{graph_signatures(server)}")
        check(k2 == len(xs), f"{tag}: K2 launched {k2} times for "
              f"{len(xs)} probe chunks")
        snap = sched.snapshot()
        check(snap["completed"] == len(xs) and snap["failed"] == 0,
              f"{tag}: {snap['completed']} completed, {snap['failed']} "
              f"failed of {len(xs)}")
        for i, out in enumerate(outputs):
            m = sched.reference_assignment(xs[i])
            check(np.array_equal(np.asarray(out),
                                 sched.reference_output(xs[i], m)),
                  f"{tag}: request {i}'s output is not bitwise equal to "
                  f"the direct model step")
        row = {k: snap[k] for k in (
            "throughput_rps", "total_p50_ms", "total_p99_ms",
            "queue_p99_ms", "mean_batch_fill", "flops_saving_factor",
            "slo_violations", "batches", "called_fraction")}
        row.update(requests=len(xs), wall_s=wall, warmup_s=warm_s,
                   k2_launches=k2, graphs=sigs, bitwise=True)
        log(f"{tag}: {json.dumps(row)}")
        runs[f"{pattern}@{rate:g}"] = row
    return runs


def time_mux_meta(dev, mux, images, server, sizes=(1, SERVE_B)) -> list:
    """K2's meta form at its served shapes, on the served operands (the
    backbone's meta-features of the first images, the mux's v and
    cost_rel ** alpha, ``normalize=False``), at each batch of ``sizes``:
    in phase 7 B = 1 (the scheduler's probe) and B = ``SERVE_B``
    (``serve``), M = 64, N = 6; in phase 8 the trained pair mux's
    B = ``SERVE_B``, M = 64, N = 2.  Eager
    (``time_cuda``), as a CUDA graph (``time_cuda_graph``), host
    microseconds a call, and the plain version eager, beside the bound:
    meta, v and cost read once and the weights written once over HBM
    bandwidth, against the dots' and softmax's fp32 operations."""
    import torch
    from repro_torch.core.multiplexer import backbone_forward
    from repro_torch.kernels.mux_score import mux_score_cuda
    from repro_torch.kernels.ref import mux_score_ref
    v, cost = mux["v"], server.cost_pow
    rows = []
    for b in sizes:
        meta = backbone_forward(mux["backbone"],
                                torch.as_tensor(images[:b], device=dev))
        (b, m_dim), n = meta.shape, v.shape[0]

        def kern(i):
            return mux_score_cuda(meta, v, cost, normalize=False)

        def plain(i):
            return mux_score_ref(meta, v, cost, normalize=False)
        err = (kern(0) - plain(0)).abs().max().item()
        check(err <= F32_MUX_TOL, f"K2 meta served B={b}: {err:.3e}")
        byts = 4 * (b * m_dim + n * m_dim + n + b * n)
        flops = 2 * b * n * m_dim + 6 * b * n
        t_bytes = byts / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        row = {"shape": f"B={b} M={m_dim} N={n} normalize=False",
               "max_abs_err": err, "ms": time_cuda(kern, iters=1000),
               "graph_ms": time_cuda_graph(kern, iters=100),
               "host_us": host_us(kern),
               "plain_ms": time_cuda(plain, iters=1000),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(f"K2 meta form served {row['shape']}: eager {row['ms']:.4f} ms, "
            f"as a CUDA graph {row['graph_ms']:.4f} ms, host "
            f"{row['host_us']:.1f} us, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.3e} ms ({row['bound_by']}), max_err "
            f"{err:.3e}")
        rows.append(row)
    return rows


def image_mux_phase(dev) -> tuple:
    """Phase 7 (see the module docstring).  cuDNN's TF32 switch is turned
    on for the phase, so the card-vs-CPU check holds the port's own
    scoping of full-fp32 convolutions, not this script's global flag.
    Returns (the phase's figures, the argmax server, one batch of
    images) for the profiled ``serve`` step at the end of the run."""
    import torch
    t0 = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        im = build_image_mux(dev)
        out = {"cpu_max_diff": check_image_against_cpu(dev, im)}
        check(torch.backends.cudnn.allow_tf32,
              "the zoo's forward left cuDNN's TF32 switch off")
        argmax = image_server(im, dev)
        thr = image_threshold(argmax, im["images"][:SERVE_B])
        out["serve"] = {"argmax": serve_images(dev, im, argmax, "argmax")}
        thresholded = image_server(im, dev, threshold=thr)
        out["serve"]["threshold"] = serve_images(dev, im, thresholded,
                                                 f"threshold {thr:.6f}")
        out["threshold"] = thr
        check(sum(c > 0 for c in out["serve"]["threshold"]["called_fraction"])
              >= 2, "image serve threshold: fewer than two models get traffic")
        out["scheduler"] = serve_image_scheduler(dev, im, thresholded)
        out["meta_form"] = time_mux_meta(dev, im["mux"], im["images"],
                                         argmax)
        out["meta_launches"] = {
            "serve": sum(sum(r["k2_launches"])
                         for r in out["serve"].values()),
            "scheduler": sum(r["k2_launches"]
                             for r in out["scheduler"].values())}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 7, image mux: {out['wall_s']:.1f} s wall")
    return out, argmax, im["images"][:SERVE_B]


def profile_serve(dev, server, x, wall_ms: float) -> dict:
    """Device busy ms and launches of one graphed ``serve`` step from
    ``torch.profiler`` over 10 replays (the images on the card), against
    ``wall_ms``, the median wall ms of an unprofiled ``serve``: the idle
    share; the rows must show ``mux_score_kernel`` once a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    xd = torch.from_numpy(x).to(dev)
    for _ in range(3):
        server._step_graph(xd)
    torch.cuda.synchronize()
    calls = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            server._step_graph(xd)
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    k2 = sum(c for _, c, k in rows if "mux_score_kernel" in k)
    check(k2 == calls, f"serve profile: {k2} K2 launches in {calls} steps")
    busy = sum(r[0] for r in rows) / calls
    out = {"device_busy_ms": busy,
           "launches": sum(r[1] for r in rows) / calls,
           "serve_wall_ms": wall_ms, "idle_share": 1.0 - busy / wall_ms,
           "top": [[round(ms / calls, 5), c // calls, k]
                   for ms, c, k in rows[:8]]}
    log(f"image serve graphed step profile: device busy {busy:.4f} ms, "
        f"{out['launches']:g} launches a step, serve wall {wall_ms:.3f} ms, "
        f"idle {out['idle_share']:.3f}; top {out['top']}")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the paper's Algorithm 1 and its tables on the card
# ---------------------------------------------------------------------------

PAPER_LOSS_RTOL = 1e-5      # losses, card vs CPU, both fp32
PAPER_GNORM_RTOL = 5e-5     # the gradients' global norm, card vs CPU
# the gradients, card vs CPU: ||difference|| / ||gradient||.  The zoo's
# six CNNs have so many ReLU and max-pool branches that each side's fp32
# rounding flips some, and a flipped branch moves a gradient entry by a
# whole term, TF32 or not; the mux steps train only the 4-conv backbone
# (the zoo frozen), where both sides agree to fp32 rounding.  So for the
# zoo step this limit does not tell TF32 apart (on an H100 TF32 in the
# backward reads 5.9e-4 of the norm, the sound step 2.2e-4): its one TF32
# separator is PAPER_GNORM_RTOL, the sound step's norm 5.4e-6 off and
# TF32's 3.7e-4 off
PAPER_GRAD_L2 = {"zoo_train_step": 1e-3, "mux_train_step ensemble": 1e-5,
                 "mux_train_step offload": 1e-5}
PAPER_CROSS_B = 64          # the card-vs-CPU steps' batch
PAPER_WARMUP = 10           # steps left out of the median ms a step
NEAR_TIE = 1e-5             # top-two mux weights / class probabilities
NEAR_TIE_SHARE = 0.01       # the most near-tie rows of the eval set allowed


def _by_path(t) -> dict:
    from repro_torch import convert, tree
    return dict(tree.paths(convert.to_numpy(t)))


def _l2(a: dict, b: dict) -> float:
    return float(np.sqrt(sum(np.sum(np.square(a[k].astype(np.float64)
                                              - b[k])) for k in b)))


def _step_runs(cfg, opt_cfg):
    """The three Algorithm 1 steps the card is held to the CPU on, each
    a function of the device: ((loss function, params, its arguments),
    (new params, new AdamW state, step metrics)) from one seeded set of
    CPU params and one batch of ``PAPER_CROSS_B`` images, copied to the
    device."""
    import torch
    from repro_torch.core import mux_train
    from repro_torch.data.synthetic import image_dataset, make_templates
    from repro_torch.optim import adamw
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 40)
    templates = make_templates(gen, num_classes=cfg.num_classes,
                               image_size=cfg.image_size, device=cpu)
    batch = image_dataset(gen, templates, num_samples=PAPER_CROSS_B,
                          batch=PAPER_CROSS_B)[0]
    zoo = mux_train.init_zoo_state(gen, cfg, device=cpu)
    pair = (cfg.mobile_model, cfg.cloud_model)
    muxes = {"ensemble": (tuple(cfg.zoo),
                          mux_train.init_mux_state(gen, cfg, device=cpu)),
             "offload": (pair, mux_train.init_mux_state(gen, cfg, names=pair,
                                                         device=cpu))}

    def zoo_step(d):
        st, b = _to_device(zoo, d), _to_device(batch, d)
        return ((mux_train.zoo_loss, st, (b, cfg)),
                mux_train.zoo_train_step(st, adamw.init(opt_cfg, st), b, cfg,
                                         opt_cfg))

    def mux_step(objective):
        names, mux = muxes[objective]

        def run(d):
            tr = _to_device({k: v for k, v in mux.items() if k != "cost_rel"},
                            d)
            cr, z = mux["cost_rel"].to(d), _to_device(zoo, d)
            args = (cr, z, _to_device(batch, d), cfg, names, objective)
            return ((mux_train.mux_loss, tr, args),
                    mux_train.mux_train_step(tr, cr, adamw.init(opt_cfg, tr),
                                             z, args[2], cfg, opt_cfg, names,
                                             objective))
        return run
    return {"zoo_train_step": zoo_step,
            "mux_train_step ensemble": mux_step("ensemble"),
            "mux_train_step offload": mux_step("offload")}


def _grads_tf32_backward(loss_fn, params, args):
    """The gradients as they were before the fp32 scope covered the
    backward: the forward holds TF32 off for its convolutions, the
    backward runs under the process's switch."""
    import torch
    from repro_torch import tree
    live = [x.detach().requires_grad_() for x in tree.leaves(params)]
    loss, _ = loss_fn(tree.unflatten(params, live), *args)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return tree.unflatten(params, [torch.zeros_like(x) if g is None else g
                                   for x, g in zip(live, grads)])


def _tf32_in_backward(fn) -> tuple:
    """``fn()``'s result and the values of cuDNN's TF32 switch read each
    time a backward unpacked a tensor saved by the forward (every
    convolution's backward does, on autograd's device thread)."""
    import torch
    seen = set()

    def unpack(t):
        seen.add(torch.backends.cudnn.allow_tf32)
        return t
    with torch.autograd.graph.saved_tensors_hooks(lambda t: t, unpack):
        out = fn()
    return out, seen


def paper_steps_against_cpu(dev) -> dict:
    """One ``zoo_train_step`` and one ``mux_train_step`` per objective at
    ``paper_mux.config()``'s widths (six CNNs, 32x32), card against CPU
    on the same params and batch, with cuDNN's TF32 switch on globally.
    The switch read inside every backward of ``loss_and_grads`` must be
    off (and on in the same backward run outside the port's scope, which
    shows the probe sees it).  Loss within ``PAPER_LOSS_RTOL``, the
    gradients' global norm within ``PAPER_GNORM_RTOL`` and the gradients
    within ``PAPER_GRAD_L2``; the first moment within (1 - b1) E and every
    updated param within 1e-6 + lr * min(2, 4 E / sqrt(v_hat)) (E: the
    clipped gradients' largest difference; an entry whose gradient does
    not stand clear of E may flip Adam's ~lr * sign(g) step).  The
    gradients with TF32 left on in the backward must miss the norm's or
    the gradients' tolerance, so the check can see TF32; their figures
    are logged beside the port's."""
    import torch
    from repro_torch.configs import paper_mux
    from repro_torch.core import mux_train
    cfg = paper_mux.config()
    opt_cfg = mux_train.opt_config(cfg, cfg.zoo_steps)
    check(torch.backends.cudnn.allow_tf32,
          "phase 8 must run with cuDNN's TF32 switch on")
    out = {}
    for tag, run in _step_runs(cfg, opt_cfg).items():
        (fn, p_card, args), (new_c, opt_c, m_c) = run(dev)
        (_, p_cpu, args_cpu), (new_w, opt_w, m_w) = run(torch.device("cpu"))
        (loss_c, _, g_c), seen = _tf32_in_backward(
            lambda: mux_train.loss_and_grads(fn, p_card, *args))
        g_tf32, seen_tf32 = _tf32_in_backward(
            lambda: _grads_tf32_backward(fn, p_card, args))
        _, _, g_w = mux_train.loss_and_grads(fn, p_cpu, *args_cpu)
        check(torch.backends.cudnn.allow_tf32,
              f"{tag}: the step left cuDNN's TF32 switch off")
        gc, gt, gw = _by_path(g_c), _by_path(g_tf32), _by_path(g_w)
        norm = float(np.sqrt(sum(np.sum(np.square(v.astype(np.float64)))
                                 for v in gw.values())))

        def norm_err(g):
            n = np.sqrt(sum(np.sum(np.square(v.astype(np.float64)))
                            for v in g.values()))
            return abs(float(n) - norm) / norm
        err = max(float(np.abs(gc[k] - v).max()) for k, v in gw.items())
        scale = min(1.0, opt_cfg.clip_norm / float(m_w["grad_norm"]))
        e = max(err * scale, 1e-9)
        lr = float(m_w["lr"])
        mu_c, mu_w = _by_path(opt_c.mu), _by_path(opt_w.mu)
        nu_w = _by_path(opt_w.nu)
        pc, pw = _by_path(new_c), _by_path(new_w)
        worst_mu = max(float(np.abs(mu_c[k] - v).max())
                       for k, v in mu_w.items())
        over, worst_p = 0.0, 0.0
        for k, want in pw.items():
            s = np.sqrt(nu_w[k] / (1 - opt_cfg.b2))
            bound = 1e-6 + lr * np.minimum(2.0, 4.0 * e / np.maximum(s, 1e-30))
            diff = np.abs(pc[k] - want)
            worst_p = max(worst_p, float(diff.max()))
            over = max(over, float((diff / bound).max()))
        row = {"loss_rel_err": abs(float(m_c["loss"]) - float(m_w["loss"]))
               / abs(float(m_w["loss"])),
               "grad_norm_rel_err": abs(float(m_c["grad_norm"])
                                        - float(m_w["grad_norm"]))
               / float(m_w["grad_norm"]),
               "grads_l2_rel_err": _l2(gc, gw) / norm,
               "grads_max_err_of_norm": err / norm,
               "tf32_in_backward_seen": sorted(seen),
               "tf32_backward": {"grads_l2_rel_err": _l2(gt, gw) / norm,
                                 "grad_norm_rel_err": norm_err(gt),
                                 "tf32_in_backward_seen": sorted(seen_tf32)},
               "mu_err": worst_mu, "param_err": worst_p,
               "param_err_over_bound": over, "loss": float(loss_c)}
        log(f"phase 8 {tag} on the card vs CPU (B={PAPER_CROSS_B}, TF32 on "
            f"globally): {json.dumps(row)}")
        check(seen == {False}, f"{tag}: cuDNN's TF32 switch read {seen} in "
              f"the backward")
        check(seen_tf32 == {True}, f"{tag}: the probe read {seen_tf32} in a "
              f"backward run under the global switch")
        check(row["loss_rel_err"] <= PAPER_LOSS_RTOL
              and abs(float(loss_c) - float(m_w["loss"]))
              <= PAPER_LOSS_RTOL * abs(float(m_w["loss"])),
              f"{tag}: loss card vs CPU {row['loss_rel_err']:.3e}")
        check(row["grad_norm_rel_err"] <= PAPER_GNORM_RTOL
              and norm_err(gc) <= PAPER_GNORM_RTOL,
              f"{tag}: gradient norm card vs CPU "
              f"{row['grad_norm_rel_err']:.3e}")
        check(row["grads_l2_rel_err"] <= PAPER_GRAD_L2[tag],
              f"{tag}: gradients card vs CPU {row['grads_l2_rel_err']:.3e} of "
              f"their norm")
        tf = row["tf32_backward"]
        check(tf["grad_norm_rel_err"] > PAPER_GNORM_RTOL
              or tf["grads_l2_rel_err"] > PAPER_GRAD_L2[tag],
              f"{tag}: TF32 in the backward passes the fp32 tolerances "
              f"({tf}), so they cannot tell it apart")
        check(worst_mu <= (1 - opt_cfg.b1) * e * 1.01 + 1e-9,
              f"{tag}: first moment card vs CPU {worst_mu:.3e}")
        check(over <= 1.0, f"{tag}: updated params over their bound "
              f"({over:.3f} x)")
        out[tag] = row
    return out


class StepTimer:
    """``get_state``'s ``on_step`` hook: a CUDA event after each training
    step is enqueued, and at a stage's last step a synchronise and the
    host clock (a stage's wall runs from the previous stage's end, or
    from the timer's start, so a zoo stage's wall includes drawing the
    data on the card and initialising)."""

    def __init__(self, steps: dict):
        self.steps, self.events, self.walls, self.losses = steps, {}, {}, {}
        self.t = time.perf_counter()

    def __call__(self, stage, step, metrics):
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.setdefault(stage, []).append(ev)
        if step == 1:
            self.losses[stage] = [metrics["loss"]]
        if step == self.steps[stage]:
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.walls[stage], self.t = now - self.t, now
            self.losses[stage].append(metrics["loss"])

    def summary(self) -> dict:
        out = {}
        for stage, evs in self.events.items():
            ms = [a.elapsed_time(b) for a, b in zip(evs[PAPER_WARMUP:],
                                                    evs[PAPER_WARMUP + 1:])]
            out[stage] = {"steps": len(evs), "wall_s": self.walls[stage],
                          "median_step_ms": float(np.median(ms)),
                          "p10_step_ms": float(np.percentile(ms, 10)),
                          "p90_step_ms": float(np.percentile(ms, 90)),
                          "loss_first": float(self.losses[stage][0]),
                          "loss_last": float(self.losses[stage][-1])}
        return out


def serve_trained(dev, state, t1: dict, t2: dict) -> dict:
    """The trained muxes served through ``MuxServer.serve`` (argmax, K2's
    meta form as the probe's head) on the eval images in batches of
    ``batch_size``, every row kept (capacity = B: ``capacity_factor`` =
    the number of models): the six-model mux against Table II, the pair
    mux against Table I.  Checks: each served assignment equals the
    evaluation's (argmax of ``mux_forward``'s weights; the pair's
    w_mobile >= 0.5) except rows whose top two weights lie within
    ``NEAR_TIE`` (at most ``NEAR_TIE_SHARE`` of the rows); on the
    agreeing rows, each served prediction's correctness equals the
    evaluation's (but where the served model's top two class
    probabilities lie within ``NEAR_TIE``), so the served accuracy there
    equals Table II's acc_single / Table I's hybrid accuracy there, and
    the local fraction Table I's up to the near-tie rows; K2 launched
    once a ``serve`` and once more on the first (the graph's warm-up).
    Then K2's meta form at the pair's served shape (B = ``SERVE_B``,
    M = 64, N = 2) on its trained operands, against ``mux_score_ref`` and
    timed (``time_mux_meta``), under ``meta_form``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    from repro_torch.paper import common
    from repro_torch.serving.mux_server import MuxServer, MuxServerConfig
    cfg = state["cfg"]
    costs = cfg.costs()
    zoo = state["zoo_state"]["zoo"]
    ev = common.eval_zoo(state)
    rows = len(ev["labels"])
    r = np.arange(rows)
    pair = (cfg.mobile_model, cfg.cloud_model)
    w_pair = ev["weights_pair"]
    cases = (("mux_all", tuple(cfg.zoo), ev["weights_all"],
              ev["weights_all"].argmax(-1), t2["acc_single"]),
             ("mux_pair", pair, w_pair,
              np.where(w_pair[:, 0] >= cfg.offload_threshold, 0, 1),
              t1["acc_hybrid"]))
    out = {}
    for key, names, w, offline, table_acc in cases:
        fns = [lambda xs, n=n: cnn.cnn_forward(
            zoo[n], xs, convs_per_stage=cnn.ZOO_SPECS[n]["convs_per_stage"]
        )[0] for n in names]
        server = MuxServer(state[key], [costs[n] for n in names],
                           MuxServerConfig(capacity_factor=float(len(names))),
                           device=dev, model_fns=fns)
        before = ops.launches["mux_score"]
        t0 = time.perf_counter()
        res = [server.serve(b["image"]) for b in state["eval_b"]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k2 = ops.launches["mux_score"] - before
        assign = torch.cat([x["assign"] for x in res]).cpu().numpy()
        pred = torch.cat([x["output"].argmax(-1) for x in res]).cpu().numpy()
        kept = torch.cat([x["kept"] for x in res]).cpu().numpy()
        top = np.sort(w, axis=-1)
        tie = top[:, -1] - top[:, -2] <= NEAR_TIE
        agree = assign == offline
        model = np.asarray([cfg.zoo.index(n) for n in names])[assign]
        served_ok = pred == ev["labels"]
        offline_ok = ev["correct"][model, r]
        ptop = np.sort(ev["probs"][model, r], axis=-1)
        ptie = ptop[:, -1] - ptop[:, -2] <= NEAR_TIE
        differ = agree & (served_ok != offline_ok)
        row = {"rows": rows, "batches": len(res), "k2_launches": k2,
               "serve_wall_s": wall, "near_tie_rows": int(tie.sum()),
               "disagreeing_rows": int((~agree).sum()),
               "prob_tie_rows_differing": int(differ.sum()),
               "acc_served_agreeing": float(served_ok[agree].mean()),
               "acc_offline_agreeing": float(offline_ok[agree].mean()),
               "acc_table": table_acc, "acc_served_all":
                   float(served_ok.mean()),
               "called": np.bincount(assign, minlength=len(names)).tolist()}
        if key == "mux_pair":
            row.update(local_served=float((assign == 0).mean()),
                       local_table=t1["local_fraction"])
        log(f"phase 8 trained {key} served: {json.dumps(row)}")
        check(kept.all(), f"{key}: {int((~kept).sum())} rows dropped")
        check((agree | tie).all(), f"{key}: {int((~agree & ~tie).sum())} "
              f"served assignments differ off a near-tie")
        check(tie.sum() <= NEAR_TIE_SHARE * rows,
              f"{key}: {int(tie.sum())} near-tie rows of {rows}")
        check(not (differ & ~ptie).any(), f"{key}: served predictions "
              f"differ from the evaluation's on {int((differ & ~ptie).sum())}"
              f" rows off a near-tie")
        loose = int((~agree).sum() + differ.sum())
        check(abs(row["acc_served_all"] - table_acc) * rows <= loose + 1e-6,
              f"{key}: served accuracy {row['acc_served_all']} vs the "
              f"table's {table_acc} beyond {loose} near-tie rows")
        if key == "mux_pair":
            check(abs(row["local_served"] - row["local_table"]) * rows
                  <= int((~agree).sum()) + 1e-6,
                  f"{key}: local fraction {row['local_served']} vs "
                  f"{row['local_table']}")
        check(k2 == len(res) + 1, f"{key}: K2 launched {k2} times in "
              f"{len(res)} serves")
        if key == "mux_pair":
            out["meta_form"] = time_mux_meta(
                dev, state[key], state["eval_b"][0]["image"], server,
                (SERVE_B,))
        out[key] = row
    out["k2_launches"] = sum(out[k]["k2_launches"] for k in ("mux_all",
                                                             "mux_pair"))
    return out


def paper_phase(dev) -> tuple:
    """Phase 8 (see the module docstring).  cuDNN's TF32 switch is on for
    the phase.  Returns (the phase's figures, the trained state)."""
    import torch
    from repro_torch.paper import (common, fig1_expertise, fig6_separation,
                                   table1_mobile_cloud, table2_cloud_api)
    t0 = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = {"card_vs_cpu": paper_steps_against_cpu(dev)}
        cfg = common.bench_config("full")
        timer = StepTimer({"zoo_cnt": cfg.zoo_steps,
                           "zoo_nocnt": cfg.zoo_steps,
                           "mux_all": cfg.mux_steps,
                           "mux_pair": cfg.mux_steps})
        state = common.get_state(scale="full", device=dev, cache_dir=None,
                                 verbose=False, on_step=timer)
        ablation = common.get_state(contrastive=False, scale="full",
                                    device=dev, cache_dir=None,
                                    verbose=False, on_step=timer)
        out["training"] = timer.summary()
        for stage, row in out["training"].items():
            log(f"phase 8 training {stage}: {json.dumps(row)}")
        check(all(r["steps"] == timer.steps[s]
                  for s, r in out["training"].items())
              and len(out["training"]) == 4,
              f"phase 8: training stages {list(out['training'])}")
        f1 = fig1_expertise.run(state)
        t1 = table1_mobile_cloud.run(state)
        t2 = table2_cloud_api.run(state)
        f6 = fig6_separation.run(state, ablation=ablation)
        (pull_c, push_c), (pull_a, push_a) = f6["contrastive"], f6["ablation"]
        out["tables"] = {
            "table1": {"rows": {k: dataclasses.asdict(v)
                                for k, v in t1["rows"].items()},
                       **{k: t1[k] for k in ("acc_hybrid", "acc_mobile",
                                             "acc_cloud", "local_fraction",
                                             "tnr")}},
            "table2": {k: t2[k] for k in ("saving_factor", "acc_single",
                                          "acc_ensemble", "best_single_acc",
                                          "flops_single")}
            | {"called": t2["called"].tolist(),
               "acc_oracle": float(t2["oracle"]["acc_oracle"]),
               "flops_oracle": float(t2["oracle"]["flops_oracle"])},
            "fig1": {"matrix": f1["matrix"].tolist(),
                     "small_vs_big_pct": float(f1["small_vs_big_pct"])},
            "fig6": f6}
        out["headline"] = {
            "mobile_gain_pp": (t1["acc_hybrid"] - t1["acc_mobile"]) * 100,
            "saving_factor": t2["saving_factor"],
            "separation_ratio_contrastive": push_c / max(pull_c, 1e-6),
            "separation_ratio_ablation": push_a / max(pull_a, 1e-6)}
        log(f"phase 8 headline (logged, not gated; the paper claims +8.52% "
            f"mobile accuracy and a 2.85x saving on ImageNet): "
            f"{json.dumps(out['headline'])}")
        largest = max(cfg.costs().values())
        check(t2["acc_single"] >= t2["best_single_acc"] - 0.05,
              f"hybrid-single accuracy {t2['acc_single']:.4f} below the best "
              f"single model's {t2['best_single_acc']:.4f} - 0.05")
        check(t2["flops_single"] <= largest + 1e-6,
              f"hybrid-single FLOPs {t2['flops_single']:.4g} above the "
              f"largest model's {largest:.4g}")
        check(push_c > pull_c, f"contrastive separation: push {push_c:.4f} "
              f"<= pull {pull_c:.4f}")
        out["served"] = serve_trained(dev, state, t1, t2)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 8, the paper's results: {out['wall_s']:.1f} s wall")
    return out, state


def profile_zoo_step(dev, state, median_ms: float, steps: int = 5) -> dict:
    """Device busy ms and launches of one ``zoo_train_step`` (the trained
    zoo, a fresh AdamW state, the first training batch) from
    ``torch.profiler`` over ``steps`` steps after two warm-up steps,
    against the timed training's median ms a step: the idle share.  The
    steps run with cuDNN's TF32 switch on, and no kernel whose name says
    TF32 may run in them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import mux_train
    from repro_torch.optim import adamw
    cfg = state["cfg"]
    opt_cfg = mux_train.opt_config(cfg, cfg.zoo_steps)
    st, opt = state["zoo_state"], adamw.init(opt_cfg, state["zoo_state"])
    batch = state["train_b"][0]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for _ in range(2):
            st, opt, _ = mux_train.zoo_train_step(st, opt, batch, cfg,
                                                  opt_cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                st, opt, _ = mux_train.zoo_train_step(st, opt, batch, cfg,
                                                      opt_cfg)
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    from torch.autograd import DeviceType
    tf32_kernels = sorted({e.key for e in prof.key_averages()
                           if e.device_type != DeviceType.CPU
                           and "tf32" in e.key.lower()})
    check(not tf32_kernels, f"zoo_train_step launched TF32 kernels under "
          f"the global switch: {tf32_kernels}")
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows) / steps
    out = {"device_busy_ms": busy,
           "launches": sum(r[1] for r in rows) / steps,
           "median_step_ms": median_ms, "idle_share": 1.0 - busy / median_ms,
           "top": [[round(ms / steps, 4), c // steps, k]
                   for ms, c, k in rows[:10]]}
    log(f"zoo_train_step profile: device busy {busy:.3f} ms, "
        f"{out['launches']:g} launches a step, median step {median_ms:.3f} "
        f"ms, idle {out['idle_share']:.3f}; top {out['top']}")
    return out


# ---------------------------------------------------------------------------
# phase 12: LM training (K3's backward, the train step, olmo-1b trained)
# ---------------------------------------------------------------------------

# K3's backward against its plain version, fed the same q, k, v, out, lse
# and dout: (b, s, h, kk, hd, vd, window, chunk, cap, dtype)
FLASH_BWD_CASES = {
    "olmo-1b train": (2, 4096, 16, 16, 128, 128, None, None, None, "bf16"),
    "g=2 window cap": (1, 1000, 8, 4, 128, 128, 256, None, 50.0, "bf16"),
    "g=4 chunk": (1, 700, 8, 2, 64, 64, None, 96, None, "bf16"),
    "MLA 96/64": (1, 1024, 40, 40, 96, 64, None, None, None, "bf16"),
    "hd 40 vd 24 off-tile": (2, 130, 4, 2, 40, 24, 50, None, None, "bf16"),
    "fp32 g=2": (1, 333, 4, 2, 64, 64, None, None, None, "fp32"),
    "fp32 window cap": (1, 300, 8, 2, 128, 128, 100, None, 50.0, "fp32"),
    "fp32 chunk 96/64": (2, 200, 4, 4, 96, 64, None, 40, None, "fp32"),
}
# ||kernel - plain|| / ||plain|| of each of dq, dk, dv: bf16 rounds P and dS
# to bf16 as the products' operands (2^-9 of each, independent over the
# keys, so the norm moves far less) and the inputs' gradients are written
# in bf16; fp32 is fp32 arithmetic in another summation order
BWD_REL = {"bf16": 1e-2, "fp32": 1e-4}
# |kernel lse - plain lse|: bf16 scores are a bf16 product scaled after it
# (the plain version scales q in fp32 first), fp32 differs in rounding only
LSE_TOL = {"bf16": 2e-2, "fp32": 1e-4}
OLMO_TRAIN = (2, 4096, 16, 16, 128, 128)      # B, S, H, K, hd, vd (bf16)


def check_bwd_resources() -> dict:
    """ptxas's registers and spills of every kernel of K3's backward
    (``csrc/flash_attention_bwd.cu``: the D pass, the dk / dv and the dq
    kernels, bf16 and fp32), logged; none may spill."""
    found = ptxas_entries("flash_attention_bwd", "flash_bwd_")
    for key, text in found.items():
        log(f"  flash_attention_bwd {key}: {text}")
    check(len(found) == 6, f"K3's backward: {len(found)} ptxas entries, "
          f"want 3 kernels x 2 dtypes: {sorted(found)}")
    spills = {k: v for k, v in found.items()
              if "0 bytes spill stores, 0 bytes spill loads" not in v}
    check(not spills, f"K3's backward spills: {spills}")
    return found


def rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def bwd_inputs(gen, dev, case):
    """q, k, v, out, lse (K3's forward, ``lse=True``) and dout of a case."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    b, s, h, kk, hd, vd, window, chunk, cap, dt = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, k, v = flash_inputs(gen, dev, b, s, s, h, kk, hd, vd, dtype)
    kw = dict(window=window, chunk=chunk, logit_cap=cap)
    out, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
    dout = torch.randn(out.shape, generator=gen).to(dtype).to(dev)
    return (q, k, v, out, lse, dout), kw


def check_flash_bwd(dev) -> dict:
    """Phase 12 (a): K3's backward against ``flash_attention_bwd_plain``
    on the same q, k, v, out, lse and dout over ``FLASH_BWD_CASES``
    (olmo-1b's train shape, GQA with a window and cap 50, a chunk, MLA's
    hd 96 / vd 64 at 40 heads, widths off the k16 steps, fp32); K3's row
    log-sum-exps against ``flash_attention_lse_plain``, and the forward's
    out unchanged by asking for them (bitwise); a second backward call
    bitwise equal to the first (no atomics); each call counted once.
    Returns the worst errors."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda, flash_attention_lse_plain)
    gen = torch.Generator().manual_seed(SEED + 12)
    worst = {"max_abs_err": 0.0, "rel": {"bf16": 0.0, "fp32": 0.0},
             "lse": {"bf16": 0.0, "fp32": 0.0}}
    for name, case in FLASH_BWD_CASES.items():
        dt = case[-1]
        (q, k, v, out, lse, dout), kw = bwd_inputs(gen, dev, case)
        check(torch.equal(out, flash_attention_cuda(q, k, v, **kw)),
              f"K3 bwd {name}: the forward's out changed with lse=True")
        lse_err = (lse - flash_attention_lse_plain(q, k, **kw)).abs().max()
        lse_err = lse_err.item()
        counts = {"flash_attention_bwd": 0}
        got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, counts=counts,
                                       **kw)
        again = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        check(counts["flash_attention_bwd"] == 1,
              f"K3 bwd {name}: the wrapper counted {counts}")
        want = flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
        rels = [rel_l2(g, w) for g, w in zip(got, want)]
        abs_err = max((g.float() - w).abs().max().item()
                      for g, w in zip(got, want))
        log(f"K3 bwd {name:22s} {dt}: rel L2 dq {rels[0]:.3e} dk "
            f"{rels[1]:.3e} dv {rels[2]:.3e} (tol {BWD_REL[dt]:g}); max abs "
            f"{abs_err:.3e}; lse max err {lse_err:.3e} (tol {LSE_TOL[dt]:g})")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K3 bwd {name}: two calls differ")
        check(all(g.dtype == q.dtype and g.shape == x.shape
                  for g, x in zip(got, (q, k, v))),
              f"K3 bwd {name}: gradient dtypes / shapes")
        check(max(rels) <= BWD_REL[dt],
              f"K3 bwd {name}: rel L2 {rels} > {BWD_REL[dt]:g}")
        check(lse_err <= LSE_TOL[dt],
              f"K3 bwd {name}: lse err {lse_err:.3e} > {LSE_TOL[dt]:g}")
        worst["max_abs_err"] = max(worst["max_abs_err"], abs_err)
        worst["rel"][dt] = max(worst["rel"][dt], *rels)
        worst["lse"][dt] = max(worst["lse"][dt], lse_err)
        del q, k, v, out, lse, dout, got, again, want
        torch.cuda.empty_cache()
    return worst


def flash_bwd_bound_ms(b, s, h, kk, hd, vd, elem) -> tuple:
    """(bound ms, bound_by) of K3's backward at a causal S == T shape: q,
    k, v, out, dout and lse read once, dq, dk, dv written once, over HBM
    bandwidth; 5 products (S, dP, dV, dK, dQ) of 2 x width FLOPs a
    visible pair — 2 (hd + vd + vd + hd + hd) — over the bf16 rate."""
    byts = (elem * (2 * s * h * hd + 2 * s * kk * (hd + vd) + 2 * s * h * vd)
            + 4 * s * h) * b
    flops = 2 * (3 * hd + 2 * vd) * b * h * (s * (s + 1) // 2)
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_flash_bwd(dev) -> dict:
    """Phase 12 (b): at olmo-1b's train shape (B 2, S = T 4096, 16 heads of
    128, bf16, causal) K3's backward as a CUDA graph (``ms``) and eager,
    its bound, its plain version, and the library call for the same
    function: ``scaled_dot_product_attention(is_causal=True)``'s backward
    through autograd, timed apart from its forward (eager: an autograd
    backward is not captured); and K3's forward with and without the row
    log-sum-exps, as CUDA graphs.  Two input copies of 170 MB rotate, so
    the L2 never holds the next call's operands."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda)
    b, s, h, kk, hd, vd = OLMO_TRAIN
    gen = torch.Generator().manual_seed(SEED + 13)
    case = (b, s, h, kk, hd, vd, None, None, None, "bf16")
    copies = [bwd_inputs(gen, dev, case)[0] for _ in range(2)]

    def bwd(i):
        return flash_attention_bwd_cuda(*copies[i % 2])

    def fwd(i, lse):
        return flash_attention_cuda(*copies[i % 2][:3], lse=lse)
    row = {"B": b, "S": s, "H": h, "hd": hd,
           "ms": time_cuda_graph(bwd, iters=10, reps=3),
           "eager_ms": time_cuda(bwd, iters=10),
           "plain_ms": time_cuda(lambda i: flash_attention_bwd_plain(
               *copies[i % 2]), iters=2, warmup=1),
           "fwd_graph_ms": time_cuda_graph(lambda i: fwd(i, False), iters=10,
                                           reps=3),
           "fwd_lse_graph_ms": time_cuda_graph(lambda i: fwd(i, True),
                                               iters=10, reps=3)}
    lib = []
    for c in copies:
        q, k, v = (x.transpose(1, 2).detach().requires_grad_()
                   for x in c[:3])
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        lib.append((out, (q, k, v), c[5].transpose(1, 2)))

    def library(i):
        out, ins, dout = lib[i % 2]
        return torch.autograd.grad(out, ins, dout, retain_graph=True)
    row["library_ms"] = time_cuda(library, iters=10)
    row["bound_ms"], row["bound_by"] = flash_bwd_bound_ms(b, s, h, kk, hd, vd,
                                                          2)
    row["sdpa_vs_kernel_rel"] = [rel_l2(a.transpose(1, 2), w) for a, w in
                                 zip(library(0), bwd(0))]
    log(f"K3 bwd at B={b} S=T={s} H={h} hd={hd} bf16: graph {row['ms']:.4f} "
        f"ms, eager {row['eager_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), plain {row['plain_ms']:.2f} ms, sdpa backward "
        f"{row['library_ms']:.4f} ms (rel L2 to the kernel "
        f"{row['sdpa_vs_kernel_rel']}); K3 forward graph "
        f"{row['fwd_graph_ms']:.4f} ms, with lse {row['fwd_lse_graph_ms']:.4f}"
        f" ms")
    del copies, lib
    torch.cuda.empty_cache()
    return row


TRAIN_LOSS_RTOL = 1e-5     # tiny fp32 LM, card vs CPU: loss and metrics
TRAIN_GRAD_TOL = 1e-5      # its gradients, per entry, of their global norm
TRAIN_STEPS = 20           # olmo-1b's full-width run
TRAIN_BATCH = 2            # train_4k's global batch of 256 cut to one card
TRAIN_SEQ = 4096           # train_4k's sequence length


def tiny_gqa_config():
    """The tiny fp32 model of :func:`check_model_against_cpu`: GQA g = 2,
    a full and a window-6 layer."""
    from repro_torch.configs.base import LayerSpec, ModelConfig
    return ModelConfig(
        name="tiny-check", arch_type="dense", num_layers=2, d_model=64,
        d_ff=128, vocab_size=128, num_heads=4, num_kv_heads=2, head_dim=16,
        compute_dtype="float32", param_dtype="float32",
        kv_cache_dtype="float32",
        pattern=(LayerSpec(), LayerSpec(attn_kind="swa")), window=6)


def check_train_step_against_cpu(dev, cfg) -> dict:
    """Phase 12 (c): a tiny fp32 LM's loss and gradients
    (``steps.make_loss_and_grads``) and one ``make_train_step`` step on
    the card against the same params and ``lm_batch`` batch on the CPU,
    TF32 off (matmuls and cuDNN) for the check: loss, ce, aux and the
    step's metrics to ``TRAIN_LOSS_RTOL``, every gradient entry to
    ``TRAIN_GRAD_TOL`` of the global norm.  On the card the whole-prompt
    attention runs K3's SIMT variant forward and its fp32 backward
    kernel: one backward launch a layer, one forward a layer (two under
    ``remat``)."""
    import torch
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    cpu = torch.device("cpu")
    params = tf.init_params(cfg, torch.Generator().manual_seed(SEED),
                            device=cpu)
    batch = lm_batch(torch.Generator().manual_seed(SEED + 1), batch=2,
                     seq_len=24, vocab_size=cfg.vocab_size)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = []
    try:
        for d in (cpu, dev):
            p, b = _to_device(params, d), _to_device(batch, d)
            ops.reset_launches()
            loss, met, grads = steps.make_loss_and_grads(cfg)(p, b)
            launched = dict(ops.launches)
            _, _, m = steps.make_train_step(cfg, opt_cfg)(
                p, adamw.init(opt_cfg, p), b)
            runs.append(({"loss": loss, **met}, _by_path(grads), m,
                         launched))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (lc, gc_, mc, _), (lg, gg, mg, launched) = runs
    worst = {"loss_rel": 0.0, "grad_of_norm": 0.0}
    for want, got in ((lc, lg), (mc, mg)):
        for k in want:
            w, g = float(want[k]), float(got[k])
            rel = abs(g - w) / max(abs(w), 1e-7)
            worst["loss_rel"] = max(worst["loss_rel"], rel)
            check(rel <= TRAIN_LOSS_RTOL or abs(g - w) <= 1e-7,
                  f"{cfg.name} train step {k}: card {g!r} vs CPU {w!r}")
    norm = float(np.sqrt(sum(np.sum(np.square(v.astype(np.float64)))
                             for v in gc_.values())))
    for k, w in gc_.items():
        err = float(np.abs(gg[k] - w).max()) / norm
        worst["grad_of_norm"] = max(worst["grad_of_norm"], err)
        check(err <= TRAIN_GRAD_TOL, f"{cfg.name} gradient {k}: max diff "
              f"{err:.3e} of the global norm > {TRAIN_GRAD_TOL:g}")
    layers = cfg.num_layers
    remat = cfg.remat in ("full", "full_inner")
    check(launched["flash_attention_bwd"] == layers
          and launched["flash_attention"] == layers * (1 + remat)
          == launched["flash_attention_simt"],
          f"{cfg.name} loss and gradients on the card launched {launched}, "
          f"want {layers} K3 backward and {layers * (1 + remat)} SIMT "
          f"forward launches")
    log(f"{cfg.name} train step, card vs CPU: loss {float(lg['loss']):.6f} "
        f"(rel {worst['loss_rel']:.2e}), gradients within "
        f"{worst['grad_of_norm']:.2e} of their norm {norm:.4f}; launches "
        f"{ {k: v for k, v in launched.items() if v} }")
    return {**worst, "launches": {k: v for k, v in launched.items() if v}}


def train_phase(dev) -> dict:
    """Phase 12 (d): olmo-1b at full width (16 layers, d_model 2048, vocab
    50,304, fp32 params, bf16 compute, ``remat="full"``) trained
    ``TRAIN_STEPS`` steps through ``repro_torch.launch.train``'s
    ``build_trainer`` and ``Trainer.run`` at global batch 2 x 4096 tokens
    (``--batch``: train_4k's 256 does not fit one card).  Each step's
    device time from CUDA events around the train step and each batch's
    ``lm_batch`` time (synchronised) are recorded by wrappers; the
    (vocab, vocab) table's build is timed apart.  Checks: every loss and
    gradient norm finite, step 0's loss within 1.0 of ln 50,304, the
    last loss below the first, K3 forward launches = 16 x steps x 2
    (the remat recompute), all on the tensor-core variant, K3 backward
    launches = 16 x steps."""
    import math
    import torch
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    gc.collect()
    torch.cuda.empty_cache()
    args = train.parse_args(["--arch", "olmo-1b", "--steps",
                             str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
                             "--seq", str(TRAIN_SEQ), "--log-every", "1"])
    trainer = train.build_trainer(args)
    cfg = trainer.cfg
    t = time.perf_counter()
    synthetic.lm_table(cfg.vocab_size, 42, trainer.device)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t
    data_ms, events = [], []
    data_iter, train_step = trainer.data_iter, trainer.train_step

    def timed_data(seed):
        it = data_iter(seed)
        while True:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = next(it)
            torch.cuda.synchronize()
            data_ms.append((time.perf_counter() - t0) * 1e3)
            yield batch

    def timed_step(*a):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = train_step(*a)
        ev[1].record()
        events.append(ev)
        return out
    trainer.data_iter, trainer.train_step = timed_data, timed_step
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    result = trainer.run(verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = dict(ops.launches)
    step_ms = [a.elapsed_time(b) for a, b in events]
    steady = sorted(step_ms[2:])
    med = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(x.numel() for x in _leaves(result["params"]))
    losses = [h["loss"] for h in result["history"]]
    gnorms = [h["grad_norm"] for h in result["history"]]
    out = {"arch": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "params": n_params, "wall_s": wall,
           "table_build_s": table_s, "median_step_ms": med,
           "step_ms": step_ms, "median_data_ms": sorted(data_ms)[
               len(data_ms) // 2], "data_ms": data_ms,
           "tokens_per_s": tokens / (med / 1e3),
           "model_flops_share": 6 * n_params * tokens / (med / 1e3)
           / BF16_FLOPS,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "grad_norms": gnorms,
           "launches": {k: v for k, v in launched.items() if v}}
    log(f"phase 12, olmo-1b trained at B={TRAIN_BATCH} x S={TRAIN_SEQ}: "
        f"median step {med:.2f} ms ({out['tokens_per_s']:.0f} tokens/s, "
        f"model FLOPs {out['model_flops_share']:.3f} of 989 TFLOP/s), data "
        f"{out['median_data_ms']:.1f} ms a batch (table {table_s:.2f} s), "
        f"peak memory {out['max_memory_allocated_gb']:.2f} GB; losses "
        f"{[round(x, 4) for x in losses]}; launches {out['launches']}")
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"olmo-1b training: a loss or gradient norm is not finite")
    ln_v = math.log(cfg.vocab_size)
    check(abs(losses[0] - ln_v) <= 1.0,
          f"olmo-1b step 0 loss {losses[0]:.4f}, ln V = {ln_v:.4f}")
    check(losses[-1] < losses[0], f"olmo-1b loss did not fall: {losses}")
    layers = cfg.num_layers
    check(launched["flash_attention"] == layers * TRAIN_STEPS * 2
          == launched["flash_attention_wgmma"],
          f"olmo-1b training: {launched['flash_attention']} K3 forward "
          f"launches ({launched['flash_attention_wgmma']} wgmma), want "
          f"{layers} layers x {TRAIN_STEPS} steps x 2 (remat)")
    check(launched["flash_attention_bwd"] == layers * TRAIN_STEPS,
          f"olmo-1b training: {launched['flash_attention_bwd']} K3 backward "
          f"launches, want {layers} x {TRAIN_STEPS}")
    out["step_profile"] = profile_train_step(
        trainer, result["params"], result["opt_state"], med)
    del result, trainer
    synthetic.lm_table.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    return out


# kernel families of a train step's profile, by name
TRAIN_FAMILIES = (("K3 backward", ("flash_bwd_",)),
                  ("K3 forward", ("flash_attention_sm90",)),
                  ("GEMMs", ("gemm", "xmma", "nvjet", "cutlass")),
                  ("AdamW foreach", ("multi_tensor_apply",)))


def profile_train_step(trainer, params, opt_state, median_ms: float,
                       steps: int = 2) -> dict:
    """Where an olmo-1b train step's time goes: ``steps`` steps from the
    trained state on one batch under ``torch.profiler``, device busy ms
    a step by kernel family (``TRAIN_FAMILIES``, the rest as "other")
    and launches, against the run's median step: the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batch = next(trainer.data_iter(trainer.tcfg.seed + 1))
    params, opt_state, _ = trainer.train_step(params, opt_state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            params, opt_state, _ = trainer.train_step(params, opt_state,
                                                      batch)
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    fam = {name: 0.0 for name, _ in TRAIN_FAMILIES}
    fam["other"] = 0.0
    for ms, _, key in rows:
        hit = next((name for name, keys in TRAIN_FAMILIES
                    if any(k in key.lower() for k in keys)), "other")
        fam[hit] += ms / steps
    busy = sum(r[0] for r in rows) / steps
    out = {"device_busy_ms": busy,
           "launches": sum(r[1] for r in rows) / steps,
           "median_step_ms": median_ms, "idle_share": 1.0 - busy / median_ms,
           "by_family_ms": fam,
           "top": [[round(ms / steps, 3), c // steps, k]
                   for ms, c, k in rows[:12]]}
    log(f"olmo-1b train step profile: device busy {busy:.2f} ms, "
        f"{out['launches']:g} launches a step, median step {median_ms:.2f} "
        f"ms, idle {out['idle_share']:.3f}; by family "
        f"{ {k: round(v, 2) for k, v in fam.items()} }; top {out['top']}")
    return out


def train_phases(dev) -> dict:
    """Phase 12: K3's backward checked and timed, the tiny LMs' train
    steps against the CPU, then olmo-1b trained at full width."""
    t0 = time.perf_counter()
    out = {"bwd_check": check_flash_bwd(dev),
           "bwd_time": time_flash_bwd(dev),
           # the MLA model takes minicpm3-4b's chunked loss, at chunks of 8
           "tiny_steps": {c.name: check_train_step_against_cpu(dev, c)
                          for c in (tiny_gqa_config(), tiny_moe_config(),
                                    tiny_mla_config().with_(logits_chunk=8))},
           "olmo_1b": train_phase(dev)}
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 12, LM training: {out['wall_s']:.1f} s wall")
    return out


def main(argv) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also run decode step 2 of each engine and one "
                         "1024-token whole-prompt prefill per engine (per "
                         "zoo's larger model in phases 9 and 10), and one "
                         "prefill and ring decode step of each ring run, "
                         "under torch.profiler and print the breakdowns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    # the plain versions are references: full fp32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall for "
        f"{sorted(built)} (parallel nvcc)")
    for name, (secs, text) in built.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name} ({secs:.1f} s): {line.strip()}")
    sm90 = check_sm90_resources()
    k1_res = check_paged_resources()
    k4_res = check_scan_resources()
    k2_res = check_mux_resources()
    bwd_res = check_bwd_resources()

    k1_err = check_paged_attention(dev)
    k1 = time_paged_attention(dev)
    k1_mla_err = check_paged_mla(dev)
    k1_mla = time_paged_mla(dev)
    k1_g2 = gemma2_paged(dev)
    k2_err = check_mux_score(dev)
    k2 = time_mux_score(dev)
    probe_srv, probe_tokens = probe_server(dev)
    probe = {"graphs_vs_eager": check_probe_graphs(dev, probe_srv,
                                                   probe_tokens)}
    k3_err = check_flash_attention(dev)
    k3 = time_flash_attention(dev)
    k3_g2 = gemma2_flash(dev)
    check_model_against_cpu(dev)
    check_model_against_cpu(dev, tiny_mla_config())
    check_model_against_cpu(dev, tiny_moe_config())
    k4_err = check_selective_scan(dev)
    k4 = time_selective_scan(dev)
    check_mamba_against_cpu(dev)

    cfgs = [get_config("olmo-1b"), get_config("codeqwen1.5-7b")]
    finite = {"bad": 0, "seen": 0}

    def on_logits(x):
        finite["seen"] += 1
        finite["bad"] += int(not bool(torch.isfinite(x).all()))

    new_tokens = 32
    prompts = make_prompts(np.random.default_rng(SEED), 50_304)
    sched_prompts = make_sched_prompts(np.random.default_rng(SEED + 1),
                                       50_304)
    zoo = build_zoo(dev, cfgs, [512, 256], prompts + sched_prompts,
                    dtype=torch.bfloat16, on_logits=on_logits)
    log(f"zoo: setup {zoo['setup_s']:.1f} s, threshold "
        f"{zoo['threshold']:.6f}")
    probe["capture_race"] = check_capture_race(dev, zoo)
    graphs = {"paged": check_decode_graphs(dev, zoo)}

    # phase 3: the direct path (probe -> prefill_into_pages -> decode)
    stats, graphs["direct"] = serve_direct(dev, zoo, prompts, cfgs,
                                           new_tokens=new_tokens)

    # phase 4: the scheduler path, the main path of this run; phase 5:
    # the same without the probe's prewarm, so admissions prefill on
    # the backends' executor threads
    runs = {}
    for phase, prewarm in ((4, True), (5, False)):
        run = serve_scheduler(dev, zoo, sched_prompts, new_tokens=new_tokens,
                              prewarm=prewarm)
        log(f"phase {phase}, scheduler path (prewarm {prewarm}): "
            f"{run['completed']} requests in {run['wall_s']:.2f} s, "
            f"{run['decode_batches']} decode batches "
            f"({run['mixed_admission_batches']} mixed), launches "
            f"{run['launches']}")
        for e in run["engines"]:
            log(f"  {json.dumps(e)}")
        check_scheduler(run, sched_prompts, cfgs, new_tokens)
        runs[prewarm] = run
    run = runs[True]
    check(finite["seen"] > 0 and finite["bad"] == 0,
          f"{finite['bad']} of {finite['seen']} logits tensors not finite")
    if args.profile:
        # after the served phases: a profiler window slows later launches
        rng = np.random.default_rng(SEED + 2)
        for prof in [profile_prefill(e, rng, 1024) for e in zoo["engines"]]:
            log(f"  prefill profile {json.dumps(prof)}")
        prof_run = serve(dev, zoo, prompts, new_tokens=new_tokens,
                         profile_step=2)
        for e in prof_run["engines"]:
            log(f"  graphed decode step profile {e['model']} "
                f"({e['requests']} rows): {json.dumps(e['profile'])}")

    # phase 6: the ring-cache path of the launcher, after freeing the zoo
    del zoo
    free_zoo("the zoo of phases 3-5")
    finite.update(bad=0, seen=0)
    ring = {}
    for arch, plen, new, scan in RING_RUNS:
        r = serve_ring(dev, arch, prompt_len=plen, new_tokens=new,
                       step_times=16, profile=args.profile,
                       on_logits=on_logits)
        log(f"phase 6, {arch} ring path: {json.dumps(r)}")
        check_ring(r, scan=scan)
        ring[arch] = r
        gc.collect()
        torch.cuda.empty_cache()
    check(finite["seen"] > 0 and finite["bad"] == 0,
          f"phase 6: {finite['bad']} of {finite['seen']} logits tensors not "
          f"finite")
    # phase 7: the paper's image mux (serve and MuxScheduler)
    image, image_srv, image_x = image_mux_phase(dev)
    # phase 8: Algorithm 1 trained, the paper's tables, the trained mux served
    paper, paper_state = paper_phase(dev)
    # phase 9: MLA (minicpm3-4b) and an int8 pool (olmo-1b) served
    mla = mla_phase(dev, on_logits, finite, args.profile)
    # phase 10: gemma2-27b and olmoe-1b-7b served (the zoo's remaining models)
    zoo10 = zoo_phase(dev, on_logits, finite, args.profile)
    # phase 11: speculative decoding, SpeculativeBackend under the scheduler
    spec = spec_phase(dev)
    # phase 12: LM training (K3's backward, the train step, olmo-1b trained)
    training = train_phases(dev)
    # last: its torch.profiler window leaves the host slower at every later
    # launch, which would show in the served phases' decode rates
    probe["by_path"] = time_probe(dev, probe_srv, probe_tokens)
    image["serve_profile"] = profile_serve(
        dev, image_srv, image_x,
        image["serve"]["argmax"]["serve_wall_ms_median"])
    paper["zoo_step_profile"] = profile_zoo_step(
        dev, paper_state, paper["training"]["zoo_cnt"]["median_step_ms"])

    launches = run["launches"]
    bwd = training["bwd_time"]
    mla_launches = mla["scheduler_launches"]
    zoo_launches = {k: zoo10[k]["scheduler_launches"] for k in ("A", "B")}
    meta_form = image["meta_form"] + paper["served"]["meta_form"]
    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:289",
         "launches": launches["paged_attention"],
         "max_abs_err": max(k1_err, k1["served_err"], k1_mla_err),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None,
         "phase9_launches": {k: mla_launches[k] for k in K1_FORMS},
         "mla_shape": k1_mla,
         "phase10_launches": {z: {k: zl[k] for k in K1_FORMS}
                              for z, zl in zoo_launches.items()},
         "g2_shape": k1_g2},
        {"name": "mux_score", "route": "cuda",
         "source": "src/repro_torch/csrc/mux_score.cu",
         "replaces": "src/repro/kernels/mux_score.py:47",
         "launches": launches["mux_score"],
         "meta_launches": {**image["meta_launches"],
                           "paper": paper["served"]["k2_launches"]},
         "max_abs_err": max(k2_err, *(r["max_abs_err"] for r in
                                      meta_form)),
         "ms": k2["ms"], "graph_ms": k2["graph_ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None,
         "meta_form": meta_form},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:157",
         "launches": launches["flash_attention"],
         "max_abs_err": k3_err, "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "phase9_launches": {
             k: mla_launches[k] for k in ("flash_attention",
                                          "flash_attention_wgmma")},
         "mla_shapes": k3["mla_shapes"],
         "phase10_launches": {z: {k: zl[k] for k in K3_COUNTS}
                              for z, zl in zoo_launches.items()},
         "g2_shape": k3_g2},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:157",
         "gradient_of": "flash_attention",
         "launches": training["olmo_1b"]["launches"]["flash_attention_bwd"],
         "max_abs_err": training["bwd_check"]["max_abs_err"],
         "rel_l2": training["bwd_check"]["rel"],
         "ms": bwd["ms"], "eager_ms": bwd["eager_ms"],
         "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
         "bound_by": bwd["bound_by"], "library_ms": bwd["library_ms"],
         "fwd_ms": bwd["fwd_graph_ms"], "fwd_lse_ms": bwd["fwd_lse_graph_ms"],
         "ptxas": bwd_res},
        {"name": "selective_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/selective_scan.cu",
         "replaces": "src/repro/kernels/selective_scan.py:65",
         "launches": ring["falcon-mamba-7b"]["launches"]["selective_scan"],
         "max_abs_err": k4_err, "ms": k4["ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None},
    ]
    # launches: the scheduler path's run (K1-K3) and phase 6's falcon-mamba
    # run (K4); phase9_launches: phase 9's scheduler run (minicpm3-4b +
    # olmo-1b int8; K1 by form: all, int8 pages, the MLA latent); K1's
    # mla_shape / K3's mla_shapes: their times at minicpm3-4b's decode /
    # prefill shapes; phase10_launches: phase 10's scheduler runs (zoo A:
    # olmo-1b + gemma2-27b, zoo B: olmo-1b + olmoe-1b-7b; by form, windowed
    # launches those of gemma2's swa layers); g2_shape: K1's / K3's rows at
    # gemma2's decode / prefill shapes (K3 with the window and without,
    # library_ms flex_attention's; cap_bound: both on q scaled 16x);
    # plain_ms is the plain PyTorch version's time, no
    # yardstick
    # of speed; K2's ms / bound are its head form's at the served probe
    # shape (graph_ms: the same as a CUDA graph, as the probe runs it);
    # its meta form's launches on phase 7's image path (serve, scheduler)
    # and phase 8's trained muxes (paper), and its times at the served
    # shapes, are meta_launches / meta_form; K3's backward (its gradient,
    # replacing no TPU kernel of its own): launches in phase 12's olmo-1b
    # run, ms its CUDA-graph time at olmo-1b's train shape (eager_ms
    # beside it), library_ms scaled_dot_product_attention's backward
    # through autograd, fwd_ms / fwd_lse_ms K3's forward graphed without
    # and with the row log-sum-exps
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"paged_attention_ptxas": k1_res,
                      "paged_attention_by_shape": k1["shapes"]}), flush=True)
    print(json.dumps({"selective_scan_ptxas": k4_res,
                      "selective_scan_by_shape": k4["shapes"]}),
          flush=True)
    print(json.dumps({"flash_attention_sm90": sm90,
                      "flash_attention_by_shape": k3["shapes"]}), flush=True)
    print(json.dumps({
        "direct": {
            "launches": stats["launches"],
            "prefill_ms_per_request": stats["prefill_ms"],
            "decode_tokens_per_s": {e["model"]: e["decode_tokens_per_s"]
                                    for e in stats["engines"]}},
        **{name: {
            "requests": r["completed"], "wall_s": r["wall_s"],
            "launches": r["launches"],
            "ttft_p50_ms": r["ttft_p50_ms"], "ttft_p99_ms": r["ttft_p99_ms"],
            "by_model": {e["model"]: {k: e[k] for k in (
                "requests", "ttft_p50_ms", "ttft_p99_ms",
                "decode_tokens_per_s")} for e in r["engines"]}}
           for name, r in (("scheduler", runs[True]),
                           ("scheduler_no_prewarm", runs[False]))}}),
        flush=True)
    print(json.dumps({"ring": {arch: {k: r[k] for k in (
        "prefill_ms", "decode_tokens_per_s", "eager_decode_tokens_per_s",
        "median_decode_step_ms", "capture_s", "steps", "prefills",
        "launches", "profile")} for arch, r in ring.items()}}),
        flush=True)
    print(json.dumps({"decode_graphs": graphs}), flush=True)
    print(json.dumps({"probe": {"mux_score_ptxas": k2_res, "mux_score": k2,
                                **probe}}), flush=True)
    print(json.dumps({"image_mux": image}), flush=True)
    print(json.dumps({"paper": paper}), flush=True)
    print(json.dumps({"mla_phase": mla}), flush=True)
    print(json.dumps({"zoo_phase": zoo10}), flush=True)
    print(json.dumps({"spec_phase": spec}), flush=True)
    print(json.dumps({"train_phase": training}), flush=True)
    return finish()


def finish() -> int:
    """The card's name and power limit, then the closing line."""
    import torch
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
