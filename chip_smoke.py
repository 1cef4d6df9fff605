#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds, serves,
trains and infers.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. build — compile every hand-written kernel from the sources in this
   checkout (one nvcc per source, all at once, sm_90a), print the
   ptxas report (and its wgmma warnings); the ten wgmma kernels
   (flash_fwd_sm90.cu, flash_dq_sm90.cu, flash_dkv_sm90.cu,
   lstm_fwd_sm90.cu, lstm_bwd_sm90.cu, flash_fwd_tf32_sm90.cu,
   flash_dq_tf32_sm90.cu, flash_dkv_tf32_sm90.cu,
   lstm_fwd_bf16x3_sm90.cu, lstm_bwd_bf16x3_sm90.cu) must report 0
   spill bytes and no C75xx
   warning (products serialized), and the window kernel
   (paged_window_attention.cu), the cluster GRU kernel
   (gru_fwd_sm90.cu) and the decode kernel (decode_attention.cu) 0
   spill bytes. Then the building blocks of
   sm90_pipeline.cuh on one 64 x 64 bf16 tile: A B^T by wgmma SS over
   TMA-loaded K-major tiles and A B by wgmma RS with B MN-major; the
   LSTM backward's product, a [64, 200] x [16, 200]^T by wgmma
   m64n16k16 over TMA-loaded 64-column chunks and its weight tile
   layout; and the LSTM forward's, a [64, 120] x [120, 64] by wgmma
   m64n64k16 over its gate-major weight tiles; each against float32
   torch products (max |err| <= 1e-3 x max(1, max|ref|)); the float32
   LSTM forward's three bf16 passes, a float32 [64, 200] x [200, 40]
   split by the kernel's own writers into the fragment-order planes
   and the resident weight halves, on wgmma m64n40k16 RS, against the
   float64 product (max |err| <= 1e-5 x max(1, max|ref|), which the
   kernel's one-pass product must fail), the float32 backward's the
   same way over W-row tiles (a [64, 200] x [40, 200]^T), and
   lstm_fwd_bf16x3_plan and lstm_bwd_bf16x3_plan (ops/fused_rnn.py)
   against each kernel's own plan at every h 1..1400; and
   sm90_tf32.cuh's 3xTF32 products on float32 tiles (TMA-loaded, split
   into TF32 hi and lo): A B^T by SS m64n32k8 and (A B^T) B by RS
   m64n64k8, the A operand split in registers from the accumulator and
   B transposed in the fragment's k order, against float64 products
   (max |err| <= 1e-5 x max(1, max|ref|), which one TF32 pass fails);
   then flash_tf32_plan (ops/flash_attention.py) against the float32
   forward, dq and dk/dv kernels' own plan and shared bytes at every d
   8..128; and decode_smem_bytes (ops/paged_decode.py, which
   decode_plan sizes its chunks by) against the decode kernel's own
   layout at every rep 1..32, dh 8..512, chunk 32..544, both element
   sizes.
2. kernel vs plain — paged window attention at full width (dh 64,
   page 16, 8 slots, 34 pages a slot, lengths up to 544), h/g in
   {8/8, 8/2, 8/1}, W in {1, 4}, float32 and bfloat16, against the
   plain PyTorch version on the same inputs: rtol 2e-4 / atol 2e-5 in
   float32 (the JAX package's bound for its kernel against its
   einsum), atol 2e-2 in bfloat16 (bf16 output rounding); a row with
   kv_len 0 against the TPU kernel's value for it, the mean of V over
   the slot's used pages; the allocated-pages contract — NaN
   written into every page past each slot's used count changes
   nothing; out-of-range table entries inside two slots' used pages
   (one slot within one chunk, one over several, so the merge carries
   it) make those slots' rows NaN and leave every other row equal to
   the clean call's; and after the synchronized calls every arrival
   counter of the kernel's merge reads 0 again.
3. engine — the main path through the entry points a user calls: a
   full-width transformer_lm (vocab 32000, d_model 512, 8 heads, 6
   layers, d_ff 2048, max_len 544, float32, random weights from seed
   0) in a DecodeEngine with 8 slots, 16-token pages, 273 pages and
   the prefix cache on, serving 16 seeded requests (prompts 16-96
   tokens, 16-64 new tokens). Kernel launch counts are zeroed just
   before and read just after. Asserts: every request finishes with
   its tokens, zero step failures, launches == steps x 6 layers,
   balanced page accounting, and greedy tokens of 4 requests
   identical to the port's dense TransformerDecoder.generate on the
   card under the tie rule.
4. timings — the float kernel's median device time per call at the
   engine's shapes, one token (W 1) and the speculation window (W 3)
   (CUDA-graph replay timed with CUDA events; pool slices cycled over
   the 6 layers — the used pages of the 8 slots, ~24 MB, stay in the
   50 MB L2), the host's eager issue time, the chunk plan (C pages a
   block), the kernel's floors (launches stopped after the prologue,
   after the gather, before the merge), its byte/flop bound, the plain
   version's time, and
   torch.nn.functional.scaled_dot_product_attention on the gathered
   view as a yardstick (library_ms; the port never calls it).
5. trace — 8 more requests under torch.profiler: device busy time by
   kernel against the wall clock, per engine step.
6. flash vs plain — the flash attention forward, dq and dk/dv kernels
   at full width ([8, T, 8, 64]): causal T 1024 with ragged kv_lens,
   and non-causal T 1000 (not a block multiple) with q_lens below T
   and fully-masked rows, then the causal case at head dim 128 and the
   non-causal one at head dim 72 (a d tail the TMA zero-fills), each
   in float32 (the 3xTF32 wgmma forward, dq and dk/dv) and bfloat16
   (the wgmma forward, dq and dk/dv); out, lse, dq, dk, dv against
   autograd of the plain version in float32 on the same values:
   float32 assert_close(rtol 2e-4, atol 2e-5 max(1, max|ref|)), lse
   also max |err| <= 2e-5 max(1, max|ref|) with no relative term (an
   error in lse scales a whole row of p), bfloat16 max |err| <= 2e-2
   max(1, max|ref|), and per (batch row, head) slice max |err| <= 2e-2
   max|ref| of the slice (floored at 1e-3 max(1, max|ref|) for slices
   0 by cancellation), which must reject two planted faults each of dq
   and dv (zeroed past query / key 64; x 0.95 outside the largest
   slice), as the float32 bound must, and the float32 bound also two
   of the forward (out x 0.95 in its largest slice; lse + 1e-3 past
   query 64); fully-masked rows give lse == NEG_INF and out == 0.
7. train — the main training path: the full-width tied transformer_lm
   (vocab 32000, d_model 512, 8 heads, 6 layers, d_ff 2048, 1024
   tokens) built with the port's DSL, Parameters.create, and
   SGD.train_batch with Adam(1e-4) in bfloat16 on one seeded batch of
   8 full-length rows: 2 warm-up steps, then 8 timed steps with the
   flash launch counts zeroed just before and read just after. Asserts
   finite, falling losses, finite parameters and, by route, steps x 6
   launches of the wgmma forward, dq and dk/dv, none of the float32
   (tf32x3) kernels. Then, from one table, the gradients of
   one Topology.forward cost with use_flash_attention True against
   False, in bfloat16 (worst per-parameter ||diff|| / ||g|| at most
   max(2e-2, twice the plain path's own spread under a one-ulp bf16
   input perturbation, x (1 + 2^-7)); costs within 2e-2) and in float32
   (at most max(1e-3, twice the spread under a 2^-22 perturbation);
   costs within 1e-5) — the ReLU makes the gradient discontinuous, so
   at this width two correct float32 runs differ by ~1e-3. Each q, k,
   v and output projection is also held against twice its own spread,
   and that per-leaf check must reject a planted dv x 0.85.
8. train -> serve — the trained table through Parameters.to_tar,
   load_params_tar, TransformerDecoder (tied head) and DecodeEngine:
   4 seeded requests, zero step failures, tokens identical to the
   dense generate under the tie rule.
9. flash timings — each flash kernel's device time per call at the
   training shapes, bf16 (the wgmma kernels) and f32 (the tf32x3
   forward, dq and dk/dv) by CUDA-graph replay over 6 input sets,
   its bound by route (the tf32x3 kernels': three TF32 passes of every
   product at 494.7 TFLOP/s, printed beside the SIMT float32 floor at
   67 TFLOP/s, which is no bound for them; a reading under its bound
   fails), the plain version's time, and SDPA as a yardstick (forward
   by graph replay; autograd backward against dq + dk/dv together, by
   events behind a spin kernel so the host's call rate is not timed).
10. train trace — one bfloat16 train step under torch.profiler (run
   right after phase 7): device busy time against the wall clock, the
   top kernels, the flash share and each flash kernel's.
11. rnn vs plain — the fused LSTM forward (with and without residuals)
   and backward kernels and the GRU forward kernels against their plain
   versions on the same inputs: the LSTM at full width (b 128, h 1280,
   T 128, ragged lengths with 100, 1 and 128), at b 6, h 48, T 13 (a
   multiple of no tile) and at two batch tiles (b 160, h 256, T 17),
   and at an odd h with every row shorter than T (b 5, h 45, T 9, the
   gates past the longest row held to 0, the kernels' value there),
   the GRU at the tagger's batch (b 64, h 128, T 64 ragged), at b 6, h
   48, T 13 and b 5, h 45, T 9 (odd h), at h 160, 256, 352 (b 37:
   a cluster's rows part empty), 448 and 1024, and at b 600, h 48 (2
   rows a block), so that every cluster size of gru_fwd_sm90.cu (1, 2,
   4, 8), 1, 2 and 4 rows a cluster and the cooperative gru_fwd.cu
   run in float32 and bfloat16, each call on gru_fwd_plan's route
   (counted by route), out also per time step (a stale step T/2 must
   fail), after the plan's shared-memory arithmetic is held against
   the kernel's layout; the LSTM's h_seq, hT, cT, cseq, gates,
   dz, and through the autograd Function dx4, dw, dbias, dpeep against
   autograd of the plain version in float32; float32 (the forward and
   backward on three bf16 wgmma passes, lstm_fwd_bf16x3_sm90.cu and
   lstm_bwd_bf16x3_sm90.cu) and bfloat16 (the tensor-core forward and
   backward, lstm_fwd_sm90.cu and lstm_bwd_sm90.cu; each direct
   forward and backward call on its dtype's route) at the tolerances
   of phase 6; the bf16 out of
   both forward calls and dz also per time step, max |err| <= 2e-2
   max|ref| of the step, which must reject planted faults (out x 0.95
   at step 0, out stale at step T/2 — step T/2 - 1's — and dz x 0.95
   at step 0); the float32 out of both forward calls per time step at
   the float32 tolerance (atol scaled by the step's max(1, max|ref|)),
   which must reject out x 0.99 at step 0 and out stale at step T/2,
   and the float32 dz the same way (dz x 0.99 at step 0, dz stale at
   step T/2).
12. lstm train — the sequence slice's main path: stacked_lstm_net at
   the RNN benchmark's widest row (vocab 30000, emb 128, hidden 1280,
   one LSTM, 2 classes; 11,060,482 parameters) built with the port's
   DSL, Parameters.create from a seeded generator, SGD.train_batch
   with Adam(5e-4) (the benchmark's 2e-3 overshoots at this width, see
   LSTM_LR) in bfloat16 on one seeded batch of 128 rows of 100
   tokens: 2 warm-up steps, then 8 timed steps with the launch counts
   zeroed just before. Asserts finite, falling losses, finite
   parameters and 8 launches each of the LSTM forward (with residuals)
   and backward kernels, every forward and backward on the tensor-core
   route (sm90). Then, in float32 from one table on 16 of the
   rows, the gradients of one cost through the kernels (the backward on
   the bf16x3 route) against the plain scan of the CPU port: worst
   per-parameter ||diff|| / ||g|| <= 1e-3.
13. lstm infer — paddle.infer of the probabilities over 512 seeded
   ragged samples in batches of 128, float32, from the trained table:
   4 forward launches without residuals, all on the float32 (bf16x3)
   route, probabilities within 1e-4 of the CPU port's.
14. tagger — rnn_crf_tagger at its defaults (vocab 20000, 45 labels,
   emb 128, hidden 128): 3 float32 train steps on 64 sentences of 8-64
   tokens (the plain GRU scans, no kernel launch), then infer of the
   Viterbi path over 256 sentences in batches of 64: 4 GRU kernel
   launches, all on the sm90 route (gru_fwd_sm90.cu), labels identical
   to the CPU port's, sentences/s beside the cooperative kernel's
   recorded 137.598 ms (PERF.md); then one 64-sentence
   infer batch under torch.profiler: device busy against the wall
   clock, the top kernels, the GRU kernel's share and launches (one
   launch required; a launch with no record in the trace is noted).
15. rnn timings — each recurrent kernel's device time per call and per
   run step at the main path's shapes in bfloat16 and float32
   (CUDA-graph replay), its bound by route (the float32 LSTM forward's
   and backward's: three bf16 passes at 989 TFLOP/s, printed beside the
   SIMT float32 floor at 67, which bounds no tensor-core route; a
   reading under its bound fails), the plain version's time; in
   bfloat16 also the per-step floors of both tensor-core LSTM kernels'
   plan (their steps with no product; their grid barriers alone) and
   their ring depth swept (2, 3 and 4 stages of 16 KB); in float32 the
   float32 forward's floors (its steps with no product, its grid
   barriers alone, its h stream alone, its products without the
   stream) and its register ring swept (8 and 4 k-steps, each held
   against the plain version), and the float32 backward's the same way
   (its grid barriers and group syncs alone, its dz stream alone); at
   the
   tagger's batch the cooperative GRU kernel (the earlier route), the
   sm90 GRU kernel's floors (launch and the weight load; the steps
   without the products) and its cluster size swept (1, 2, 4, 8, each
   held against the plain version); in float32 also, where the GRU's
   plan picks clusters of 2, 4, 8 (b 64, h 160, 256, 352 float32, h 448
   bfloat16) or more than one row a cluster (b 200 and 600), every
   cluster size and rows a cluster that hold the weight and the
   cooperative kernel, each held against the plain version, and the
   fastest; and
   cuDNN's LSTM forward as a labelled near-yardstick (printed only;
   bfloat16 by events behind a spin kernel, as phase 9's SDPA
   backward; float32, whose call blocks the host past any spin, as the
   sum of its kernels' device time under torch.profiler, with
   cudnn.allow_tf32 False and True).
16. lstm train trace — one bfloat16 LSTM train step under
   torch.profiler (run right after phase 12): device busy against the
   wall clock, the top kernels, each LSTM kernel's share.
17. int8 kernel vs plain — the int8 path of the paged window kernel
   at phase 2's widths (q float32 and bfloat16, h/g 8/8, 8/2, 8/1, W
   1, 3 and 4, pages quantized on the card) against its plain version
   at phase 2's tolerances; NaN scales past each slot's used pages
   change nothing; phase 2's corrupt table entries and arrival-counter
   check; a kv_len-0 row returns the mean of dequantized V;
   quantize_kv on the card is bit-equal to the CPU port's.
18. decode kernel vs plain — decode_attention at b 8, h 8, g 8/2/1, dh
   64, T 544, shared and per-row lengths (one of them 0, also held
   against the mean of V; rows of 544, 513 and 256 span several
   128-column chunks, so the merge runs), float32 and bfloat16, against
   decode_reference; at g 2 also T 541 and 542, whose cache rows are
   not 16-byte aligned (the kernel's 8-byte, 4-byte and element
   copies); paged_attention(use_kernel=True) against the einsum path
   over phase 3's engine pages; then every arrival counter of the
   merge reads 0. These calls are the kernel's launches: no engine
   route reaches it.
19. int8 engine — phase 3's 16 requests with kv_quant="int8": launches
   of the int8 kernel == steps x 6 and of the float kernel 0, balanced
   pages, the first 4 requests' tokens against the CPU port's int8
   engine on the same table under the tie rule (the tie reference is
   the CPU int8 paged step's teacher-forced logits); prints how many
   requests match the float engine token for token.
20. speculation — phase 3's requests with spec_k 2 (W 3): the
   same-weights draft, then a 2-layer draft from another seed; tokens
   of the first 4 requests agree with the dense reference (tie rule),
   float kernel launches == target steps x 6, same-weights tokens per
   step > 1; prints accepted/proposed and tokens/s against phase 3.
21. two-tier — int8 pages + speculation on a pool cut to 72 pages
   with a 256-page host spill store: waves of 8 prompts sharing a
   two-page prefix push cold pages to host and a revisit restores
   them; spills and restores > 0, revisit tokens equal the first
   visit's, both tiers balance.
22. two-tier timings and trace — the int8 kernel at the int8 engine's
   shapes (W 1 and 3) and the decode kernel at b 8, h 8, T 544 over
   the same 8 lengths (g 8 and 1) and at full context (every row 544,
   g 8 and 1; cache sets of 100 MB or more, past the 50 MB L2),
   float32 and bfloat16, by CUDA-graph replay, with their bounds (the
   decode kernel's counts each row's live columns only), plain times
   and SDPA yardsticks; the decode kernel also with its floors
   (decode_launch stopped at once, after the tile loads, the scores,
   P.V, and before the merge) and its chunk plan swept (32, 64, 128
   columns and the whole T, each held against the plain version);
   then 8 requests through the int8 + speculative engine under
   torch.profiler.
23. full context — both window kernels with every slot at 544 tokens
   (8 slots x 34 pages, h 8, g 8, dh 64, float32 q), float32 and int8
   pages, W 1 and 3, on seeded random pools large enough to exceed the
   50 MB L2 (6 float32 sets, 107 MB; 16 int8 sets, 76 MB): device time,
   bound, plain and SDPA as in phase 4; then the chunk plan swept (C 1,
   2, 4, 8 pages a block) on those pools at the engine's lengths and
   at full context, each C held against the plain version.
24. f32 train — phase 7's main path at the framework's default dtype
   (run after phase 8): the same model, batch and optimizer with
   compute_dtype float32, 2 warm-up steps, then 4 timed steps with the
   flash launch counts zeroed just before and read just after; finite,
   falling losses, finite parameters and, by route, steps x 6 launches
   of the tf32x3 forward, dq and dk/dv, none of the bf16
   kernels; prints step_ms and tokens/s; then one step under
   torch.profiler (device busy against the wall clock, top kernels,
   the flash share).
25. lstm f32 train — phase 12's main path at the framework's default
   dtype (run after phase 13): the same model, batch and optimizer in
   float32, 2 warm-up steps, then 8 timed steps with the launch counts
   zeroed just before: finite, falling losses, finite parameters, and
   exactly 8 launches of the float32 forward with residuals and 8 of
   the float32 backward, all on the bf16x3 route and none on another;
   prints step_ms, samples/s and the peak memory; then one step under
   torch.profiler (device busy against the wall clock, top kernels,
   each LSTM kernel's share).
26. mnist v2 — the port copy of demo/mnist/train.py (only its imports
   changed) at its own width: 784-128-64-10, batch 128, float32,
   Momentum(0.1/128, 0.9, L2 5e-4), the synthetic 8192/1024 set with
   shuffle(8192, seed=1), 2 passes, through the v2 entry points
   (paddle.init, create_parameters, SGD.train, SGD.test, save_pass,
   Parameters.from_tar, infer); the first 16 per-step costs within 1e-4
   relative of the port's CPU run from the same init tar on the same
   batches; finite test cost and classification error; the saved pass
   equal to the trained parameters and its infer of 8 samples within
   1e-5 of the CPU port's. Prints step_ms (train_batch, 8 calls after 2
   warm-ups, phase 7's method) and samples/s over the second whole
   SGD.train pass, reader and feeder included, with the card's name
   and power limit; then one step under torch.profiler (device busy
   against the wall clock, the top kernels). No convergence claim.
27. sequence tagging v2 — the port copy of
   demo/sequence_tagging/train.py at its own width (rnn_crf_tagger,
   vocab 44068, 106 labels, emb 64, hidden 128, batch 16, synthetic
   conll05, the chunk evaluator): 8 training batches, then SGD.test
   over the 400 test sentences, whose 25 batches launch
   gru_fwd_sm90.cu once each (training runs the plain scans); the
   chunk F1 equal to the chunk evaluator's on the decoded ids of the
   plain GRU version run on the card for the same parameters (a
   differing sentence must be a reported near-tie: its two paths' CRF
   scores within 1e-4 relative); then one test batch under
   torch.profiler.
28. convergence — the port copy of demo/mnist/convergence.py's digits
   tier (only its imports and data source changed: convergence_demo,
   convergence_cnn): conv 32 and 64, pool, fc 256 with dropout 0.5,
   Adam(1e-3), init(seed=42), batch 128, 100 passes over the 1438
   training digits of paddle_tpu_torch/dataset/digits.csv.gz, then
   SGD.test over the 359 held out. Prints the script's artifact
   (data, num_passes, batch_size, wall_clock_s, test_accuracy,
   test_cost, met) with the card's name and power limit. Fails below
   the script's target, test accuracy 0.98, on a non-finite cost or
   parameter, or when the first 16 step costs of a dropout-0 copy on
   the card differ by more than 1e-4 relative from the same copy on
   the CPU port, from the card run's init tar. cuDNN's deterministic
   algorithms run for the phase, so it ends on one result.
29. resnet50 — bench.py's resnet50_bs128 (bench_image, :194): resnet50
   at 224 x 224 x 3, 1000 classes, batch 128, Momentum(0.01/128, 0.9,
   L2 0.0005 x 128), in bf16 (the bench's --dtype default) and float32
   (the package default, TF32 off), with torch.backends.cudnn.benchmark
   on for the phase (the 2 warm-up steps absorb the autotuning): 8
   timed train_batch calls on one seeded batch, step_ms, samples/s,
   the analytic model FLOPs (convs and fc; forward + 2 x forward for
   the backward) and the TFLOP/s they imply, peak memory; losses finite
   and falling, every moving statistic changed, finite and detached;
   one bf16 step under torch.profiler; the float32 model's infer of 128
   samples timed, and its test-mode probabilities of 4 samples against
   the CPU port's on the same weights, moving statistics and inputs
   (rtol 1e-4, atol 1e-5).
30. nmt — the sequence-generation path: models/seq2seq.py's
   nmt_attention at its defaults (vocab 30000 / 30000, embedding,
   encoder and decoder 512; 53,193,520 parameters), float32, init(seed
   =5), Adam(1e-3), on the port's wmt14.train() synthetic pairs in
   batches of 64: 8 timed train_batch calls after 2 warm-ups (step_ms,
   samples/s, target tokens/s, the model FLOPs of the batches' valid
   tokens and the TFLOP/s they imply, peak memory), one step under
   torch.profiler; losses and parameters finite, the loss falling, and
   the first 4 step costs within 1e-4 relative of the port's CPU run
   from the same init tar on the same batches. Then nmt_generator at the
   same widths (beam 4, max_length 50) on the trained parameters decodes
   64 wmt14.test() sources (sentences/s, the best path of three): with
   the launch counts zeroed just before and read just after, the
   encoder's forward GRU runs on the cooperative gru_fwd.cu (>= 1
   launch by route "coop"); that GRU's output at the decode's shape is
   held against the plain GRU on the card (_held's float32 bound); the
   best paths equal, token for token, those of a decode with the plain
   GRU on the card, and their scores are within 1e-4; a
   save_inference_model -> load_inference_model round trip on the card
   gives the same paths. Last, the cooperative GRU's device time per
   call at the decode's shape (b 64, h 512, T as fed) by CUDA-graph
   replay, against its bound and the plain version, with the bf16 plan
   the same shape would take.
31. seqToseq v2 — the port copy of demo/seqToseq/train.py (only its
   imports changed: seqtoseq_v2_demo, the package passed in) at the
   script's own widths (dict 1000, 64) and batch 16, 1 pass (the
   script's 2, cut): its costs, its beam paths (beam 3, max_length 12)
   and its seq_text_printer lines; the costs of its first 8 batches
   within 1e-4 relative of the port's CPU run of the same copy from
   the card run's init tar.
32. wide&deep — the row-sparse path: models/recommender.py's
   wide_and_deep at its defaults (vocabularies 100000 / 100000 / 10000,
   emb 64, dense 13, hidden 256 / 128 / 64; 13,744,050 parameters, six
   ParamAttr(sparse=True) tables), float32, Adam(1e-3), init(seed=11),
   batch 512 of seeded synthetic Criteo-shaped rows (CtrData: each
   slot's ids Zipf 1.1 over seeded shuffled ranks, the label a seeded
   logistic rule over the dense features and slot 0's id). Prints the
   mean unique ids a step, step_ms and samples/s of 8 train_batch
   calls after 2 warm-ups, peak memory and one traced step, for the
   sparse tables and for the same graph with dense tables from the
   same init; then both again at vocabularies 1,000,000 / 1,000,000 /
   100,000 (with the step's memory growth over what it holds). Fails unless the 50 sparse steps' costs are finite and
   falling, the first 4 are within 1e-4 relative of the port's CPU run
   from the same init, the rows never fed have Adam's m, v and the
   clock _t exactly 0 and each fed row's _t is its last step,
   Momentum(0.01, 0.9)'s sparse and dense test_params after 8 steps
   agree within rtol 1e-5 / atol 1e-6, and the 1 M-row sparse step
   grows the allocated memory by less than one 1 M x 64 float32 table.
33. recommendation v2 — the port copy of demo/recommendation/train.py
   (only its imports changed: recommendation_v2_demo, the package
   passed in) at the script's settings (movielens_regression with emb
   32, Adam(2e-3), batch 64, 2 passes on the synthetic MovieLens): its
   costs and test mse cost; the costs of its first 8 batches within
   1e-4 relative of the port's CPU run of the same copy from the card
   run's init tar.

34. moe train — bench.py's moe_lm_bs8_t1024 (bench_moe_lm, :528-570):
   phase 7's tied LM with every FFN an 8-expert top-2 MoE (capacity
   factor 1.25, aux coeff 0.01; 123,900,928 parameters, 100,663,296 in
   experts, 7 cost nodes), bf16, Adam(1e-4), 2 warm-ups then 8 timed
   train_batch steps on phase 7's batch: every cost finite, the total
   falling, 48 launches of each bf16 flash kernel and none of the
   float32 ones; step_ms, tokens/s, peak memory; one step under
   torch.profiler (idle share, top kernels, the MoE operations' share
   of busy: the kernels under profiler ranges around ops/moe.py's
   entry points and the autograd nodes of the operations inside
   them). Then layer 0's MoE block of the trained table at 8192 seeded
   tokens in float32, the sort path against the einsum path: y, aux
   and the gradients of x, the gate and both expert tables within
   MOE_PATH_TOL of each tensor's max |ref|.
35. moe serve — phase 34's table through save_parameter_to_tar and
   load_params_tar into TransformerDecoder(moe_k=2), drop-free, in a
   DecodeEngine at phase 3's shapes (8 slots, page 16, prefix cache)
   on the serving mix's first 8 requests: window-kernel launches ==
   steps x 6, every request's tokens equal to the dense decoder's
   generate under the tie rule; tokens/s.
36. flash prefill — phase 3's LM (float32), 2 x 512-token prompts: the
   prefill logits through the flash route (the float32 forward kernel)
   against the einsum route (use_flash_attention off) at rtol 2e-4 /
   atol 2e-4, exactly 6 float32 forward launches a prefill and none
   of the others, both prefill times, generate with and without the
   route agreeing under the tie rule.
37. beam — the same LM, 8 seeded 32-token prompts, max_len 96, beam 4,
   raw-sum then GNMT (alpha 0.6): the n-best lists against the CPU
   port's same call, rank by rank the scores within 1e-4 and the same
   path but where the CPU's score at that rank ties another of its
   ranks within 1e-4 (a near-tie either order may take); sentences/s;
   one raw-sum search under torch.profiler.
38. masked lm — the port copy of demo/masked_lm/train.py (only its
   imports changed: masked_lm_demo, the package passed in) at its own
   sizes, pretraining 6 passes and fine-tuning 3: the MLM loss's last
   4 under 0.75 of its first 4 (the JAX demo test's rule), the
   fine-tune error falling, every trunk parameter loaded, and the
   first 4 MLM costs within 1e-4 relative of the same copy on the CPU
   port from the card run's init tars.
39. ragged and encoder — bf16: phase 7's LM on 8 rows of seeded
   lengths 256-1024, 2 + 4 steps (valid tokens/s, 24 launches of each
   bf16 flash kernel), and phase 7's gradient check on those rows
   (flash against plain, the spread-based bounds, the planted dv
   fault); transformer_encoder at its defaults (32000, 512, 8 heads, 6
   layers, 2048, max_len 512) on 8 masked-LM rows of lengths 128-512:
   one step (6 launches each, non-causal); each of a step's 6 launches
   at its recorded q, k, v and dO held per slice (out against the
   float32 plain version; dq, dk and dv against the plain version of
   the kernels' own functions, p and dS rounded to bf16, with phase
   6's planted faults; against float32 printed), the
   cost against the plain route's; the gradients' distance to a
   float32 run printed (at this init dq cancels, so the bf16 rounding
   of dS moves the last layer's q gradient as much as a planted fault:
   phase 7's spread bound cannot hold it);
   one LM step with dropout 0.1, and in a train-mode forward each
   residual dropout's kept share within 5 sigma of 0.9 and its kept
   values x / 0.9 exactly.
40. googlenet — bench.py's googlenet_bs128 (bench_image, :194; the row
   at :1573): models/image.py's googlenet at 224 x 224 x 3, 1000
   classes, batch 128 (its inception blocks cut one wide 1x1 conv into
   channel slices, slice_projection(channel_slice=True)),
   Momentum(0.01/128, 0.9, L2 0.0005 x 128), in bf16 and in float32
   (TF32 off), with torch.backends.cudnn.benchmark on for the phase: 8
   timed steps of the trainer's step on a feed put on the card once
   after 2 warm-ups, then 8 timed train_batch calls on one seeded
   batch: step_ms, samples/s, the analytic model FLOPs (convs and fc;
   forward + 2 x forward for the backward) and the TFLOP/s they imply,
   peak memory, beside the card's name and power limit and the 2017
   reference's own figure for the row (1149 ms a batch on one K40m,
   BASELINE.md:18; not a target); losses finite and falling on the
   repeated batch, parameters finite; one bf16 step under
   torch.profiler (idle share, top kernels, the convs' share); the
   float32 model's test-mode probabilities of 4 samples against the
   CPU port's on the same weights and inputs (rtol 1e-4, atol 1e-5).
41. layer families — the seven goldens that the layer families unlock
   (util_layers, op_sugar_net, projections, misc_utils,
   extra_algebra_layers, selection_layers, switch_order_net; read from
   tests/golden/) serialize back equal to their files and run on the
   card from the CPU port's init tar on the golden harness's seeded
   batch: outputs and the gradients of a seeded projection of them
   (of the parameters; of the float feeds for util_layers, which has
   none) against the CPU port's at rtol 1e-4 / atol 1e-5 in float32.
   The port copy of demo/vae/vae_train.py (only its imports changed:
   vae_v2_demo) at --passes 6 --batches_per_pass 8: its ELBO falls
   (the last pass under 0.7 of the first, the JAX demo test's rule)
   and its first 8 costs are within 1e-4 relative of the same copy on
   the CPU port from the card run's init tar. The port copy of
   demo/quick_start/train.py (quick_start_v2_demo) at the script's
   own widths (emb 64, hidden 64, batch 64) for 1 pass (of the
   script's 3) and its SGD.test: its cost and AUC lines, and its first
   8 costs within 1e-4 relative of the CPU port's from the same init
   tar.
42. c3d — C3D (Tran et al., ICCV 2015, section 3.3 and Fig. 3; c3d_net)
   at c3d_bs30: eight 3x3x3 convs (64, 128, 256, 256, 512, 512, 512,
   512), five max pools (pool1 1x2x2), fc6 and fc7 of 4096 with ReLU,
   a 487-way softmax; 80.0 M parameters; built with the port's DSL
   (img_conv3d, img_pool3d with explicit input_depth / height / width)
   on a flat channel-major 3 x 16 x 112 x 112 clip and trained through
   SGD with Momentum(0.9, lr 0.003) on 30 seeded clips fed on the card,
   in bf16 and float32 (TF32 off), cuDNN's autotuner on for bf16 (off
   for float32, where it tries algorithms for minutes): 2 warm-ups and
   8 timed steps each; step_ms, clips/s, model TFLOP/s
   (77.1 GFLOP a clip forward, _model_flops), peak memory, one traced
   step each (idle share, top kernels, the convs' share). Asserts the
   losses finite and falling, the parameters finite, the feed and every
   parameter on the card, and the float32 model's test-mode
   probabilities of 2 clips from the init tar within 1e-5 of the CPU
   port's. Its one departure from the paper: no dropout after fc6 and
   fc7, so the card's values can be held against the CPU port's.
43. slice types — the five goldens of the slice (img_trans_layers,
   conv3d_net, deep_speech_row_conv, mdlstm_ocr, ctc_net) on the card
   from the CPU port's init tar: outputs and gradients at rtol 1e-4 /
   atol 1e-5 of the CPU port's. Each new type at one larger size
   (_slice_type_cases: maxout, spp, pad, crop, rotate, bilinear up and
   down, block_expand on 8 maps of 256 x 28 x 28; deconv3d and pool3d
   on 2 maps of 256 x 4 x 14 x 14; mdlstm at b 16, 32 x 100, h 64;
   row_conv at b 16, T 500, d 2048, context 20; ctc and warp_ctc at b
   32, T 200, 29 classes, U 25-50): outputs and gradients within 1e-4
   of each tensor's max |cpu| of the CPU port's, forward and backward
   timed; mdlstm's anti-diagonal walk (131 dependent steps) against
   its plain cell-by-cell walk (3200) on the card, both timed;
   ops/ctc.ctc_loss against F.ctc_loss on a feasible batch (a
   yardstick the port never calls), both timed. Then the OCR stack
   (ocr_ctc_net: 32 x 100 images, 1x1 conv gates, mdlstm h 32,
   block_expand into columns, fc softmax, ctc over 37 classes) and the
   speech stack (speech_ctc_net: 161 bins, fc 512, row_conv context
   20, fc logits, warp_ctc over 29 classes), each trained 8 steps with
   Adam(1e-3) on a batch of 16: costs finite and falling, the first 2
   within 1e-4 relative of the CPU port's from the card run's init tar.
44. ssd300 — SSD300 (Liu et al., ECCV 2016, section 2.2 and Fig. 2; the
   authors' Caffe ssd_pascal.py; ssd300_net) at ssd300_bs32: the VGG-16
   trunk through conv5_3, pool5 3x3 / 1, fc6 a 3x3 conv of 1024 with
   dilation 6, fc7 1x1, conv6-conv9, cross_channel_norm on conv4_3,
   3x3 loc and conf heads and a priorbox on six maps (38, 19, 10, 5, 3,
   1; 8,732 priors), 21 classes, 26.29 M parameters; trained through
   SGD with Momentum(0.9, lr 1e-3) under multibox_loss (overlap 0.5,
   neg_pos_ratio 3, neg_overlap 0.5) on 32 seeded synthetic 300 x 300
   images with 1-8 class-coloured boxes each (ssd_samples; gt rows fed
   as dense_vector_sequence(6)) on the card, in bf16 and float32 (TF32
   off), cuDNN's autotuner on for bf16 only: 2 warm-ups and 8 timed
   steps each; step_ms, images/s, model TFLOP/s (62.7 GFLOP an image
   forward), peak memory; one traced step each: idle share, top
   kernels, and the span on the device timeline of the multibox loss's
   forward, its matching and its mining beside the busy time
   (profiler ranges put in for that step). Asserts losses finite and falling, parameters
   finite, the feed and every parameter on the card, 8,732 priors, and
   the first float32 loss within 1e-4 relative of the CPU port's from
   the init tar. Then detection_output (nms 0.45, nms_top_k 400,
   keep_top_k 200, confidence 0.01) on 8 images with the trained
   float32 table: the card's rows equal the CPU port's detection_output
   on the card's own heads (labels and order identical, scores and
   boxes within 1e-5; runs of rows whose scores lie within 1e-6 may
   come reordered, counted and printed), the layer timed alone with
   its NMS loop's step count, paddle.infer timed, and its rows with
   the gt rows through the detection_map evaluator. Its departures from
   Caffe are the JAX layer's own: priors clipped to [0, 1], a map's
   step image / map.
45. detection types — the three goldens of the slice (detection_net,
   multibox_net, nce_hsigmoid; nce on one draw made on the CPU and
   passed in) on the card from the CPU port's init tar: outputs and
   gradients at rtol 1e-4 / atol 1e-5 of the CPU port's. nce_loss at b
   1024, d 256, 100,000 classes, 20 negatives, forward and backward on
   the card against the CPU port on one draw (1e-5 of each tensor's
   max), timed beside a full-softmax cross entropy over the same
   classes (a yardstick the port never calls). gradient_printer: the
   activation gradients two printers receive in one SGD step on the
   card within 1e-5 of the CPU port's. dataset.uci_housing's reader
   through fit-a-line (fc(1), square_error_cost, lr 0.1) for one pass
   on the card: the cost of the last 3 batches below the first 3's.

Then logs the whole script's wall time and prints the kernel table as
one JSON line (phases 28-45 add no kernel; the launches of phases
34-39 are on their own log lines; the flash and LSTM kernels at
their bfloat16 times, the training dtype, naming their wgmma sources,
with their errors in bfloat16 too; the flash kernels again at float32,
the default dtype, as flash_attention_*_f32 with phase 24's launches
and their float32 sources; the float32 LSTM forward,
lstm_fwd_bf16x3_sm90.cu, as lstm_fwd_f32 with phase 13's launches,
phase 11's float32 error and phase 15's float32 time; the float32
LSTM backward, lstm_bwd_bf16x3_sm90.cu, as lstm_bwd_f32 with phase
25's launches; the GRU kernel,
gru_fwd_sm90.cu,
at float32, the dtype the tagger decodes in, with the launches of
phases 14 and 30 by route — route_launches: phase 14's on sm90,
phase 30's on the cooperative gru_fwd.cu — and phase 30's time of the
cooperative route beside its bound; the int8 and decode
kernels at float32, the
serving dtype, W 1), the card's name and power limit (nvidia-smi), and
last {"ok": true, "device": {...}}.
"""

import contextlib
import functools
import io
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
FP32_FLOPS_PER_S = 67e12           # H100 SXM, non-tensor float32
# spin ahead of event timing: 0.25 s at the H100's boost clock, ~1 s
# when it runs slower (250.7 and 1002.5 ms both seen on one card)
SPIN_CYCLES = 500_000_000
FULL = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
            d_ff=2048, max_len=544)
SLOTS, PAGE, N_REQ = 8, 16, 16
SPEC_K = 2                         # bench.py decode_speculative: W = 3
F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_ATOL = 2e-2
SLICE_FLOOR = 1e-3                 # of max(1, max|ref|): see _slice_ratio
TIE_RTOL, TIE_ATOL = 1e-4, 1e-5    # the logits tolerance of the tests
BF16_FLOPS_PER_S = 989e12          # H100 SXM, dense bf16 tensor cores
TF32_FLOPS_PER_S = 494.7e12        # H100 SXM, dense TF32 tensor cores
FLASH_SHAPE = (8, 8, 64)           # batch, heads, head dim of the LM
FLASH_KV_LENS = [1024, 1000, 777, 513, 512, 300, 64, 17]
# the train step bench.py:245-286 runs: tied transformer_lm, 8 x 1024
TRAIN = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
             d_ff=2048, max_len=1024, tie_embeddings=True)
TRAIN_ROWS, TRAIN_WARMUP, TRAIN_STEPS = 8, 2, 8
# (name, line of the TPU kernel in ops/pallas_attention.py, the route
# bfloat16 takes — the training path's dtype — and that route's source)
FLASH_KERNELS = [("fwd", 43, "sm90", "flash_fwd_sm90.cu"),
                 ("dq", 225, "sm90", "flash_dq_sm90.cu"),
                 ("dkv", 264, "sm90", "flash_dkv_sm90.cu")]
# the float32 sources (route "tf32x3"): the framework's default compute
# dtype, trained by phase 24
FLASH_F32_SOURCES = {"fwd": "flash_fwd_tf32_sm90.cu",
                     "dq": "flash_dq_tf32_sm90.cu",
                     "dkv": "flash_dkv_tf32_sm90.cu"}
F32_TRAIN_STEPS = 4
# the wgmma kernels, which must build with 0 spill bytes and no C75xx
# warning; the window, GRU and decode kernels must build with 0 spill
# bytes too
SM90_LIBS = ("flash_fwd_sm90", "flash_dq_sm90", "flash_dkv_sm90",
             "lstm_fwd_sm90", "lstm_bwd_sm90", "flash_fwd_tf32_sm90",
             "flash_dq_tf32_sm90", "flash_dkv_tf32_sm90",
             "lstm_fwd_bf16x3_sm90", "lstm_bwd_bf16x3_sm90")
NO_SPILL_LIBS = SM90_LIBS + ("paged_window_attention", "gru_fwd_sm90",
                             "decode_attention")


_T0 = time.perf_counter()


def log(msg):
    """A progress line, stamped with the seconds since the start."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, iters, reps=5):
    """Median device milliseconds per call: ``iters`` calls captured in
    one CUDA graph, the replay timed with CUDA events. Eager
    back-to-back calls would time the host's Python issue rate, not
    the card, at these microsecond sizes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / iters)
    return float(np.median(per))


def host_ms(fn, iters=50):
    """Wall milliseconds per eager call, synchronised at the end — the
    rate at which the host issues the call."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


# ------------------------------------------------------------ phase 1
def phase_build():
    import re
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    secs = time.perf_counter() - t0
    for name, rep in reports.items():
        # ptxas's resource lines, and its warnings about wgmma (C75xx:
        # products it had to serialize)
        lines = [ln.strip() for ln in rep.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "bytes stack" in ln or "wgmma" in ln]
        log(f"build {name}: " + ("; ".join(lines) or "reused"))
        spills = [int(n) for n in
                  re.findall(r"(\d+) bytes spill (?:stores|loads)", rep)]
        if name in NO_SPILL_LIBS and any(spills):
            raise AssertionError(f"{name}: ptxas reports spills: {lines}")
        # C75xx: ptxas serialized or fenced the kernel's products
        if name in SM90_LIBS and re.search(r"\(C75\d\d\)", rep):
            raise AssertionError(f"{name}: ptxas serializes its wgmma "
                                 f"products: {lines}")
    log(f"build seconds: {secs:.3f}")
    _sm90_product_check()
    _lstm_sm90_product_check()
    _lstm_fwd_sm90_product_check()
    for kernel in ("fwd", "bwd"):
        _bf16x3_product_check(kernel)
        _bf16x3_plan_check(kernel)
    _tf32_product_check()
    _tf32_plan_check()
    _decode_plan_check()
    return secs


def _decode_plan_check():
    """ops/paged_decode.py decode_smem_bytes, which decode_plan sizes
    its chunks by, against the decode kernel's own layout
    (pt_decode_smem) at every rep 1..32, dh 8..512, chunk 32..544 and
    both element sizes."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_decode as ops
    fn = _build.load("decode_attention").pt_decode_smem
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    n = 0
    for rep in range(1, 33):
        for dh in range(8, 520, 8):
            for cols in range(32, 577, 32):
                for esize in (4, 2):
                    want = fn(rep, dh, cols, esize)
                    got = ops.decode_smem_bytes(rep, dh, cols, esize)
                    if got != want:
                        raise AssertionError(
                            f"decode_smem_bytes({rep}, {dh}, {cols}, "
                            f"{esize}) = {got}, the kernel's {want}")
                    n += 1
    log(f"decode plan: decode_smem_bytes equals the kernel's layout at "
        f"{n} shapes")


def _sm90_product_check():
    """The building blocks of csrc/sm90_pipeline.cuh on one 64 x 64
    tile of bf16 values: A B^T by wgmma SS (TMA-loaded, both K-major:
    the score product) and A B by wgmma RS (A fragments in registers, B
    MN-major: the P.V product) against float32 torch products of the
    same values; max |err| <= 1e-3 max(1, max|ref|) (exact products,
    float32 sums in another order)."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    fn = _build.load("flash_fwd_sm90").pt_sm90_product_check
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5
    rng = np.random.RandomState(5)
    a, b = (torch.from_numpy(rng.randn(64, 64).astype(np.float32))
            .to("cuda", torch.bfloat16) for _ in range(2))
    c_abt = torch.empty(64, 64, device="cuda")
    c_ab = torch.empty(64, 64, device="cuda")
    err = fn(a.data_ptr(), b.data_ptr(), c_abt.data_ptr(), c_ab.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sm90 product check launch failed: CUDA error "
                           f"{err}")
    torch.cuda.synchronize()
    af, bf = a.float(), b.float()
    for name, got, want in (("A B^T (SS, K-major)", c_abt, af @ bf.T),
                            ("A B (RS, B MN-major)", c_ab, af @ bf)):
        e = (got - want).abs().max().item()
        bound = 1e-3 * max(1.0, want.abs().max().item())
        log(f"sm90 product check {name}: max |err| {e:.3e}")
        if not e <= bound:
            raise AssertionError(
                f"sm90 {name}: max |err| {e} > {bound} (against the "
                f"transpose: {(got - want.T).abs().max().item():.3e})")


def _lstm_sm90_product_check():
    """The LSTM backward's product on its own building blocks
    (csrc/lstm_bwd_sm90.cu): a [64, 200] bf16 tile loaded by TMA through
    the scratch's 3-D map in 64-column chunks (the last one zero-filled
    past column 200) times the transpose of a [16, 200] weight slice laid
    out by load_w_tiles, on wgmma m64n16k16 with both operands K-major,
    against the float32 torch product of the same values; max |err| <=
    1e-3 max(1, max|ref|)."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    fn = _build.load("lstm_bwd_sm90").pt_lstm_sm90_product_check
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    rng = np.random.RandomState(6)
    K = 200
    a = torch.from_numpy(rng.randn(64, K).astype(np.float32)) \
        .to("cuda", torch.bfloat16)
    w = torch.from_numpy(rng.randn(16, K).astype(np.float32)) \
        .to("cuda", torch.bfloat16)
    c = torch.empty(64, 16, device="cuda")
    err = fn(a.data_ptr(), w.data_ptr(), c.data_ptr(), K,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"LSTM sm90 product check launch failed: CUDA "
                           f"error {err}")
    torch.cuda.synchronize()
    want = a.float() @ w.float().T
    e = (c - want).abs().max().item()
    bound = 1e-3 * max(1.0, want.abs().max().item())
    log(f"sm90 product check A W^T (m64n16k16 SS, K {K}): max |err| {e:.3e}")
    if not e <= bound:
        raise AssertionError(f"LSTM sm90 product: max |err| {e} > {bound}")


def _lstm_fwd_sm90_product_check():
    """The LSTM forward's product on its own building blocks
    (csrc/lstm_fwd_sm90.cu): a [64, 120] bf16 tile loaded by TMA through
    the scratch's 3-D map in 64-column chunks (the second zero-filled
    past column 120) times a [120, 64] weight slice laid out by
    load_w_tiles as four gate blocks of 16 columns (the gate-major
    order), on wgmma m64n64k16 with both operands K-major, against the
    float32 torch product of the same values; max |err| <= 1e-3 max(1,
    max|ref|)."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    fn = _build.load("lstm_fwd_sm90").pt_lstm_fwd_sm90_product_check
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    rng = np.random.RandomState(7)
    K = 120
    a = torch.from_numpy(rng.randn(64, K).astype(np.float32)) \
        .to("cuda", torch.bfloat16)
    w = torch.from_numpy(rng.randn(K, 64).astype(np.float32)) \
        .to("cuda", torch.bfloat16)
    c = torch.empty(64, 64, device="cuda")
    err = fn(a.data_ptr(), w.data_ptr(), c.data_ptr(), K,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"LSTM forward sm90 product check launch failed: "
                           f"CUDA error {err}")
    torch.cuda.synchronize()
    want = a.float() @ w.float()
    e = (c - want).abs().max().item()
    bound = 1e-3 * max(1.0, want.abs().max().item())
    log(f"sm90 product check A W (m64n64k16 SS, gate-major W tiles, K {K}): "
        f"max |err| {e:.3e}")
    if not e <= bound:
        raise AssertionError(f"LSTM forward sm90 product: max |err| {e} > "
                             f"{bound}")


def _bf16x3_product_check(kernel):
    """A float32 LSTM kernel's product on its own building blocks
    (csrc/lstm_{fwd,bwd}_bf16x3_sm90.cu): a float32 [64, 200] A split
    into bf16 halves by the kernel's writer into the fragment-order
    planes (h for the forward, one gate of dz for the backward), 40
    float32 weight columns split into the resident halves — the
    forward's W [200, 40] (4 gates x 10 units, gate-strided columns),
    the backward's 40 rows of W, [40, 200] (W-row tiles, k contiguous) —
    the three passes on wgmma m64n40k16 RS over the k-steps (the last
    tile zero past k 200) as the kernel runs them, against the float64
    torch product of the same values (A W, or A W^T): max |err| <= 1e-5
    max(1, max|ref|), which the kernel's one-pass product A1 W1
    (returned beside) must fail."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_rnn as fr
    lib = f"lstm_{kernel}_bf16x3_sm90"
    fn = getattr(_build.load(lib), f"pt_lstm_{kernel}_bf16x3_product_check")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    rng = np.random.RandomState(8 if kernel == "fwd" else 10)
    K = 200
    a = torch.from_numpy(rng.randn(64, K).astype(np.float32)).cuda()
    shape = (K, 40) if kernel == "fwd" else (40, K)
    w = torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
    c3 = torch.empty(64, 40, device="cuda")
    c1 = torch.empty(64, 40, device="cuda")
    plan = getattr(fr, f"lstm_{kernel}_bf16x3_plan")(K, _sms())
    hs = torch.zeros(2 * plan.k_steps * 512, dtype=torch.int32,
                     device="cuda")
    err = fn(a.data_ptr(), w.data_ptr(), c3.data_ptr(), c1.data_ptr(),
             hs.data_ptr(), K, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bf16x3 {kernel} product check launch failed: "
                           f"CUDA error {err}")
    torch.cuda.synchronize()
    wd = w.double() if kernel == "fwd" else w.double().T
    want = a.double() @ wd
    bound = 1e-5 * max(1.0, want.abs().max().item())
    e3, e1 = ((c.double() - want).abs().max().item() for c in (c3, c1))
    what = "A W (m64n40k16 RS" if kernel == "fwd" else \
        "A W^T (m64n40k16 RS over W-row tiles"
    log(f"bf16x3 {kernel} product check {what}, K {K}): three passes max "
        f"|err| {e3:.3e}, one pass {e1:.3e} (limit {bound:.3e})")
    if not e3 <= bound:
        raise AssertionError(f"bf16x3 {kernel} product: max |err| {e3} > "
                             f"{bound}")
    if not e1 > bound:
        raise AssertionError(f"the bf16x3 {kernel} product bound passes one "
                             f"bf16 pass: {e1} <= {bound}")


def _bf16x3_plan_check(kernel):
    """ops/fused_rnn.py lstm_{fwd,bwd}_bf16x3_plan against the kernel's
    own (pt_lstm_{fwd,bwd}_bf16x3_plan: units, blocks, dynamic shared
    bytes, ring depth, k-steps) at every h 1..1400 on this card's SMs and
    both ring depths: the same plan where either fits, neither where one
    does not, and the dynamic plus the kernel's static shared bytes
    within the opt-in."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_rnn as fr
    fn = getattr(_build.load(f"lstm_{kernel}_bf16x3_sm90"),
                 f"pt_lstm_{kernel}_bf16x3_plan")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    plan = getattr(fr, f"lstm_{kernel}_bf16x3_plan")
    sms, fits, static = _sms(), 0, 0
    for h in range(1, 1401):
        for stages in (0, 4):
            buf = (ctypes.c_int * 6)()
            err = fn(h, sms, stages, buf)
            want = plan(h, sms, stages)
            got = tuple(buf[:5]) if err == 0 else None
            if got != (None if want is None else tuple(want)):
                raise AssertionError(f"lstm_{kernel}_bf16x3_plan({h}, {sms}, "
                                     f"{stages}) = {want}, the kernel's "
                                     f"{got} (error {err})")
            if got is not None:
                fits, static = max(fits, h), buf[5]
                if buf[2] + buf[5] > fr._SM90_SMEM:
                    raise AssertionError(f"bf16x3 {kernel} plan at h {h}: "
                                         f"{buf[2]} + {buf[5]} bytes past "
                                         "the opt-in")
    log(f"bf16x3 {kernel} plan == kernel layout at h 1..1400 on {sms} SMs: "
        f"fits up to h {fits}; at h 1280 {plan(1280, sms)}, static {static} "
        "bytes")


def _tf32_product_check():
    """The 3xTF32 building blocks of csrc/sm90_tf32.cuh (through
    csrc/flash_dq_tf32_sm90.cu): float32 A [64, 64] and B [32, 64]
    loaded by TMA (128-byte swizzle, 32 columns a panel) and split into
    hi and lo; C = A B^T by three TF32 wgmma SS products a k-step (both
    K-major), then E = C B by three RS products, C split in registers
    from its accumulator and B^T written transposed with its rows in
    the register fragment's k order. Each against float64 torch
    products of the same values (E against the kernel's own C): max
    |err| <= 1e-5 max(1, max|ref|), which one TF32 product a k-step
    (~1e-3 relative) fails."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    fn = _build.load("flash_dq_tf32_sm90").pt_tf32_product_check
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5
    rng = np.random.RandomState(9)
    a = torch.from_numpy(rng.randn(64, 64).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.randn(32, 64).astype(np.float32)).cuda()
    c = torch.empty(64, 32, device="cuda")
    e = torch.empty(64, 64, device="cuda")
    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), e.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tf32 product check launch failed: CUDA error "
                           f"{err}")
    torch.cuda.synchronize()
    ad, bd = a.double(), b.double()
    for name, got, want in (("C = A B^T (SS, K-major)", c, ad @ bd.T),
                            ("E = C B (RS, B^T in k order)", e,
                             c.double() @ bd)):
        err = (got.double() - want).abs().max().item()
        bound = 1e-5 * max(1.0, want.abs().max().item())
        log(f"tf32x3 product check {name}: max |err| {err:.3e} (limit "
            f"{bound:.3e})")
        if not err <= bound:
            raise AssertionError(f"tf32x3 {name}: max |err| {err} > {bound}")


def _tf32_plan_check():
    """ops/flash_attention.py flash_tf32_plan against the kernels' own
    Plan (pt_flash_{fwd,dq,dkv}_tf32_plan: warpgroups, rows, tile,
    stages, dynamic and static shared bytes) at every head dim the shape
    gate admits, each within the 227 KB opt-in."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    keys = ("warpgroups", "rows", "tile", "stages", "smem", "static")
    for kernel in ("fwd", "dq", "dkv"):
        fn = getattr(_build.load(f"flash_{kernel}_tf32_sm90"),
                     f"pt_flash_{kernel}_tf32_plan")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        seen = set()
        for d in range(8, 129, 8):
            buf = (ctypes.c_int * len(keys))()
            err = fn(d, buf)
            if err != 0:
                raise RuntimeError(f"pt_flash_{kernel}_tf32_plan({d}): CUDA "
                                   f"error {err}")
            got = dict(zip(keys, buf))
            want = fa.flash_tf32_plan(kernel, d)
            if got != want:
                raise AssertionError(f"flash_tf32_plan({kernel!r}, {d}) = "
                                     f"{want}, the kernel's plan {got}")
            if got["smem"] + got["static"] > fa.SMEM_LIMIT:
                raise AssertionError(f"{kernel} d {d}: {got} exceeds "
                                     f"{fa.SMEM_LIMIT} bytes")
            seen.add(tuple(got.values()))
        log(f"tf32x3 {kernel} plan == kernel layout at d 8..128: " +
            "; ".join(f"wg {p[0]} rows {p[1]} tile {p[2]} stages {p[3]} "
                      f"smem {p[4]}+{p[5]}" for p in sorted(seen)))


# ------------------------------------------------------------ phase 2
def _window_case(h, g, W, dtype, seed):
    """Full-width paged-attention inputs: out-of-order pages, ragged
    lengths up to 544, one idle slot on the null page."""
    rng = np.random.RandomState(seed)
    dh, P = 64, FULL["max_len"] // PAGE
    n_pages = SLOTS * P + 1
    dev = torch.device("cuda")
    k = torch.from_numpy(rng.randn(n_pages, PAGE, g, dh).astype(np.float32))
    v = torch.from_numpy(rng.randn(n_pages, PAGE, g, dh).astype(np.float32))
    q = torch.from_numpy(rng.randn(SLOTS, W, h, dh).astype(np.float32))
    tables = np.zeros((SLOTS, P), np.int32)
    tables[1:] = (rng.permutation(n_pages - 1)[:(SLOTS - 1) * P] + 1) \
        .reshape(SLOTS - 1, P)
    base = np.array([1, 17, 100, 255, 256, 300, 513, 544 - W + 1])
    lens = np.minimum(base[:, None] + np.arange(W)[None, :],
                      FULL["max_len"]).astype(np.int32)
    args = [q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(lens).to(dev)]
    return args, tables, lens


def phase_kernel_vs_plain():
    from paddle_tpu_torch.ops import paged_decode as ops
    worst = 0.0
    for (h, g) in ((8, 8), (8, 2), (8, 1)):
        for W in (1, 4):
            for dtype in (torch.float32, torch.bfloat16):
                args, tables, lens = _window_case(h, g, W, dtype,
                                                  seed=h * 10 + g + W)
                got = ops.paged_window_attention(*args)
                torch.cuda.synchronize()
                # the plain version on the same values, in float32
                f32 = [a.float() if a.is_floating_point() else a
                       for a in args]
                want = ops.paged_window_reference(*f32)
                err = (got.float() - want).abs().max().item()
                if dtype == torch.float32:
                    torch.testing.assert_close(got, want, **F32_TOL)
                    worst = max(worst, err)
                elif err > BF16_ATOL:
                    raise AssertionError(
                        f"bf16 kernel off by {err} > {BF16_ATOL}")
                zero_err = _check_zero_len_row(ops, args, tables, lens,
                                               dtype)
                # allocated-pages contract: pages past each slot's used
                # count are never read — poison them, nothing changes
                P = tables.shape[1]
                used = np.clip(-(-lens.max(axis=1) // PAGE), 1, P)
                tail = np.concatenate([tables[s, used[s]:]
                                       for s in range(SLOTS)])
                tail = torch.from_numpy(tail[tail > 0].astype(np.int64))
                args[1][tail.cuda()] = float("nan")
                args[2][tail.cuda()] = float("nan")
                again = ops.paged_window_attention(*args)
                torch.cuda.synchronize()
                if not torch.equal(again, got):
                    raise AssertionError("kernel read a page past a "
                                         "slot's used count")
                _check_corrupt_entry(
                    lambda tb: ops.paged_window_attention(
                        args[0], args[1], args[2], tb, args[4]),
                    args[3], lens, got)
                log(f"kernel vs plain h={h} g={g} W={W} "
                    f"{str(dtype)[6:]}: max_abs_err {err:.3e}, kv_len-0 "
                    f"row {zero_err:.3e}")
    return worst


def _check_counters_zero(kernel):
    """Every arrival counter of the merge (shared by the window and
    decode kernels) reads 0 again after a synchronized call."""
    from paddle_tpu_torch.ops import paged_decode as ops
    for counters in ops.arrival_counters():
        if counters.any():
            raise AssertionError(f"{kernel} kernel arrival counters not "
                                 "back to 0 after a call")


def _check_corrupt_entry(call, tb, lens, clean):
    """Out-of-range table entries inside a slot's used pages are never
    dereferenced: slot 1's first entry (-1; its used pages fit one
    chunk) and slot 5's last used one (2^30; the last of several
    chunks, so the merge carries it) make those slots' rows NaN, and
    every other row equals the clean call's. After the synchronized
    call every arrival counter of the merge reads 0 again."""
    bad = tb.clone()
    used5 = min(max(-(-int(lens[5].max()) // PAGE), 1), tb.shape[1])
    bad[1, 0] = -1
    bad[5, used5 - 1] = 1 << 30
    got = call(bad)
    torch.cuda.synchronize()
    keep = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    keep[[1, 5]] = False
    if not torch.isnan(got[~keep]).all():
        raise AssertionError("a corrupt table entry did not make its "
                             "slot's rows NaN")
    if not torch.equal(got[keep], clean[keep]):
        raise AssertionError("a corrupt table entry changed another "
                             "slot's rows")
    _check_counters_zero("window")


def _check_zero_len_row(ops, args, tables, lens, dtype):
    """Window token 0 of slot 2 with kv_len 0 must return what the TPU
    kernel returns for it: the mean of V over every column of the
    slot's used pages (pallas_decode.py:297-314 does not zero masked
    weights). The other rows keep the plain version's values."""
    s = 2
    lens0 = lens.copy()
    lens0[s, 0] = 0
    ln = torch.from_numpy(lens0).to(args[4].device)
    got = ops.paged_window_attention(*args[:4], ln)
    torch.cuda.synchronize()
    q, v_pages = args[0], args[2]
    h, g = q.shape[2], v_pages.shape[2]
    used = min(max(-(-int(lens0[s].max()) // PAGE), 1), tables.shape[1])
    pages = torch.from_numpy(tables[s, :used].astype(np.int64)).cuda()
    mean_v = v_pages[pages].float().reshape(-1, g, q.shape[3]).mean(dim=0)
    want = mean_v.repeat_interleave(h // g, dim=0)         # [h, dh]
    err = (got[s, 0].float() - want).abs().max().item()
    if err > (F32_TOL["atol"] if dtype == torch.float32 else BF16_ATOL):
        raise AssertionError(f"kv_len-0 row off the mean of V by {err}")
    keep = torch.ones(got.shape[:2], dtype=torch.bool, device=got.device)
    keep[s, 0] = False
    want_rest = ops.paged_window_reference(
        *[a.float() if a.is_floating_point() else a for a in args[:4]], ln)
    if dtype == torch.float32:
        torch.testing.assert_close(got[keep], want_rest[keep], **F32_TOL)
    elif (got[keep].float() - want_rest[keep]).abs().max() > BF16_ATOL:
        raise AssertionError("a kv_len-0 row changed the other rows")
    return err


# ------------------------------------------------------------ phase 3
def serving_requests():
    """The 16 seeded requests of the serving mix: (prompts, new token
    counts)."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, FULL["vocab_size"],
                           (int(rng.randint(16, 97)),)).astype(np.int32)
               for _ in range(N_REQ)]
    news = [int(rng.randint(16, 65)) for _ in range(N_REQ)]
    return prompts, news


def engine_lengths():
    """The kv lengths of the serving mix's first 8 requests at their
    last token: the lengths the engine's slots reach."""
    prompts, news = serving_requests()
    return [len(p) + n for p, n in zip(prompts[:SLOTS], news[:SLOTS])]


def phase_engine():
    from paddle_tpu_torch.models.decode import TransformerDecoder
    from paddle_tpu_torch.ops import paged_decode as ops
    from paddle_tpu_torch.params import init_transformer_lm_params
    from paddle_tpu_torch.serving import DecodeEngine

    dec = TransformerDecoder(init_transformer_lm_params(FULL, seed=0),
                             n_layers=FULL["n_layers"],
                             n_heads=FULL["n_heads"])
    eng = DecodeEngine(dec, num_slots=SLOTS, page_size=PAGE,
                       max_seq_len=FULL["max_len"])
    assert eng.pool.num_pages == SLOTS * (FULL["max_len"] // PAGE) + 1
    eng.warmup()
    prompts, news = serving_requests()
    torch.cuda.synchronize()
    ops.paged_window_attention.launches = 0
    reqs, wall = _serve(eng, prompts, news)
    launches = ops.paged_window_attention.launches
    st = eng.stats()
    for i, r in enumerate(reqs):
        if not all(0 <= t < FULL["vocab_size"] for t in r.get(timeout=1)):
            raise AssertionError(f"request {i}: token out of range")
    if launches != st["steps"] * FULL["n_layers"] or launches == 0:
        raise AssertionError(f"kernel launches {launches} != steps "
                             f"{st['steps']} x {FULL['n_layers']}")
    dense = []
    for i in range(4):
        p = prompts[i]
        want = dec.generate(p[None, :], max_len=len(p) + news[i])[0]
        ref = dec.prefill_logits(np.concatenate([p, want])[None, :])[0]
        dense.append((want, ref[len(p) - 1:]))
    _check_dense(reqs, dense, "engine")
    gen = st["tokens_out"]
    log(f"engine: {N_REQ} requests, {gen} tokens, {st['steps']} steps, "
        f"{wall:.3f} s, {gen / wall:.1f} tokens/s, p50 inter-token "
        f"{st['token_latency_p50_ms']} ms, p99 "
        f"{st['token_latency_p99_ms']} ms, kernel launches {launches}, "
        f"prefix hit pages {st['prefix_hit_pages']}")
    return dict(eng=eng, dec=dec, prompts=prompts, news=news,
                launches=launches, tokens=[r.get(timeout=1) for r in reqs],
                dense=dense, tokens_per_s=gen / wall,
                pool_bytes=eng.paged.pool_bytes())


def _check_dense(reqs, dense, label):
    """The first requests' tokens against the dense decoder's greedy
    rows under the tie rule (``dense``: (tokens, logits) pairs)."""
    from paddle_tpu_torch.models.decode import tokens_agree
    for i, (want, ref) in enumerate(dense):
        tol = TIE_ATOL + TIE_RTOL * float(np.abs(ref).max())
        if not tokens_agree(reqs[i].get(timeout=1), want, ref, tol):
            raise AssertionError(f"{label} request {i}: tokens differ "
                                 "from the dense reference")


# ------------------------------------------------------------ phase 4
def _window_lens(lens, W):
    """Per-token kv_lens [S, W] of a W-token window ending at ``lens``
    (window token w sees lens - W + 1 + w columns, at least 1)."""
    return torch.from_numpy(np.maximum(
        np.asarray(lens)[:, None] - W + 1 + np.arange(W)[None, :], 1)
        .astype(np.int32)).cuda()


def _window_timing(label, q, layers, tb, ln):
    """One window kernel's device time per call (CUDA-graph replay,
    cycling over ``layers``, each (k_pages, v_pages, k_scales,
    v_scales) with the scales None for float pages), the host's eager
    issue time, its bound on this call's inputs, the plain version's
    time and SDPA on the gathered (dequantized) view as a yardstick."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import paged_decode as ops
    k0 = layers[0][0]
    _, ps, g, dh = k0.shape
    h = q.shape[2]
    quant = layers[0][2] is not None

    def call(fn, i):
        k, v, ks, vs = layers[i % len(layers)]
        return fn(q, k, v, tb, ln, k_scales=ks, v_scales=vs)

    ms = device_ms(lambda i: call(ops.paged_window_attention, i), iters=60)
    plain_ms = device_ms(lambda i: call(ops.paged_window_reference, i),
                         iters=12)
    issue_ms = host_ms(lambda i: call(ops.paged_window_attention, i))
    # the kernel's floors: stopped after the prologue, the gather, the
    # chunk's own outputs (no merge)
    floors = [device_ms(lambda i: call(functools.partial(
        ops.paged_window_launch, mode=m), i), iters=60) for m in (1, 2, 3)]

    def view(pages, scales):
        x = ops.gather_pages(pages, tb)
        if scales is not None:
            x = ops.dequantize_kv(x, ops.gather_scales(scales, tb), q.dtype)
        return x.to(q.dtype).permute(0, 2, 1, 3)

    kg = [view(k, ks) for k, _, ks, _ in layers]
    vg = [view(v, vs) for _, v, _, vs in layers]
    T = tb.shape[1] * ps
    mask = (torch.arange(T, device="cuda")[None, None, :]
            < ln[:, :, None])[:, None]            # [S, 1, W, T]
    qs = q.permute(0, 2, 1, 3)
    gqa = {} if g == h else {"enable_gqa": True}

    def sdpa(i):
        return F.scaled_dot_product_attention(
            qs, kg[i % len(layers)], vg[i % len(layers)], attn_mask=mask,
            **gqa)

    got = sdpa(0).permute(0, 2, 1, 3)
    want = call(ops.paged_window_reference, 0)
    if q.dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32_TOL)
    elif (got.float() - want.float()).abs().max().item() > BF16_ATOL:
        raise AssertionError(f"{label}: bf16 SDPA yardstick off the plain "
                             "path")
    library_ms = device_ms(sdpa, iters=60)
    lens_max = ln.max(dim=1).values.cpu().numpy()
    used = np.clip(-(-lens_max // ps), 1, tb.shape[1])
    row_bytes = dh * k0.element_size() + (4 if quant else 0)
    kv_bytes = 2 * int(used.sum()) * ps * g * row_bytes
    io_bytes = 2 * q.numel() * q.element_size() + tb.numel() * 4 + \
        ln.numel() * 4
    flops = 4.0 * float(ln.sum().item()) * h * dh
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOPS_PER_S if q.dtype == torch.bfloat16
                     else FP32_FLOPS_PER_S) * 1e3
    bound_ms = max(t_bytes, t_ops)
    plan = ops.window_plan(q.shape[0], q.shape[1], h, g, dh, ps,
                           tb.shape[1], k0.element_size(), quant)
    log(f"{label} (lens {lens_max.tolist()}, {len(layers)} pool sets; "
        f"chunks of C {plan.chunk_pages:g} pages, {plan.n_chunks} a "
        f"slot): {ms * 1e3:.2f} us/call on the device ({issue_ms * 1e3:.2f} "
        f"us/call issued eagerly), bound {bound_ms * 1e3:.3f} us "
        f"({kv_bytes + io_bytes} bytes), plain {plain_ms * 1e3:.2f} us, "
        f"sdpa {library_ms * 1e3:.2f} us; floors: prologue "
        f"{floors[0] * 1e3:.2f}, + gather {floors[1] * 1e3:.2f}, + chunk "
        f"outputs {floors[2] * 1e3:.2f} us")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_timings(eng, prompts, news):
    """The float kernel at the engine's shapes: the first 8 requests at
    their final lengths over the engine's real pools, one token each
    (W 1) and the speculation window (W 3). Returns W 1's numbers."""
    k_pool, v_pool = eng.k_pool, eng.v_pool
    L, _, _, _, dh = k_pool.shape
    lens = np.array([len(p) + n for p, n in
                     zip(prompts[:SLOTS], news[:SLOTS])], np.int32)
    tb, _ = _engine_page_view(eng, lens, seed=1)
    layers = [(k_pool[i], v_pool[i], None, None) for i in range(L)]
    out = {}
    for W in (1, SPEC_K + 1):
        q = torch.randn(SLOTS, W, FULL["n_heads"], dh, device="cuda")
        out[W] = _window_timing(f"kernel at engine shapes W={W} float32",
                                q, layers, tb, _window_lens(lens, W))
    return out[1]


# ------------------------------------------------------------ phase 5
def phase_trace(eng):
    """Where an engine step's time goes: 8 fresh requests served under
    torch.profiler; device busy time by kernel against the wall clock
    (the profiler slows the host, so the idle share is an upper
    bound)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(7)
    steps0 = eng.stats()["steps"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reqs = [eng.submit(rng.randint(0, FULL["vocab_size"], (32,)), 16)
                for _ in range(SLOTS)]
        eng.run(timeout=600)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for r in reqs:
        r.get(timeout=1)
    steps = eng.stats()["steps"] - steps0
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA" and ev.self_device_time_total > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + \
                ev.self_device_time_total / 1e3
    busy_ms = sum(by_kernel.values())
    paged_ms = sum(v for k, v in by_kernel.items() if "paged_window" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    log(f"trace: {steps} steps, wall {wall_ms:.3f} ms "
        f"({wall_ms / steps:.3f} ms/step), device busy {busy_ms:.3f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f}), paged window kernel "
        f"{paged_ms:.3f} ms ({paged_ms / steps * 1e3:.2f} us/step)")
    for name, ms in top:
        log(f"trace top kernel: {ms:.3f} ms  {name[:90]}")


# ------------------------------------------------------------ phase 6
def _flash_inputs(T, dtype, seed, d=FLASH_SHAPE[2]):
    rng = np.random.RandomState(seed)
    b, h, _ = FLASH_SHAPE
    return [torch.from_numpy(rng.randn(b, T, h, d).astype(np.float32))
            .to("cuda", dtype) for _ in range(4)]            # q, k, v, dO


def _flash_kernels(q, k, v, do, lens2, causal):
    """Forward, D = rowsum(dO*O), dq and dk/dv through the three kernel
    wrappers, as the autograd Function runs them."""
    from paddle_tpu_torch.ops import flash_attention as fa
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_forward(q, k, v, lens2, causal, scale)
    dd = fa.rowsum_do_o(do, out)
    dq = fa.flash_backward_dq(q, k, v, do, lse, dd, lens2, causal, scale)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, dd, lens2, causal,
                                   scale)
    return out, lse, dd, dq, dk, dv


def _held(name, got, want, dtype):
    """float32: assert_close(rtol 2e-4, atol 2e-5 * max(1, max|ref|));
    bfloat16: max |err| <= 2e-2 * max(1, max|ref|). Returns max |err|."""
    got, want = got.float(), want.float()
    bound = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=F32_TOL["rtol"],
                                   atol=F32_TOL["atol"] * bound,
                                   msg=lambda m: f"{name}: {m}")
    elif err > BF16_ATOL * bound:
        raise AssertionError(f"bf16 {name} off by {err} > "
                             f"{BF16_ATOL} x {bound}")
    return err


def _held_lse(got, want):
    """lse on the live rows: _held's float32 bound, and max |err| <= 2e-5
    x max(1, max|ref|) with no relative term: an error e in lse scales
    every p of its row by exp(e) however large lse is (at lse ~7 the
    rtol term alone passes e = 1.4e-3). Returns max |err|."""
    err = _held("lse", got, want, torch.float32)
    bound = F32_TOL["atol"] * max(1.0, want.abs().max().item())
    if err > bound:
        raise AssertionError(f"lse off by {err} > {bound}")
    return err


def _slice_ratio(got, want):
    """(worst ratio, (batch row, head)) over the (batch row, head) slices
    of [b, T, h, d] tensors: max |err| of the slice over max |ref| of
    the slice, the latter floored at SLICE_FLOOR x max(1, max|ref|) of
    the whole tensor. The floor is for slices that are exactly 0 by
    cancellation (dk and dq of a kv_len-1 row: P = 1 and dP = D), where
    both sides hold only float32 summation noise."""
    g = got.detach().float().permute(0, 2, 1, 3).flatten(2)
    w = want.detach().float().permute(0, 2, 1, 3).flatten(2)
    floor = SLICE_FLOOR * max(1.0, w.abs().max().item())
    ratio = (g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(floor)
    at = int(ratio.argmax())
    return ratio.max().item(), divmod(at, ratio.shape[1])


def _planted(name, got, ref):
    """The two planted faults of dq ("query") or dv ("key") that phase
    6 must reject: the tensor zeroed past its first 64 rows, and x 0.95
    in every (batch row, head) slice but the one that holds its max
    |ref|. [(label, faulty tensor)]."""
    rows = "query" if name == "dq" else "key"
    got, ref = got.float(), ref.detach().float()
    past_tile = got.clone()
    past_tile[:, 64:] = 0
    top = ref.abs().amax((1, 3)).flatten().argmax()  # (row, head) index
    scaled = got * 0.95
    b_top, h_top = divmod(int(top), got.shape[2])
    scaled[b_top, :, h_top] = got[b_top, :, h_top]
    return [(f"{name} zeroed past {rows} 64", past_tile),
            (f"{name} x 0.95 outside its top slice", scaled)]


def _held_faults_f32(label, grads, refs):
    """float32: the planted faults of dq and dv (_planted) must fail the
    float32 bound of _held, as the bf16 ones fail the slice check."""
    for name in ("dq", "dv"):
        for fault, bad in _planted(name, grads[name], refs[name]):
            try:
                _held(name, bad, refs[name], torch.float32)
            except AssertionError:
                log(f"{label} f32 planted fault, {fault}: rejected")
                continue
            raise AssertionError(f"{label}: the float32 check passes a "
                                 f"planted fault ({fault})")


def _held_faults_fwd(label, out, ref, lse, lse_ref, live):
    """float32: two planted faults of the forward must fail phase 6's
    float32 checks: out x 0.95 in the (batch row, head) slice that holds
    its max |ref|, and lse + 1e-3 on the rows past query 64."""
    top = int(ref.detach().abs().amax((1, 3)).argmax())
    b_top, h_top = divmod(top, out.shape[2])
    scaled = out.clone()
    scaled[b_top, :, h_top] *= 0.95
    shifted = lse.clone()
    shifted[:, 64:] += 1e-3
    for fault, check in (
            ("out x 0.95 in its top slice",
             lambda: _held("out", scaled, ref, torch.float32)),
            ("lse + 1e-3 past query 64",
             lambda: _held_lse(shifted[live], lse_ref[live]))):
        try:
            check()
        except AssertionError:
            log(f"{label} f32 planted fault, {fault}: rejected")
            continue
        raise AssertionError(f"{label}: the float32 check passes a "
                             f"planted fault ({fault})")


def _held_slices(label, grads, refs):
    """bfloat16: each of out, dq, dk, dv held per (batch row, head)
    slice, max |err| <= 2e-2 x max |ref| of the slice (see
    _slice_ratio): the whole-tensor bound alone is set by the largest
    slice (a kv_len-1 row's dv sums ~500 dO rows), so it cannot see an
    error in the others. Then two planted faults each of dq and dv
    (_planted), which the slice check must reject. Returns {name: worst
    ratio}."""
    ratios = {}
    for name in ("out", "dq", "dk", "dv"):
        ratios[name], at = _slice_ratio(grads[name], refs[name])
        if ratios[name] > BF16_ATOL:
            raise AssertionError(
                f"{label} bf16 {name}: slice (row, head) {at} off by "
                f"{ratios[name]:.3e} of its max|ref| > {BF16_ATOL}")
    for name in ("dq", "dv"):
        ref = refs[name].detach().float()
        whole = BF16_ATOL * max(1.0, ref.abs().max().item())
        for fault, bad in _planted(name, grads[name], ref):
            r, _ = _slice_ratio(bad, ref)
            old = (bad - ref).abs().max().item()
            log(f"{label} planted fault, {fault}: slice ratio {r:.3e} "
                f"(limit {BF16_ATOL}); whole-tensor max|err| {old:.3e} "
                f"(limit {whole:.3e}, "
                f"{'rejects' if old > whole else 'passes'} it)")
            if not r > BF16_ATOL:
                raise AssertionError(f"{label}: the slice check passes a "
                                     f"planted fault ({fault}): ratio {r}")
    return ratios


def phase_flash_vs_plain():
    """The three flash kernels against autograd of the plain version in
    float32 on the same (rounded) values, at full width: causal T 1024
    with ragged kv_lens, and non-causal T 1000 (not a block multiple)
    with q_lens below T, fully-masked batch rows included, at head dim
    64, then the causal case at head dim 128 (bf16: two d panels, two
    dk/dv warpgroups, two dQ accumulators; f32: the one-stage plans and
    16-query dk/dv tiles) and the non-causal one at head dim 72 (the
    zero-filled d tail), each in float32 (the tf32x3 forward, dq and
    dk/dv) and bfloat16 (the sm90 route: the wgmma forward, dq and
    dk/dv). Planted faults of dq and dv must fail each dtype's check,
    and planted faults of out and lse the float32 one. Returns the
    worst max |err| by (kernel, dtype)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    f32, bf16 = torch.float32, torch.bfloat16
    causal_lens = ([1024] * 8, FLASH_KV_LENS)
    ragged_lens = ([1000, 999, 640, 513, 100, 1, 0, 64],
                   [1000, 1000, 777, 1, 512, 300, 64, 0])
    cases = [("causal T1024", 1024, True, causal_lens, 64, (f32, bf16)),
             ("non-causal T1000", 1000, False, ragged_lens, 64, (f32, bf16)),
             ("causal T1024 d128", 1024, True, causal_lens, 128,
              (f32, bf16)),
             ("non-causal T1000 d72", 1000, False, ragged_lens, 72,
              (f32, bf16))]
    worst = {(n, dt): 0.0 for n in ("fwd", "dq", "dkv") for dt in (f32, bf16)}
    for ci, (label, T, causal, (q_lens, kv_lens), d, dtypes) in \
            enumerate(cases):
        for dtype in dtypes:
            q, k, v, do = _flash_inputs(T, dtype, seed=60 + ci, d=d)
            lens2 = torch.tensor(np.stack([q_lens, kv_lens], 1),
                                 dtype=torch.int32, device="cuda")
            out, lse, _, dq, dk, dv = _flash_kernels(q, k, v, do, lens2,
                                                     causal)
            torch.cuda.synchronize()
            qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
            ql, kl = lens2[:, 0], lens2[:, 1]
            scale = q.shape[-1] ** -0.5
            ref = fa.flash_attention_reference(qf, kf, vf, ql, kl, causal,
                                               scale)
            gq, gk, gv = torch.autograd.grad(ref, (qf, kf, vf), do.float())
            lse_ref = fa.flash_lse_reference(qf.detach(), kf.detach(), ql,
                                             kl, causal, scale)
            live = lse_ref > fa.NEG_INF / 2
            if not torch.all(lse[~live] == fa.NEG_INF):
                raise AssertionError(f"{label}: lse of a fully-masked row "
                                     "is not NEG_INF")
            rows = out.permute(0, 2, 1, 3).reshape(-1, T, d)
            if not torch.all(rows[~live.reshape(-1, T)] == 0):
                raise AssertionError(f"{label}: out of a fully-masked row "
                                     "is not 0")
            errs = {"out": _held("out", out, ref, dtype),
                    "lse": _held_lse(lse[live], lse_ref[live]),
                    "dq": _held("dq", dq, gq, dtype),
                    "dk": _held("dk", dk, gk, dtype),
                    "dv": _held("dv", dv, gv, dtype)}
            grads = {"out": out, "dq": dq, "dk": dk, "dv": dv}
            refs = {"out": ref, "dq": gq, "dk": gk, "dv": gv}
            if dtype == f32:
                _held_faults_f32(label, grads, refs)
                _held_faults_fwd(label, out, ref, lse, lse_ref, live)
                slices = ""
            else:
                slices = "; per-slice ratios " + ", ".join(
                    f"{n} {r:.3e}"
                    for n, r in _held_slices(label, grads, refs).items())
            for name, keys in (("fwd", ("out", "lse")), ("dq", ("dq",)),
                               ("dkv", ("dk", "dv"))):
                worst[(name, dtype)] = max(worst[(name, dtype)],
                                           *(errs[x] for x in keys))
            routes = "/".join(fa.flash_route(n, dtype)
                              for n in ("fwd", "dq", "dkv"))
            log(f"flash vs plain {label} {str(dtype)[6:]} (fwd/dq/dkv "
                f"routes {routes}): " + ", ".join(
                    f"{n} {e:.3e}" for n, e in errs.items()) + slices)
            del ref, gq, gk, gv
    return worst


# ------------------------------------------------------------ phase 7
def _lm_spec(compute_dtype, **cfg):
    """transformer_lm at ``cfg`` (phase 7's TRAIN by default)."""
    from paddle_tpu_torch import config
    from paddle_tpu_torch.core.registry import reset_name_counters
    from paddle_tpu_torch.models import transformer_lm
    config.init(seed=0, compute_dtype=compute_dtype)
    reset_name_counters()
    return transformer_lm(**(cfg or TRAIN))


def _lm_batch(seed=0):
    """TRAIN_ROWS full-length rows of seeded tokens: (tokens, positions,
    next tokens)."""
    rng = np.random.RandomState(seed)
    T = TRAIN["max_len"]
    toks = rng.randint(0, TRAIN["vocab_size"], (TRAIN_ROWS, T + 1)) \
        .astype(np.int32)
    return [(toks[i, :-1], np.arange(T, dtype=np.int32), toks[i, 1:])
            for i in range(TRAIN_ROWS)]


def _flash_counts(fa, zero=False):
    """{kernel: {route: launches}} of the three flash wrappers."""
    if zero:
        fa.reset_launches()
    return {name: dict(fn.route_launches) for name, fn in (
        ("fwd", fa.flash_forward), ("dq", fa.flash_backward_dq),
        ("dkv", fa.flash_backward_dkv))}


def phase_train(compute_dtype="bfloat16", steps=TRAIN_STEPS):
    """The main training path: SGD.train_batch with Adam(1e-4) on the
    full-width tied transformer_lm, 8 x 1024 tokens, in bfloat16 (phase
    7) or in float32, the framework's default (phase 24): finite,
    falling losses, finite parameters, and steps x 6 launches of each
    flash kernel on its dtype's route and none on another. Returns the
    trainer, the batch and {kernel: launches on its route}."""
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import SGD, create

    dtype = getattr(torch, compute_dtype)
    spec = _lm_spec(compute_dtype)
    topo = Topology(spec.cost, extra_outputs=[spec.output])
    params = create(topo, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in params.raw.values())
    trainer = SGD(spec.cost, params, Adam(learning_rate=1e-4))
    batch = _lm_batch()
    losses = [trainer.train_batch(batch)[0] for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _flash_counts(fa, zero=True)
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(trainer.train_batch(batch)[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _flash_counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: "
                             f"{losses}")
    bad = [k for k, p in params.raw.items()
           if not bool(torch.isfinite(p).all())]
    if bad:
        raise AssertionError(f"non-finite parameters after training: {bad}")
    want = steps * TRAIN["n_layers"]
    routes = {name: fa.flash_route(name, dtype) for name in launches}
    expect = {name: {r: want if r == routes[name] else 0
                     for r in fa.flash_routes(name)} for name in launches}
    if launches != expect:
        raise AssertionError(f"flash launches by route {launches} != "
                             f"{expect} (steps x layers = {want})")
    step_ms = wall / steps * 1e3
    tokens = TRAIN_ROWS * TRAIN["max_len"]
    log(f"train: {n_params} parameters, {compute_dtype}, {steps} timed "
        f"steps after {TRAIN_WARMUP}: step_ms {step_ms:.3f}, "
        f"{tokens / (step_ms / 1e3):.1f} tokens/s, peak "
        f"{peak_gb:.3f} GB; losses {[round(x, 4) for x in losses]}; "
        f"flash launches by route {launches}")
    return trainer, batch, {name: launches[name][routes[name]]
                            for name in launches}


# compute dtype -> (relative perturbation of the token table that
# gives the plain path's own spread, least gradient bound, cost rtol)
GRAD_CHECK = {"float32": (2.0 ** -22, 1e-3, 1e-5),
              # one bf16 ulp: x (1 + 2^-7) moves every entry by 1-2 ulps
              "bfloat16": (2.0 ** -7, 2e-2, 2e-2)}
# the projections around each layer's attention, whose gradients the
# flash kernels feed directly
ATTN_LEAF = re.compile(r"_l\d+_(q|k|v|proj)\.w0$")


def phase_flash_grad_check(batch, compute_dtype="float32", label=None):
    """Full width, one table, in ``compute_dtype``: the gradients of one
    Topology.forward cost with use_flash_attention True (the kernels of
    ``flash_route``: in float32 the tf32x3 forward, dq and dk/dv)
    against
    False (the plain version): the worst per-parameter
    ||g_kernel - g_plain|| / ||g_plain|| at most max(1e-3, twice the
    plain version's own spread), and the costs within 1e-5 (float32);
    max(2e-2, twice the spread) and 2e-2 in bfloat16, where the spread
    comes from a one-ulp perturbation of the bf16 inputs. The leaves
    the flash kernels feed directly, each layer's q, k, v and output
    projections, are also held one by one: each at most max(least,
    twice its own spread). A planted fault, dv x 0.85 out of every
    dk/dv launch, must fail that per-leaf check.

    Not elementwise: the FFN's ReLU makes the gradient discontinuous,
    and among the 8192 x 2048 pre-activations of a layer some lie
    within float32 rounding of 0, so any two correct float32 runs that
    round differently flip a few of them: single gradient entries move
    by up to ~1e-2 of max|g| and whole parameters by ~1e-3 in norm.
    The same measures between the plain version and itself with the
    token table scaled by (1 + 2^-22) give that noise floor.

    ``label`` starts the log lines (phase 39 holds its ragged rows this
    way)."""
    from paddle_tpu_torch.config import global_config
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.trainer import DataFeeder, create

    eps, least, cost_rtol = GRAD_CHECK[compute_dtype]
    spec = _lm_spec(compute_dtype)
    label = label or compute_dtype
    topo = Topology(spec.cost)
    params = create(topo, torch.Generator().manual_seed(1)).raw
    feed = DataFeeder(topo.data_type(), device="cuda")(batch)
    n_real = feed.pop("__batch_size__")
    names = sorted(params)
    leaves = [params[k].requires_grad_() for k in names]
    attn = [i for i, n in enumerate(names) if ATTN_LEAF.search(n)]

    def grads(flag):
        global_config().use_flash_attention = flag
        try:
            outs, _ = topo.forward(params, {}, feed, n_real=n_real)
            cost = outs[spec.cost.name].sum() / n_real
            return cost.item(), torch.autograd.grad(cost, leaves)
        finally:
            global_config().use_flash_attention = True

    def per_leaf(ga, gb):
        return ([((a - b).norm() / b.norm()).item() for a, b in zip(ga, gb)],
                [((a - b).abs().max() / b.abs().max()).item()
                 for a, b in zip(ga, gb)])

    cost_k, g_k = grads(True)
    cost_p, g_p = grads(False)
    tok = params["_tfm_tok_emb.w0"]
    saved = tok.detach().clone()
    with torch.no_grad():
        tok.mul_(1.0 + eps)
    _, g_floor = grads(False)
    with torch.no_grad():
        tok.copy_(saved)
    real_dkv = fa.flash_backward_dkv

    def faulty_dkv(*args):
        dk, dv = real_dkv(*args)
        return dk, dv * 0.85

    faulty_dkv.launches = 0
    faulty_dkv.route_launches = dict.fromkeys(fa.flash_routes("dkv"), 0)
    fa.flash_backward_dkv = faulty_dkv
    try:
        _, g_bad = grads(True)
    finally:
        fa.flash_backward_dkv = real_dkv
    rels, ents = per_leaf(g_k, g_p)
    floors, ent_floors = per_leaf(g_floor, g_p)
    bads, _ = per_leaf(g_bad, g_p)
    rel, ent, rel_floor = max(rels), max(ents), max(floors)

    def attn_worst(r):
        """(name, ratio to its own limit) of the worst attention leaf."""
        i = max(attn, key=lambda j: r[j] / max(least, 2.0 * floors[j]))
        return names[i], r[i] / max(least, 2.0 * floors[i])

    a_name, a_ratio = attn_worst(rels)
    b_name, b_ratio = attn_worst(bads)
    log(f"{label} grads at full width over {len(names)} parameters:"
        f" cost {cost_k:.6f} (kernels) vs {cost_p:.6f} (plain); kernels vs "
        f"plain worst ||diff||/||g|| {rel:.3e}, worst max|diff|/max|g| "
        f"{ent:.3e}; plain vs plain at a {eps:.3g} input perturbation "
        f"{rel_floor:.3e} and {max(ent_floors):.3e}")
    log(f"{label} attention leaves ({len(attn)}): ||diff||/||g|| "
        f"{min(rels[i] for i in attn):.3e}-{max(rels[i] for i in attn):.3e} "
        f"against own spreads {min(floors[i] for i in attn):.3e}-"
        f"{max(floors[i] for i in attn):.3e}; worst at {a_ratio:.3f} of its "
        f"limit ({a_name})")
    log(f"{label} planted fault, dv x 0.85: attention leaves "
        f"||diff||/||g|| up to {max(bads[i] for i in attn):.3e}, worst at "
        f"{b_ratio:.3f} of its limit ({b_name}: per-leaf check "
        f"{'rejects' if b_ratio > 1 else 'passes'} it); whole-table worst "
        f"{max(bads):.3e} against {max(least, 2.0 * rel_floor):.3e} "
        f"({'rejects' if max(bads) > max(least, 2.0 * rel_floor) else 'passes'}"
        f" it)")
    if not rel <= max(least, 2.0 * rel_floor) or a_ratio > 1 or \
            abs(cost_k - cost_p) > cost_rtol * abs(cost_p):
        raise AssertionError(f"{label} flash-path gradients off the "
                             f"plain path: ||diff||/||g|| {rel} > max("
                             f"{least}, 2 x {rel_floor}), or {a_name} at "
                             f"{a_ratio} of its own limit, or cost {cost_k} "
                             f"vs {cost_p}")
    if not b_ratio > 1:
        raise AssertionError(f"{label}: the per-leaf check passes a "
                             f"planted fault (dv x 0.85): {b_name} at "
                             f"{b_ratio} of its limit")


# ------------------------------------------------------------ phase 8
def phase_train_to_serve(trainer):
    """The trained table: Parameters.to_tar -> load_params_tar ->
    TransformerDecoder (tied head) -> DecodeEngine, 4 seeded requests,
    tokens identical to the dense generate under the tie rule."""
    import io
    from paddle_tpu_torch.models.decode import (TransformerDecoder,
                                                tokens_agree)
    from paddle_tpu_torch.params import load_params_tar
    from paddle_tpu_torch.serving import DecodeEngine

    buf = io.BytesIO()
    trainer.save_parameter_to_tar(buf)
    buf.seek(0)
    table = load_params_tar(buf)
    if "_tfm_head.w0" in table:
        raise AssertionError("a tied table carries a separate head")
    dec = TransformerDecoder(table, n_layers=TRAIN["n_layers"],
                             n_heads=TRAIN["n_heads"])
    eng = DecodeEngine(dec, num_slots=4, page_size=PAGE, max_seq_len=128)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, TRAIN["vocab_size"],
                           (int(rng.randint(16, 49)),)).astype(np.int32)
               for _ in range(4)]
    reqs = [eng.submit(p, 16) for p in prompts]
    eng.run(timeout=600)
    st = eng.stats()
    if st["step_failures"]:
        raise AssertionError(f"{st['step_failures']} step failures: "
                             f"{eng.last_step_error}")
    for i, (p, r) in enumerate(zip(prompts, reqs)):
        got = r.get(timeout=1)
        want = dec.generate(p[None, :], max_len=len(p) + 16)[0]
        ref = dec.prefill_logits(np.concatenate([p, want])[None, :])[0]
        tol = TIE_ATOL + TIE_RTOL * float(np.abs(ref).max())
        if len(got) != 16 or not tokens_agree(got, want, ref[len(p) - 1:],
                                               tol):
            raise AssertionError(f"served request {i} differs from the "
                                 "dense decoder")
    log(f"train -> serve: 4 requests x 16 tokens from the trained table, "
        f"{st['steps']} engine steps, zero step failures, tokens identical "
        "to the dense decoder")


# ------------------------------------------------------------ phase 9
def _flash_work(kernel, dtype, T, kv_lens, causal=True):
    """(flops, bytes) of one call at FLASH_SHAPE: operations count the
    valid (query, key) pairs of these inputs, the forward two products
    of 2 d flops a pair (S = QK^T, PV), dq three (S, dO V^T, dS K) and
    dk/dv four (S, dO V^T, P^T dO, dS^T Q); bytes each input read once
    and each output written once."""
    b, h, d = FLASH_SHAPE
    pairs = sum(min(L, T) * (min(L, T) + 1) // 2 + (T - min(L, T)) * min(L, T)
                if causal else T * L for L in kv_lens) * h
    esize = 2 if dtype == torch.bfloat16 else 4
    tensor = b * T * h * d * esize
    rows = b * h * T * 4                       # one float32 per row
    products, n_tensors, n_rows = {"fwd": (2, 4, 1), "dq": (3, 5, 2),
                                   "dkv": (4, 6, 2)}[kernel]
    return (products * 2.0 * d * pairs,
            n_tensors * tensor + n_rows * rows + b * 8)


def _flash_bound(kernel, dtype, T, kv_lens, causal=True):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    at 3.35 TB/s and its operations at its route's peak: bf16 wgmma
    (sm90) at 989 TFLOP/s, and the float32 tf32x3 kernels as three TF32
    passes of every product at 494.7 TFLOP/s (a tensor-core kernel can
    read under the SIMT float32 floor, which is no bound for it)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    flops, nbytes = _flash_work(kernel, dtype, T, kv_lens, causal)
    rate = {"sm90": BF16_FLOPS_PER_S,
            "tf32x3": TF32_FLOPS_PER_S / 3}[fa.flash_route(kernel, dtype)]
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def phase_flash_timings():
    """Each flash kernel's device time per call at the training shapes
    (8 x 1024 tokens, 8 heads, dh 64, causal, full-length rows), bf16
    and f32, by CUDA-graph replay over 6 input sets (one per layer, so
    the inputs do not sit in L2); its bound; the plain version's time;
    and, as a yardstick the port never calls, SDPA (forward for the
    forward kernel, its autograd backward for dq + dk/dv together)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    T = TRAIN["max_len"]
    kv_lens = [T] * FLASH_SHAPE[0]
    lens2 = torch.tensor([[T, T]] * FLASH_SHAPE[0], dtype=torch.int32,
                         device="cuda")
    scale = FLASH_SHAPE[2] ** -0.5
    out = {}
    log(f"flash timings on {nvidia_smi_line()}")
    for dtype in (torch.bfloat16, torch.float32):
        sets = []
        for i in range(TRAIN["n_layers"]):
            q, k, v, do = _flash_inputs(T, dtype, seed=90 + i)
            o, lse = fa.flash_forward(q, k, v, lens2, True, scale)
            sets.append((q, k, v, do, lse, fa.rowsum_do_o(do, o)))
        L = len(sets)

        def fwd(i):
            q, k, v = sets[i % L][:3]
            return fa.flash_forward(q, k, v, lens2, True, scale)

        def dq(i):
            return fa.flash_backward_dq(*sets[i % L], lens2, True, scale)

        def dkv(i):
            return fa.flash_backward_dkv(*sets[i % L], lens2, True, scale)

        def fwd_plain(i):
            q, k, v = sets[i % L][:3]
            return (fa.flash_attention_reference(q, k, v, None, lens2[:, 1],
                                                 True, scale),
                    fa.flash_lse_reference(q, k, None, lens2[:, 1], True,
                                           scale))

        def dq_plain(i):
            return fa.flash_dq_reference(*sets[i % L], None, lens2[:, 1],
                                         True, scale)

        def dkv_plain(i):
            return fa.flash_dkv_reference(*sets[i % L], None, lens2[:, 1],
                                          True, scale)

        heads = [[x.transpose(1, 2) for x in s[:4]] for s in sets]

        def sdpa(i):
            q, k, v = heads[i % L][:3]
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        lib_fwd = device_ms(sdpa, iters=12)
        leaves = [[x.detach().requires_grad_() for x in h_[:3]]
                  for h_ in heads]
        outs = [F.scaled_dot_product_attention(*lv, is_causal=True)
                for lv in leaves]

        def sdpa_bwd(i):
            return torch.autograd.grad(outs[i % L], leaves[i % L],
                                       heads[i % L][3], retain_graph=True)

        lib_bwd = event_ms(sdpa_bwd, iters=12)
        for name, kern, plain, lib in (("fwd", fwd, fwd_plain, lib_fwd),
                                       ("dq", dq, dq_plain, lib_bwd),
                                       ("dkv", dkv, dkv_plain, lib_bwd)):
            bound_ms, bound_by = _flash_bound(name, dtype, T, kv_lens)
            out[(name, dtype)] = dict(
                ms=device_ms(kern, iters=12),
                plain_ms=device_ms(plain, iters=3), bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib)
            r = out[(name, dtype)]
            route = fa.flash_route(name, dtype)
            simt = ""
            if route == "tf32x3":
                simt_us = _flash_work(name, dtype, T, kv_lens)[0] / \
                    FP32_FLOPS_PER_S * 1e6
                simt = (f", SIMT float32 floor {simt_us:.3f} us (67 "
                        "TFLOP/s; no bound for this route)")
            log(f"flash {name} {str(dtype)[6:]} ({route}) at train shapes: "
                f"{r['ms'] * 1e3:.2f} us/call, bound {bound_ms * 1e3:.3f} "
                f"us ({bound_by}){simt}, plain {r['plain_ms'] * 1e3:.2f} "
                "us, "
                f"sdpa {'fwd' if name == 'fwd' else 'bwd (dq+dkv)'} "
                f"{_us(lib)}")
            if r["ms"] < bound_ms:
                raise AssertionError(f"flash {name} {dtype}: {r['ms']} ms "
                                     f"reads under its bound {bound_ms} ms")
        del sets, heads, leaves, outs
    return out


def _us(ms):
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def event_ms(fn, iters):
    """Device milliseconds per call between CUDA events around ``iters``
    eager calls, for work that cannot be captured in a CUDA graph (an
    autograd backward, cuDNN's LSTM). A spin kernel launched first holds
    the card while the host queues the calls, so the events time the
    card's work and not the rate at which the host makes the calls
    (eager calls made as the card runs them time the host: SDPA's
    autograd backward at the LM's shapes costs the host more than the
    card). None, "not measured", when the host was still queueing as
    the spin ended: then host time is in the events' (a call that
    blocks the host, as cuDNN's float32 LSTM does, compacting its
    weights on every call, waits out any spin)."""
    fn(0)
    torch.cuda.synchronize()
    spin = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if queued_ms >= spin.elapsed_time(start):
        log(f"event_ms: the host queued for {queued_ms:.1f} ms, longer "
            f"than the {spin.elapsed_time(start):.1f} ms spin: the events' "
            f"{start.elapsed_time(end) / iters * 1e3:.2f} us/call include "
            "host time; not measured")
        return None
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ phase 10
def phase_train_trace(trainer, batch, label="train", what="flash kernels",
                      marks=("flash_",)):
    """One train step under torch.profiler: device busy time against
    the wall clock, the top device kernels, and the share of the
    kernels whose names hold one of ``marks`` (phases 10 and 16)."""
    _trace(lambda: trainer.train_batch(batch), label, "1 step", what, marks)


def _trace(run, label, unit, what, marks, launched=None):
    """``run()`` under torch.profiler: device busy time against the wall
    clock, the top device kernels, and the share of the kernels whose
    names hold one of ``marks``. With ``launched`` (a wrapper's launch
    count, read before and after), the launches of the run too, and a
    note where they left no record in the trace; returns that number
    of launches (None without ``launched``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    n0 = launched() if launched else 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n_launched = launched() - n0 if launched else None
    by_kernel = {}
    n_kernels = 0
    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA" and ev.self_device_time_total > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + \
                ev.self_device_time_total / 1e3
            n_kernels += ev.count
    busy_ms = sum(by_kernel.values())
    ours_ms = sum(v for k, v in by_kernel.items()
                  if any(m in k for m in marks))
    share = f"{ours_ms:.3f} ms ({ours_ms / busy_ms:.3f} of busy)"
    if n_launched is not None:
        share += f", launches {n_launched}"
        if n_launched and not ours_ms:
            share += " (no record of them in the trace)"
    log(f"{label} trace: {unit}, wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.3f}) in "
        f"{n_kernels} device operations, {what} {share}")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        if any(m in name for m in marks):
            log(f"{label} trace {what}: {ms:.3f} ms ({ms / busy_ms:.3f} of "
                f"busy)  {name[:90]}")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"{label} trace top kernel: {ms:.3f} ms  {name[:90]}")
    return n_launched


# ------------------------------------------------------------ phase 11
def _ragged_lens(b, T, seed, must=()):
    """Seeded lengths in [1, T] that include each of ``must``."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, T + 1, size=b)
    lens[:len(must)] = must
    return torch.tensor(lens, dtype=torch.int32, device="cuda")


def _randn(gen, *shape, scale=1.0, dtype=torch.float32):
    """Seeded normal draws made on the card (a numpy draw of the
    full-width streams costs seconds of host time)."""
    return (torch.randn(shape, generator=gen, device="cuda") * scale) \
        .to(dtype)


def _rnn_inputs(b, h, T, gates, dtype, seed):
    """x [b, T, gates*h], w [h, gates*h] in ``dtype``; bias, peep float32.
    Weights at the layer's smart init scale, 1/sqrt(h)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (_randn(gen, b, T, gates * h, scale=0.5, dtype=dtype),
            _randn(gen, h, gates * h, scale=h ** -0.5, dtype=dtype),
            _randn(gen, gates * h, scale=0.1), _randn(gen, 3 * h, scale=0.1))


def _lstm_function_check(x4, lens, w, bias, peep, dtype, seed):
    """dx4, dw, dbias, dpeep of lstm_sequence (the autograd Function: the
    forward and backward kernels plus the contractions) against autograd
    of the plain version in float32 on the same (rounded) values."""
    from paddle_tpu_torch import config
    from paddle_tpu_torch.ops import fused_rnn as fr
    b, T, four_h = x4.shape
    h = four_h // 4
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_out, g_h, g_c = (_randn(gen, *s) for s in ((b, T, h), (b, h), (b, h)))

    def grads(fn, dt):
        leaves = [t.float().clone().requires_grad_() for t in
                  (x4, w, bias, peep)]
        out, hT, cT = fn(*leaves)
        loss = (out.float() * g_out).sum() + (hT * g_h).sum() + \
            (cT * g_c).sum()
        return torch.autograd.grad(loss, leaves)

    config.init(seed=0, compute_dtype="bfloat16" if dtype == torch.bfloat16
                else "float32")
    try:
        got = grads(lambda x, w_, b_, p_: fr.lstm_sequence(x, lens, w_, b_,
                                                           p_), dtype)
    finally:
        config.init(seed=0, compute_dtype="float32")
    want = grads(lambda x, w_, b_, p_: fr.lstm_reference(x, lens, w_, b_, p_),
                 torch.float32)
    torch.cuda.synchronize()
    return {n: _held(n, g, r, dtype) for n, g, r in
            zip(("dx4", "dw", "dbias", "dpeep"), got, want)}


def _step_ratio(got, want):
    """(worst ratio, step) over the time steps of [b, T, .] (dz, out): max |err|
    of the step over max |ref| of the step, the latter floored at
    SLICE_FLOOR x max(1, max|ref|) (steps past every row's length are 0
    on both sides)."""
    g, w = got.float(), want.float()
    floor = SLICE_FLOOR * max(1.0, w.abs().max().item())
    ratio = (g - w).abs().amax((0, 2)) / w.abs().amax((0, 2)).clamp_min(floor)
    return ratio.max().item(), int(ratio.argmax())


def _scaled_step(x, t, f=0.95):
    bad = x.float().clone()
    bad[:, t] *= f
    return bad


def _stale_step(x, t):
    bad = x.float().clone()
    bad[:, t] = bad[:, t - 1]
    return bad


def _held_steps(label, name, got, ref, faults):
    """bfloat16 dz or out held per time step: max |err| <= 2e-2 x max
    |ref| of the step (_step_ratio). The whole-tensor bound is set by the
    largest step and cannot see one wrong step among 128 — as a
    cross-proxy fault between one step's state stores and the next
    step's TMA reads would be. It must reject each planted fault of
    ``faults``, (description, faulty tensor) pairs: for dz, x 0.95 at
    step 0, the last step the reverse walk computes; for out, x 0.95 at
    step 0 and a stale step (step t's output replaced by step t-1's).
    Returns the worst ratio."""
    r, at = _step_ratio(got, ref)
    if r > BF16_ATOL:
        raise AssertionError(f"{label} bf16 {name}: step {at} off by "
                             f"{r:.3e} of its max|ref| > {BF16_ATOL}")
    limit = BF16_ATOL * max(1.0, ref.float().abs().max().item())
    for fault, bad in faults:
        rb, _ = _step_ratio(bad, ref)
        whole = (bad - ref.float()).abs().max().item()
        log(f"{label} planted fault, {fault}: step ratio {rb:.3e} (limit "
            f"{BF16_ATOL}); whole-tensor max|err| {whole:.3e} (limit "
            f"{limit:.3e}, {'rejects' if whole > limit else 'passes'} it)")
        if not rb > BF16_ATOL:
            raise AssertionError(f"{label}: the step check passes a planted "
                                 f"fault ({fault}): ratio {rb}")
    return r


def _held_steps_f32(label, name, got, ref, faults):
    """float32 out or dz held per time step at _held's float32
    tolerance, its atol scaled by the step's own max(1, max|ref|): the
    ratio of each element's |err| to atol + rtol |ref| is at most 1 over
    the step. It must reject each planted fault of ``faults`` (x 0.99 at
    step 0; stale at step T/2). Returns the worst ratio."""
    w = ref.float()
    atol = F32_TOL["atol"] * w.abs().amax((0, 2)).clamp_min(1.0)
    limit = atol[None, :, None] + F32_TOL["rtol"] * w.abs()

    def ratio(g):
        r = ((g.float() - w).abs() / limit).amax((0, 2))
        return r.max().item(), int(r.argmax())

    r, at = ratio(got)
    if r > 1.0:
        raise AssertionError(f"{label} f32 {name}: step {at} at {r:.3e} of "
                             "its float32 tolerance")
    for fault, bad in faults:
        rb, _ = ratio(bad)
        log(f"{label} planted fault, {fault}: {rb:.3e} of the step's "
            f"float32 tolerance ({'rejects' if rb > 1.0 else 'passes'} it)")
        if not rb > 1.0:
            raise AssertionError(f"{label}: the float32 step check passes a "
                                 f"planted fault ({fault}): ratio {rb}")
    return r


def phase_rnn_vs_plain():
    """The LSTM forward (both modes) and backward kernels and the GRU
    kernel against their plain versions on the same inputs: the LSTM at
    full width (b 128, h 1280, T 128, ragged lengths with 100, 1 and
    128), at a shape that is a multiple of no tile (b 6, h 48, T 13), at
    two batch tiles (b 160, h 256, T 17) and at an odd h with every row
    shorter than T (b 5, h 45, T 9); the GRU at b 64, h 128, T 64,
    ragged. float32 and bfloat16, the tolerances of _held; each
    direct forward call on the route of its dtype."""
    from paddle_tpu_torch.ops import fused_rnn as fr
    worst = {"lstm_fwd": 0.0, "lstm_fwd_f32": 0.0, "lstm_bwd": 0.0,
             "lstm_bwd_f32": 0.0, "gru_fwd": 0.0}
    # the last case: odd h (no 8-byte unit pairs) and every row shorter
    # than T (steps past the longest row)
    lstm_cases = [("b128 h1280 T128", 128, 1280, 128, (100, 1, 128)),
                  ("b6 h48 T13", 6, 48, 13, (13, 1, 7)),
                  ("b160 h256 T17", 160, 256, 17, (17, 1, 9)),
                  ("b5 h45 T9", 5, 45, 9, (7, 1, 4, 6, 2))]
    for ci, (label, b, h, T, must) in enumerate(lstm_cases):
        lens = _ragged_lens(b, T, seed=110 + ci, must=must)
        for dtype in (torch.float32, torch.bfloat16):
            x4, w, bias, peep = _rnn_inputs(b, h, T, 4, dtype, 120 + ci)
            routes = dict(fr.lstm_forward.route_launches)
            out, hT, cT = fr.lstm_forward(x4, lens, w, bias, peep)
            res = fr.lstm_forward(x4, lens, w, bias, peep, save_res=True)
            torch.cuda.synchronize()
            route = fr.lstm_fwd_route(dtype)
            if fr.lstm_forward.route_launches[route] - routes[route] != 2:
                raise AssertionError(f"{label} {dtype}: the forward calls "
                                     f"did not take the {route} route")
            ref = fr.lstm_reference(x4, lens, w, bias, peep, save_res=True)
            errs = {}
            # gates past the longest row are 0 by the kernels' contract
            # (the plain version computes them from the frozen state; the
            # backward reads no gate of an invalid step)
            run = int(lens.max())
            for name, a, r in (("out", out, ref[0]), ("hT", hT, ref[1]),
                               ("cT", cT, ref[2]), ("out/res", res[0], ref[0]),
                               ("hT/res", res[1], ref[1]),
                               ("cT/res", res[2], ref[2]),
                               ("cseq", res[3], ref[3]),
                               ("gates", res[4][:, :run], ref[4][:, :run])):
                errs[name] = _held(name, a, r, dtype)
            if res[4][:, run:].abs().max().item() if run < T else 0:
                raise AssertionError(f"{label} {dtype}: gates past the "
                                     "longest row are not 0")
            gen = torch.Generator(device="cuda").manual_seed(130 + ci)
            d_out = _randn(gen, b, T, h, dtype=dtype)
            dhT, dcT = _randn(gen, b, h), _randn(gen, b, h)
            cseq, gates = res[3], res[4]
            bwd_route = fr.lstm_bwd_route(dtype)
            before = fr.lstm_backward.route_launches[bwd_route]
            dz = fr.lstm_backward(w, peep, lens, gates, cseq, d_out, dhT, dcT)
            torch.cuda.synchronize()
            if fr.lstm_backward.route_launches[bwd_route] - before != 1:
                raise AssertionError(f"{label} {dtype}: the backward call "
                                     f"did not take the {bwd_route} route")
            dz_ref = fr.lstm_backward_reference(w, peep, lens, gates, cseq,
                                                d_out, dhT, dcT)
            errs["dz"] = _held("dz", dz, dz_ref, dtype)
            mid = T // 2
            if dtype == torch.bfloat16:
                for name, got, want in (("out", out, ref[0]),
                                        ("out/res", res[0], ref[0])):
                    errs[f"{name}/step"] = _held_steps(
                        label, name, got, want,
                        [(f"{name} x 0.95 at step 0", _scaled_step(got, 0)),
                         (f"{name} stale at step {mid} (step {mid - 1}'s)",
                          _stale_step(got, mid))])
                errs["dz/step"] = _held_steps(
                    label, "dz", dz, dz_ref,
                    [("dz x 0.95 at step 0", _scaled_step(dz, 0))])
            else:
                for name, got, want in (("out", out, ref[0]),
                                        ("out/res", res[0], ref[0])):
                    errs[f"{name}/step"] = _held_steps_f32(
                        label, name, got, want,
                        [(f"{name} x 0.99 at step 0",
                          _scaled_step(got, 0, 0.99)),
                         (f"{name} stale at step {mid} (step {mid - 1}'s)",
                          _stale_step(got, mid))])
                errs["dz/step"] = _held_steps_f32(
                    label, "dz", dz, dz_ref,
                    [("dz x 0.99 at step 0", _scaled_step(dz, 0, 0.99)),
                     (f"dz stale at step {mid} (step {mid - 1}'s)",
                      _stale_step(dz, mid))])
            fwd_err = max(errs[k] for k in ("out", "hT", "cT", "out/res",
                                            "hT/res", "cT/res", "cseq",
                                            "gates"))
            errs.update(_lstm_function_check(x4, lens, w, bias, peep, dtype,
                                             140 + ci))
            if dtype == torch.bfloat16:
                # the kernels the JSON rows name, lstm_fwd_sm90.cu and
                # lstm_bwd_sm90.cu, run bfloat16 only: their rows hold
                # their outputs; lstm_fwd_f32 and lstm_bwd_f32
                # (lstm_{fwd,bwd}_bf16x3_sm90.cu) the float32 kernels'
                worst["lstm_fwd"] = max(worst["lstm_fwd"], fwd_err)
                worst["lstm_bwd"] = max(worst["lstm_bwd"], errs["dz"])
            else:
                worst["lstm_fwd_f32"] = max(worst["lstm_fwd_f32"], fwd_err)
                worst["lstm_bwd_f32"] = max(worst["lstm_bwd_f32"], errs["dz"])
            log(f"lstm vs plain {label} {str(dtype)[6:]} (forward route "
                f"{route}, backward route {bwd_route}): " +
                ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    worst["gru_fwd"] = _gru_vs_plain()
    return worst


# the GRU's phase-11 cases: (label, b, h, T, lengths that must occur);
# by gru_fwd_plan's route in float32 / bfloat16 on an H100: the tagger's
# batch (sm90, n 1 / n 1), odd and small shapes (n 1 / n 1), then
# n 2 / n 1, n 4 / n 2 (2 rows a cluster), n 8 / n 4 (4 rows; b 37: a
# last cluster part empty), coop / n 8, coop / coop, and 2 rows a block
# (n 1, b 600)
GRU_CASES = [("b64 h128 T64", 64, 128, 64, (64, 1, 33)),
             ("b6 h48 T13", 6, 48, 13, (13, 1, 7)),
             ("b5 h45 T9", 5, 45, 9, (9, 1, 4)),
             ("b64 h160 T17", 64, 160, 17, (17, 1, 9)),
             ("b64 h256 T17", 64, 256, 17, (17, 1, 9)),
             ("b37 h352 T17", 37, 352, 17, (17, 1, 9)),
             ("b64 h448 T17", 64, 448, 17, (17, 1, 9)),
             ("b64 h1024 T17", 64, 1024, 17, (17, 1, 9)),
             ("b600 h48 T5", 600, 48, 5, (5, 1, 3))]


def _gru_vs_plain():
    """The GRU forward through gru_forward against gru_reference at each
    of GRU_CASES, float32 and bfloat16, at the tolerances of _held and
    per time step (_held_steps, which must reject out stale at step
    T/2); each call on gru_fwd_plan's route, counted by route, the cases
    covering each cluster size and 1, 2 and 4 rows a cluster. First
    the plan's shared-memory arithmetic (fused_rnn._gru_sm90_smem)
    against the kernel's layout over h < 600. Returns the worst float32
    error of the sm90 kernel's calls."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_rnn as fr
    # the plan's shared-memory mirror against the kernel's own layout
    smem_of = _build.load("gru_fwd_sm90").pt_gru_fwd_sm90_smem
    smem_of.restype = ctypes.c_int
    smem_of.argtypes = [ctypes.c_int] * 4
    for h in range(1, 600):
        for n in fr._GRU_CLUSTERS:
            for rows in fr._GRU_ROWS:
                for esize in (2, 4):
                    want = smem_of(h, n, rows, esize)
                    got = fr._gru_sm90_smem(h, n, rows, esize)[1]
                    if got != want:
                        raise AssertionError(
                            f"_gru_sm90_smem(h {h}, n {n}, rows {rows}, "
                            f"esize {esize}) = {got}, the kernel's layout "
                            f"{want}")
    worst = 0.0
    routes_seen = {"sm90": set(), "coop": set()}
    for ci, (label, b, h, T, must) in enumerate(GRU_CASES):
        lens = _ragged_lens(b, T, seed=150 + ci, must=must)
        for dtype in (torch.float32, torch.bfloat16):
            x3, w, bias, _ = _rnn_inputs(b, h, T, 3, dtype, 160 + ci)
            plan = fr.gru_fwd_plan(b, h, dtype, _sms())
            before = dict(fr.gru_forward.route_launches)
            out, hT = fr.gru_forward(x3, lens, w, bias)
            torch.cuda.synchronize()
            taken = {k: v - before[k]
                     for k, v in fr.gru_forward.route_launches.items()}
            if taken != {r: int(r == plan.route) for r in taken}:
                raise AssertionError(f"gru {label} {dtype}: launches by "
                                     f"route {taken}, plan {plan}")
            routes_seen[plan.route].add((plan.cluster, plan.rows))
            ref_out, ref_hT = fr.gru_reference(x3, lens, w, bias)
            errs = {"out": _held("gru out", out, ref_out, dtype),
                    "hT": _held("gru hT", hT, ref_hT, dtype)}
            mid = T // 2
            errs["out/step"] = _held_steps(
                f"gru {label} {str(dtype)[6:]}", "out", out, ref_out,
                [(f"out stale at step {mid} (step {mid - 1}'s)",
                  _stale_step(out, mid))])
            if dtype == torch.float32 and plan.route == "sm90":
                worst = max(worst, errs["out"], errs["hT"])
            log(f"gru vs plain {label} {str(dtype)[6:]} (route {plan.route}"
                f", cluster {plan.cluster}, rows {plan.rows}, smem "
                f"{plan.smem}): " + ", ".join(f"{n} {e:.3e}"
                                              for n, e in errs.items()))
    if routes_seen["sm90"] != {(n, r) for n, r in
                               ((1, 1), (2, 1), (4, 2), (8, 4), (1, 2))} \
            or not routes_seen["coop"]:
        raise AssertionError(f"the GRU cases missed a route or cluster "
                             f"size: {routes_seen}")
    return worst


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


# ------------------------------------------------------------ phase 12
# the RNN benchmark bench.py:214-242 trains (benchmark/paddle/rnn/rnn.py
# shape), at its widest row lstm_bs128_h1280
LSTM_NET = dict(vocab_size=30000, emb_size=128, hidden_size=1280,
                lstm_num=1, num_classes=2)
LSTM_PARAMS = 11060482
LSTM_ROWS, LSTM_TOKENS, LSTM_WARMUP, LSTM_STEPS = 128, 100, 2, 8
# bench.py trains this model with Adam(2e-3); at hidden 1280 that rate
# overshoots at the third step on this table and batch and the loss is
# not falling after 10 steps (phase 12 prints it, PERF.md). The step's
# work does not depend on the rate.
LSTM_LR = 5e-4
TAGGER = dict(vocab_size=20000, num_labels=45, emb_size=128, hidden_size=128)
# the LSTM kernels' names in a trace (phases 16 and 25)
LSTM_MARKS = ("lstm_fwd_bf16x3_kernel", "lstm_fwd_sm90_kernel",
              "lstm_bwd_bf16x3_kernel", "lstm_bwd_sm90_kernel")
# (name, line of the TPU kernel in ops/pallas_rnn.py, source)
RNN_KERNELS = [("lstm_fwd", 62, "lstm_fwd_sm90.cu"),
               ("lstm_bwd", 121, "lstm_bwd_sm90.cu"),
               ("gru_fwd", 371, "gru_fwd_sm90.cu")]


def _rnn_counts(fr, zero=False):
    fns = (fr.lstm_forward, fr.lstm_backward, fr.gru_forward)
    if zero:
        for fn in fns:
            fn.launches = 0
        fr.lstm_forward.res_launches = 0
        fr.lstm_forward.route_launches = {"sm90": 0, "bf16x3": 0}
        fr.lstm_backward.route_launches = {"sm90": 0, "bf16x3": 0}
        fr.gru_forward.route_launches = {"sm90": 0, "coop": 0}
    return {"lstm_fwd": fr.lstm_forward.launches,
            "lstm_res": fr.lstm_forward.res_launches,
            "lstm_fwd_routes": dict(fr.lstm_forward.route_launches),
            "lstm_bwd": fr.lstm_backward.launches,
            "lstm_bwd_routes": dict(fr.lstm_backward.route_launches),
            "gru_fwd": fr.gru_forward.launches,
            "gru_fwd_routes": dict(fr.gru_forward.route_launches)}


def _lstm_spec(compute_dtype):
    from paddle_tpu_torch import config
    from paddle_tpu_torch.core.registry import reset_name_counters
    from paddle_tpu_torch.models import stacked_lstm_net
    config.init(seed=0, compute_dtype=compute_dtype)
    reset_name_counters()
    return stacked_lstm_net(**LSTM_NET)


def _lstm_samples(n, seed, ragged=False):
    """n seeded (word ids, label) samples: LSTM_TOKENS tokens each, or
    1..LSTM_TOKENS with ``ragged``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        L = int(rng.randint(1, LSTM_TOKENS + 1)) if ragged else LSTM_TOKENS
        out.append((rng.randint(0, LSTM_NET["vocab_size"], (L,))
                    .astype(np.int32), int(rng.randint(0, 2))))
    return out


def phase_lstm_train(compute_dtype="bfloat16"):
    """The sequence slice's main training path: stacked_lstm_net at the
    benchmark's widest row, SGD.train_batch with Adam(LSTM_LR) on one
    seeded batch of 128 rows of 100 tokens, in bfloat16 (phase 12) or in
    float32, the framework's default (phase 25): finite, falling losses,
    finite parameters, and LSTM_STEPS launches each of the forward (with
    residuals) and backward kernels, every one on its dtype's route
    (lstm_fwd_route, lstm_bwd_route) and none on another. Returns the
    spec, the trainer, the batch and the launch counts."""
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.ops import fused_rnn as fr
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import SGD, create

    dtype = getattr(torch, compute_dtype)
    spec = _lstm_spec(compute_dtype)
    topo = Topology(spec.cost, extra_outputs=[spec.output])
    params = create(topo, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in params.raw.values())
    if n_params != LSTM_PARAMS:
        raise AssertionError(f"{n_params} parameters, expected {LSTM_PARAMS}")
    trainer = SGD(spec.cost, params, Adam(learning_rate=LSTM_LR))
    batch = _lstm_samples(LSTM_ROWS, seed=0)
    losses = [trainer.train_batch(batch)[0] for _ in range(LSTM_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _rnn_counts(fr, zero=True)
    t0 = time.perf_counter()
    for _ in range(LSTM_STEPS):
        losses.append(trainer.train_batch(batch)[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _rnn_counts(fr)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"LSTM losses not finite and falling: {losses}")
    bad = [k for k, p in params.raw.items()
           if not bool(torch.isfinite(p).all())]
    if bad:
        raise AssertionError(f"non-finite parameters after training: {bad}")
    routes = {k: {r: LSTM_STEPS if r == route(dtype) else 0
                  for r in ("sm90", "bf16x3")}
              for k, route in (("lstm_fwd_routes", fr.lstm_fwd_route),
                               ("lstm_bwd_routes", fr.lstm_bwd_route))}
    if not (counts["lstm_fwd"] == counts["lstm_res"] == counts["lstm_bwd"]
            == LSTM_STEPS) or \
            any(counts[k] != v for k, v in routes.items()):
        raise AssertionError(f"LSTM launches {counts} != {LSTM_STEPS} each, "
                             f"every forward and backward on its {dtype} "
                             f"route ({routes})")
    step_ms = wall / LSTM_STEPS * 1e3
    log(f"lstm train: {n_params} parameters, {compute_dtype}, "
        f"{LSTM_STEPS} timed steps after {LSTM_WARMUP}: {step_ms:.3f} "
        "ms/step, "
        f"{LSTM_ROWS / (step_ms / 1e3):.1f} samples/s, "
        f"{LSTM_ROWS * LSTM_TOKENS / (step_ms / 1e3):.1f} tokens/s, peak "
        f"{peak_gb:.3f} GB; losses {[round(x, 5) for x in losses]}; "
        f"launches {counts}")
    if dtype == torch.float32:
        return spec, trainer, batch, counts
    # the record behind LSTM_LR: the benchmark's rate on the same table
    # and batch
    bench = SGD(spec.cost, create(topo, torch.Generator().manual_seed(0)),
                Adam(learning_rate=2e-3))
    log("lstm train at the benchmark's Adam(2e-3), same table and batch: "
        f"losses {[round(bench.train_batch(batch)[0], 5) for _ in range(6)]}")
    return spec, trainer, batch, counts


def phase_lstm_grad_check(batch):
    """float32, full width, one table, the first 16 rows of the train
    batch (the CPU side is the slow one): the gradients of one cost
    through the kernels on the card against the same cost through the
    plain scan of the CPU port; worst per-parameter ||diff|| / ||g|| <=
    1e-3 and the costs within 1e-5 (relative)."""
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.ops import fused_rnn as fr
    from paddle_tpu_torch.trainer import DataFeeder, create

    spec = _lstm_spec("float32")
    topo = Topology(spec.cost)
    table = create(topo, torch.Generator().manual_seed(1), device="cpu").raw

    def grads(device):
        params = {k: v.detach().to(device).requires_grad_()
                  for k, v in table.items()}
        feed = DataFeeder(topo.data_type(), device=device)(batch)
        n_real = feed.pop("__batch_size__")
        outs, _ = topo.forward(params, {}, feed, n_real=n_real)
        cost = outs[spec.cost.name].sum() / n_real
        names = sorted(params)
        g = torch.autograd.grad(cost, [params[k] for k in names])
        return cost.item(), {k: v.detach().cpu() for k, v in zip(names, g)}

    before = _rnn_counts(fr)
    cost_k, g_k = grads("cuda")
    after = _rnn_counts(fr)
    if after["lstm_bwd"] - before["lstm_bwd"] != 1 or \
            after["lstm_bwd_routes"]["bf16x3"] - \
            before["lstm_bwd_routes"]["bf16x3"] != 1:
        raise AssertionError("the card's gradient did not run the float32 "
                             f"(bf16x3) backward kernel: {before} -> {after}")
    cost_p, g_p = grads("cpu")
    rel = {k: ((g_k[k] - g_p[k]).norm() / g_p[k].norm()).item()
           for k in g_p}
    name, worst = max(rel.items(), key=lambda kv: kv[1])
    log(f"lstm f32 grads at full width over {len(rel)} parameters: cost "
        f"{cost_k:.7f} (kernels, card) vs {cost_p:.7f} (plain, CPU); worst "
        f"||diff||/||g|| {worst:.3e} ({name})")
    if worst > 1e-3 or abs(cost_k - cost_p) > 1e-5 * abs(cost_p):
        raise AssertionError(f"kernel-path gradients off the plain path: "
                             f"{name} {worst} or cost {cost_k} vs {cost_p}")


# ------------------------------------------------------------ phase 13
def phase_lstm_infer(spec, trainer):
    """paddle.infer of the classifier's probabilities over 512 seeded
    ragged samples in batches of 128, float32, from the trained table:
    one forward launch per batch, none with residuals; probabilities
    within 1e-4 of the CPU port's on the same table and samples."""
    from paddle_tpu_torch import config
    from paddle_tpu_torch.ops import fused_rnn as fr
    from paddle_tpu_torch.trainer import Parameters, infer

    config.init(seed=0, compute_dtype="float32")
    samples = [(w,) for w, _ in _lstm_samples(512, seed=13, ragged=True)]
    params = trainer.parameters
    infer(output_layer=spec.output, parameters=params, input=samples[:128],
          batch_size=128)                                      # warm-up
    torch.cuda.synchronize()
    _rnn_counts(fr, zero=True)
    t0 = time.perf_counter()
    probs = infer(output_layer=spec.output, parameters=params, input=samples,
                  batch_size=128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _rnn_counts(fr)
    if counts["lstm_fwd"] != 4 or counts["lstm_res"] or \
            counts["lstm_bwd"] or \
            counts["lstm_fwd_routes"] != {"sm90": 0, "bf16x3": 4}:
        raise AssertionError(f"infer launches {counts}: expected 4 float32 "
                             "(bf16x3) forward launches without residuals")
    cpu = Parameters({k: v.detach().cpu() for k, v in params.raw.items()},
                     device="cpu")
    want = infer(output_layer=spec.output, parameters=cpu, input=samples,
                 batch_size=128, device="cpu")
    err = float(np.abs(probs - want).max())
    if probs.shape != (512, LSTM_NET["num_classes"]) or not err <= 1e-4:
        raise AssertionError(f"card probabilities {probs.shape} off the CPU "
                             f"port's by {err}")
    log(f"lstm infer: 512 samples in 4 batches, {wall * 1e3:.3f} ms, "
        f"{512 / wall:.1f} samples/s, launches {counts}, max |p - p_cpu| "
        f"{err:.3e}")
    return counts


# ------------------------------------------------------------ phase 14
def _tagger_sentences(n, seed):
    """n seeded (words, labels) sentences of 8-64 tokens; every group of
    64 holds a 64-token one, so each infer batch pads to 64."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        L = 64 if i % 64 == 0 else int(rng.randint(8, 65))
        out.append((rng.randint(0, TAGGER["vocab_size"], (L,)).astype(np.int32),
                    rng.randint(0, TAGGER["num_labels"], (L,))
                    .astype(np.int32)))
    return out


def phase_tagger():
    """rnn_crf_tagger at its defaults: 3 float32 train steps on 64
    sentences (the plain GRU scans under autograd, no kernel launch),
    then infer of the Viterbi path over 256 sentences in batches of 64:
    one GRU kernel launch per batch (forward direction only), labels
    identical to the CPU port's on the same table."""
    from paddle_tpu_torch import config
    from paddle_tpu_torch.core.registry import reset_name_counters
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.models import rnn_crf_tagger
    from paddle_tpu_torch.ops import fused_rnn as fr
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import SGD, Parameters, create, infer

    config.init(seed=0, compute_dtype="float32")
    reset_name_counters()
    spec = rnn_crf_tagger(**TAGGER)
    topo = Topology(spec.cost, extra_outputs=[spec.decoded])
    params = create(topo, torch.Generator().manual_seed(2))
    trainer = SGD(spec.cost, params, Adam(learning_rate=2e-3))
    _rnn_counts(fr, zero=True)
    train = _tagger_sentences(64, seed=20)
    losses = [trainer.train_batch(train)[0] for _ in range(3)]
    if not all(np.isfinite(losses)) or _rnn_counts(fr)["gru_fwd"]:
        raise AssertionError(f"tagger training: losses {losses}, GRU kernel "
                             f"launches {_rnn_counts(fr)['gru_fwd']} (the "
                             "training path runs the plain scan)")
    words = [(w,) for w, _ in _tagger_sentences(256, seed=21)]
    infer(output_layer=spec.decoded, parameters=params, input=words[:64],
          batch_size=64)                                       # warm-up
    torch.cuda.synchronize()
    _rnn_counts(fr, zero=True)
    t0 = time.perf_counter()
    paths = infer(output_layer=spec.decoded, parameters=params, input=words,
                  batch_size=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _rnn_counts(fr)
    if counts["gru_fwd"] != 4 or counts["gru_fwd_routes"]["sm90"] != 4:
        raise AssertionError(f"GRU kernel launches {counts['gru_fwd']} (by "
                             f"route {counts['gru_fwd_routes']}) != 4 infer "
                             "batches on the sm90 route")
    cpu = Parameters({k: v.detach().cpu() for k, v in params.raw.items()},
                     device="cpu")
    want = infer(output_layer=spec.decoded, parameters=cpu, input=words,
                 batch_size=64, device="cpu")
    if paths.shape != want.shape or not np.array_equal(paths, want):
        n_diff = int((paths != want).sum()) if paths.shape == want.shape \
            else -1
        raise AssertionError(f"decoded labels differ from the CPU port's "
                             f"({n_diff} positions)")
    log(f"tagger: losses {[round(x, 4) for x in losses]}; infer 256 "
        f"sentences in 4 batches, {wall * 1e3:.3f} ms, {256 / wall:.1f} "
        f"sentences/s (with the cooperative GRU kernel, PERF.md: 137.598 "
        f"ms), GRU launches {counts['gru_fwd']} "
        f"(by route {counts['gru_fwd_routes']}), labels identical to the "
        "CPU port's")
    # where the decode's time goes: one 64-sentence infer batch traced
    n = _trace(lambda: infer(output_layer=spec.decoded, parameters=params,
                             input=words[:64], batch_size=64),
               "tagger decode", "1 infer batch of 64 sentences",
               "GRU kernels", ("gru_fwd_sm90_kernel", "gru_fwd_kernel"),
               launched=lambda: fr.gru_forward.launches)
    if n != 1:
        raise AssertionError(f"the traced infer batch made {n} GRU kernel "
                             "launches, not 1")
    return counts["gru_fwd"]


# ------------------------------------------------------------ phase 15
def _rnn_bound(kind, dtype, b, h, T, lens, route=None):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    (each input read once, each output written once) at 3.35 TB/s and
    its products on the valid row-steps at the route's peak: the LSTM
    forward 2 * h * 4h flops a row-step (h @ W), the backward the same
    (dz W^T), the GRU 2 * h * 3h (two products); bf16 at the tensor
    cores' 989 TFLOP/s, float32 at the SIMT units' 67, and the float32
    kernels' "bf16x3" route as three bf16 passes at 989."""
    e = 2 if dtype == torch.bfloat16 else 4
    valid = float(sum(lens))
    lens_b = 4 * b
    if kind == "lstm_fwd":        # the training call, with residuals
        flops = 2.0 * h * 4 * h * valid
        nbytes = (b * T * 4 * h * e + h * 4 * h * e + 7 * h * 4 + lens_b
                  + 2 * b * T * h * e + b * T * 4 * h * e + 2 * b * h * 4)
    elif kind == "lstm_bwd":
        flops = 2.0 * h * 4 * h * valid
        nbytes = (h * 4 * h * e + 3 * h * 4 + lens_b + b * T * 4 * h * e
                  + 2 * b * T * h * e + 2 * b * h * 4 + b * T * 4 * h * e)
    else:
        flops = 2.0 * h * 3 * h * valid
        nbytes = (b * T * 3 * h * e + h * 3 * h * e + 3 * h * 4 + lens_b
                  + b * T * h * 4 + b * h * 4)
    if route == "bf16x3":
        t_ops = 3 * flops / BF16_FLOPS_PER_S
    else:
        t_ops = flops / (BF16_FLOPS_PER_S if e == 2 else FP32_FLOPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def phase_rnn_timings():
    """Each recurrent kernel's device time per call at the main path's
    shapes — the LSTM at the train batch (b 128, h 1280, T 128 padded,
    every row 100 tokens), the GRU at a tagger infer batch (b 64, h 128,
    T 64, ragged 8-64) — in bfloat16 and float32, by CUDA-graph replay
    (the kernels' cooperative launches capture like any other), its
    bound, its time per run step, and the plain version's time. No
    PyTorch call computes
    these functions (cuDNN's LSTM has no peepholes and no per-row
    freeze, its GRU resets after the product), so library_ms is null."""
    from paddle_tpu_torch.ops import fused_rnn as fr
    out = {}
    shapes = {"lstm": (128, 1280, 128, [LSTM_TOKENS] * 128)}
    glens = [len(w) for w, _ in _tagger_sentences(64, seed=21)]
    shapes["gru"] = (64, 128, 64, glens)
    for dtype in (torch.bfloat16, torch.float32):
        b, h, T, lens = shapes["lstm"]
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        x4, w, bias, peep = _rnn_inputs(b, h, T, 4, dtype, 170)
        _, _, _, cseq, gates = fr.lstm_forward(x4, ln, w, bias, peep,
                                               save_res=True)
        d_out = _randn(torch.Generator(device="cuda").manual_seed(171), b,
                       T, h, dtype=dtype)
        dhT = torch.zeros((b, h), device="cuda")
        calls = {
            "lstm_fwd": (lambda i: fr.lstm_forward(x4, ln, w, bias, peep,
                                                   save_res=True),
                         lambda i: fr.lstm_reference(x4, ln, w, bias, peep,
                                                     save_res=True),
                         shapes["lstm"]),
            "lstm_bwd": (lambda i: fr.lstm_backward(w, peep, ln, gates, cseq,
                                                    d_out, dhT, dhT),
                         lambda i: fr.lstm_backward_reference(
                             w, peep, ln, gates, cseq, d_out, dhT, dhT),
                         shapes["lstm"])}
        x3, gln, gw, gbias = _gru_tagger_inputs(dtype)
        calls["gru_fwd"] = (lambda i: fr.gru_forward(x3, gln, gw, gbias),
                            lambda i: fr.gru_reference(x3, gln, gw, gbias),
                            shapes["gru"])
        _gru_timings(x3, gln, gw, gbias)
        if dtype == torch.float32:
            _gru_route_timings()
        if dtype == torch.bfloat16:
            # the per-step floors of the tensor-core kernels' plan: their
            # steps without their product, and their grid barriers alone;
            # then the ring depth swept (2, 3, 4 stages of 16 KB), which
            # tells the L2 stream's bandwidth from its latency
            steps = max(shapes["lstm"][3])
            sm90 = {
                "lstm_fwd": lambda m, st: fr.lstm_fwd_sm90_launch(
                    x4, ln, w, bias, peep, True, mode=m, stages=st),
                "lstm_bwd": lambda m, st: fr.lstm_bwd_sm90_launch(
                    w, peep, ln, gates, cseq, d_out, dhT, dhT, mode=m,
                    stages=st)}
            for name, launch in sm90.items():
                floor = {m: device_ms(lambda i, m=m: launch(m, 0), iters=3,
                                      reps=3) for m in (1, 2)}
                log(f"{name} bf16 (sm90) floors: steps without the product "
                    f"{floor[1] * 1e3:.2f} us/call "
                    f"({floor[1] / steps * 1e3:.3f} us/step), grid barriers "
                    f"alone {floor[2] * 1e3:.2f} us/call "
                    f"({floor[2] / steps * 1e3:.3f} us/step)")
                sweep = {st: device_ms(lambda i, st=st: launch(0, st),
                                       iters=3, reps=3) for st in (2, 3, 4)}
                log(f"{name} bf16 (sm90) ring sweep: " + ", ".join(
                    f"{st} stages {ms * 1e3:.2f} us/call "
                    f"({ms / steps * 1e3:.3f} us/step)"
                    for st, ms in sweep.items()))
        if dtype == torch.float32:
            _bf16x3_timings(x4, ln, w, bias, peep)
            _bf16x3_bwd_timings(w, peep, ln, gates, cseq, d_out, dhT)
        for name, (kern, plain, (b_, h_, T_, lens_)) in calls.items():
            ms = device_ms(kern, iters=3, reps=3)
            plain_ms = device_ms(plain, iters=1, reps=3)
            route = {"lstm_fwd": fr.lstm_fwd_route,
                     "lstm_bwd": fr.lstm_bwd_route}.get(name)
            route = route(dtype) if route else None
            bound_ms, bound_by = _rnn_bound(name, dtype, b_, h_, T_, lens_,
                                            route)
            steps = max(lens_)
            out[(name, dtype)] = dict(ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=None)
            simt = ""
            if route == "bf16x3":
                simt_ms = _rnn_bound(name, dtype, b_, h_, T_, lens_)[0]
                simt = (f", SIMT float32 floor {simt_ms * 1e3:.3f} us (67 "
                        "TFLOP/s; no bound for this route)")
            log(f"{name} {str(dtype)[6:]} at b{b_} h{h_} T{T_} ({steps} run "
                f"steps): {ms * 1e3:.2f} us/call ({ms / steps * 1e3:.2f} "
                f"us/step), bound {bound_ms * 1e3:.3f} us ({bound_by}"
                f"{', route ' + route if route else ''}){simt}, plain "
                f"{plain_ms * 1e3:.2f} us")
            if ms < bound_ms:
                raise AssertionError(f"{name} {dtype}: {ms} ms reads under "
                                     f"its bound {bound_ms} ms")
        # a labelled near-yardstick the port never calls: cuDNN's LSTM
        # layer (no peepholes, no per-row freeze, and its input
        # projection included) forward over the same 128 x 100 steps
        cudnn = torch.nn.LSTM(LSTM_NET["emb_size"], LSTM_NET["hidden_size"],
                              batch_first=True).to("cuda", dtype)
        xe = torch.randn(128, LSTM_TOKENS, LSTM_NET["emb_size"],
                         device="cuda", dtype=dtype)
        what = (f"near-yardstick torch.nn.LSTM (cuDNN) forward "
                f"{str(dtype)[6:]} b128 T{LSTM_TOKENS} in "
                f"{LSTM_NET['emb_size']} h{LSTM_NET['hidden_size']}")
        with torch.no_grad():
            if dtype == torch.bfloat16:
                log(f"{what}: {_us(event_ms(lambda i: cudnn(xe), iters=5))}")
            else:
                # the float32 call blocks the host past any spin: the sum
                # of its kernels' device time instead, with and without
                # TF32 in cuDNN
                keep = torch.backends.cudnn.allow_tf32
                try:
                    for tf32 in (False, True):
                        torch.backends.cudnn.allow_tf32 = tf32
                        log(f"{what}, cudnn.allow_tf32 {tf32}: "
                            f"{_us(profiler_ms(lambda i: cudnn(xe), 5))} "
                            "(its kernels' device time, torch.profiler)")
                finally:
                    torch.backends.cudnn.allow_tf32 = keep
        del x4, w, cseq, gates, d_out, x3, gw, cudnn, xe
    return out


def _bf16x3_timings(x4, lens, w, bias, peep):
    """The float32 forward's own numbers at phase 15's shapes: its floors
    (lstm_fwd_bf16x3_launch mode 1: the steps without the product, 2:
    the grid barriers alone, 3: the loads of h's two planes alone, 4:
    the steps with the products but without the h stream), its
    ring depth swept (8 and 4 k-steps of fragments in registers), each
    depth held against the plain version first, and the call without
    residuals (phase 13's). Gates past the longest row are 0 by the
    kernel's contract (the plain version computes them from the frozen
    state; the backward reads no gate of an invalid step): they are held
    to 0, the run steps' gates to the plain version."""
    from paddle_tpu_torch.ops import fused_rnn as fr
    steps = int(lens.max())
    ref = fr.lstm_reference(x4, lens, w, bias, peep, save_res=True)

    def launch(mode, stages, res=True):
        return fr.lstm_fwd_bf16x3_launch(x4, lens, w, bias, peep, res,
                                         mode=mode, stages=stages)

    def line(what, ms):
        return (f"{what} {ms * 1e3:.2f} us/call ({ms / steps * 1e3:.3f} "
                "us/step)")

    floor = {m: device_ms(lambda i, m=m: launch(m, 0), iters=3, reps=3)
             for m in (1, 2, 3, 4)}
    log("lstm_fwd float32 (bf16x3) floors: "
        + line("steps without the product", floor[1]) + ", "
        + line("grid barriers alone", floor[2]) + ", "
        + line("the h stream alone", floor[3]) + ", "
        + line("the steps without the h stream", floor[4]))
    sweep = {}
    for st in fr._X3_RINGS:
        got = launch(0, st)
        torch.cuda.synchronize()
        for name, g, r in zip(("out", "hT", "cT", "cseq"), got, ref):
            _held(f"bf16x3 ring {st} {name}", g, r, torch.float32)
        _held(f"bf16x3 ring {st} gates", got[4][:, :steps],
              ref[4][:, :steps], torch.float32)
        if got[4][:, steps:].abs().max().item() != 0:
            raise AssertionError(f"bf16x3 ring {st}: gates past the longest "
                                 "row are not 0")
        sweep[st] = device_ms(lambda i, st=st: launch(0, st), iters=3, reps=3)
    log("lstm_fwd float32 (bf16x3) ring sweep: " + ", ".join(
        line(f"{st} k-steps", ms) for st, ms in sweep.items()))
    log("lstm_fwd float32 (bf16x3) " + line(
        "without residuals (the infer call)",
        device_ms(lambda i: launch(0, 0, res=False), iters=3, reps=3)))


def _bf16x3_bwd_timings(w, peep, lens, gates, cseq, d_out, dhT):
    """The float32 backward's own numbers at phase 15's shapes: its
    floors (lstm_bwd_bf16x3_launch mode 1: the steps without the
    product, 2: the grid barriers and group syncs alone, 3: the loads of
    dz's planes alone, 4: the steps with the products but without the dz
    stream; per run step, of which all but the last run a product) and
    its ring depth swept (8 and 4 k-steps of fragments in registers),
    each depth's dz held against the plain version first."""
    from paddle_tpu_torch.ops import fused_rnn as fr
    steps = int(lens.max())
    ref = fr.lstm_backward_reference(w, peep, lens, gates, cseq, d_out, dhT,
                                     dhT)

    def launch(mode, stages):
        return fr.lstm_bwd_bf16x3_launch(w, peep, lens, gates, cseq, d_out,
                                         dhT, dhT, mode=mode, stages=stages)

    def line(what, ms):
        return (f"{what} {ms * 1e3:.2f} us/call ({ms / steps * 1e3:.3f} "
                "us/step)")

    floor = {m: device_ms(lambda i, m=m: launch(m, 0), iters=3, reps=3)
             for m in (1, 2, 3, 4)}
    log("lstm_bwd float32 (bf16x3) floors: "
        + line("steps without the product", floor[1]) + ", "
        + line("grid barriers and group syncs alone", floor[2]) + ", "
        + line("the dz stream alone", floor[3]) + ", "
        + line("the steps without the dz stream", floor[4]))
    sweep = {}
    for st in fr._X3_RINGS:
        got = launch(0, st)
        torch.cuda.synchronize()
        _held(f"bf16x3 bwd ring {st} dz", got, ref, torch.float32)
        sweep[st] = device_ms(lambda i, st=st: launch(0, st), iters=3, reps=3)
    log("lstm_bwd float32 (bf16x3) ring sweep: " + ", ".join(
        line(f"{st} k-steps", ms) for st, ms in sweep.items()))


def profiler_ms(fn, iters):
    """Device milliseconds per call as the sum of the device time of the
    kernels that ``iters`` eager calls launch, under torch.profiler: for
    a call that blocks the host, which events around it would time with
    the card idle. None, "not measured", where the trace holds no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    total_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                   if ev.device_type.name == "CUDA")
    return total_us / 1e3 / iters if total_us > 0 else None


def _gru_tagger_inputs(dtype):
    """(x3, lens, w, bias) of one tagger infer batch: b 64, h 128, T 64,
    the lengths of phase 14's first 64 sentences."""
    glens = [len(w) for w, _ in _tagger_sentences(64, seed=21)]
    lens = torch.tensor(glens, dtype=torch.int32, device="cuda")
    x3, w, bias, _ = _rnn_inputs(64, TAGGER["hidden_size"], 64, 3, dtype,
                                 172)
    return x3, lens, w, bias


def _gru_timings(x3, lens, w, bias):
    """At one tagger infer batch: the cooperative kernel (gru_fwd.cu, the
    tagger's route before the sm90 kernel) through the same timing lines,
    so before and after come from one card; then the sm90 kernel's
    floors at the plan (mode 1: launch and the weight load; mode 2: the
    steps without their products) and its cluster sizes swept (n 1, 2,
    4, 8), each held against the plain version first."""
    from paddle_tpu_torch.ops import fused_rnn as fr
    b, T, three_h = x3.shape
    h, dt = three_h // 3, str(w.dtype)[6:]
    steps = int(lens.max())
    plan = fr.gru_fwd_plan(b, h, w.dtype, _sms())

    def line(what, ms):
        return (f"{what} {ms * 1e3:.2f} us/call ({ms / steps * 1e3:.3f} "
                f"us/step)")

    coop = device_ms(lambda i: fr.gru_fwd_coop_launch(x3, lens, w, bias),
                     iters=3, reps=3)
    log(f"gru_fwd {dt} at b{b} h{h} T{T} ({steps} run steps): "
        + line("cooperative gru_fwd.cu (the earlier route)", coop))
    floors = {m: device_ms(lambda i, m=m: fr.gru_fwd_sm90_launch(
        x3, lens, w, bias, plan, mode=m), iters=3, reps=3) for m in (1, 2)}
    log(f"gru_fwd {dt} (sm90, plan {plan}) floors: "
        + line("launch and the weight load", floors[1]) + ", "
        + line("steps without the products", floors[2]))
    sweep = _gru_sweep(x3, lens, w, bias, [(n, 0) for n in (1, 2, 4, 8)])
    log(f"gru_fwd {dt} (sm90) cluster sweep (plan n {plan.cluster}): "
        + ", ".join(line(f"n {n}", ms) for (n, _), ms in sweep.items()))


def _gru_sweep(x3, lens, w, bias, forced):
    """{(n, R): device ms} of the sm90 kernel on each plan forced to
    cluster n and R rows (0: the plan's rule) that holds the weight,
    each held against the plain version first; keyed by the plan's own
    (n, R)."""
    from paddle_tpu_torch.ops import fused_rnn as fr
    b, _, three_h = x3.shape
    ref_out, ref_hT = fr.gru_reference(x3, lens, w, bias)
    times = {}
    for n, r in forced:
        try:
            plan = fr.gru_fwd_plan(b, three_h // 3, w.dtype, _sms(),
                                   cluster=n, rows=r)
        except ValueError:
            continue                # the weight does not fit this plan
        out, hT = fr.gru_fwd_sm90_launch(x3, lens, w, bias, plan)
        torch.cuda.synchronize()
        _held(f"gru n {n} R {plan.rows} out", out, ref_out, w.dtype)
        _held(f"gru n {n} R {plan.rows} hT", hT, ref_hT, w.dtype)
        times[(plan.cluster, plan.rows)] = device_ms(
            lambda i, p=plan: fr.gru_fwd_sm90_launch(x3, lens, w, bias, p),
            iters=3, reps=3)
    return times


# where gru_fwd_plan picks more than one block or more than one batch
# row a cluster, (b, h, dtype): clusters of 2, 4 and 8 at the tagger's
# batch in float32 (h 160, 256, 352) and bfloat16 (h 448), and rows
# a cluster past the SMs' one wave at b 200 and 600
GRU_ROUTE_SHAPES = [(64, 160, torch.float32), (64, 256, torch.float32),
                    (64, 352, torch.float32), (64, 448, torch.bfloat16),
                    (600, 128, torch.float32), (600, 128, torch.bfloat16),
                    (600, 48, torch.float32), (200, 48, torch.float32),
                    (600, 160, torch.float32), (200, 128, torch.float32)]


def _gru_route_timings():
    """At each of GRU_ROUTE_SHAPES (T 64, tagger sentence lengths): the
    sm90 kernel on every cluster size and rows a cluster that holds the
    weight (_gru_sweep) and the cooperative kernel, so that the plan's
    choice is timed against each alternative; prints the fastest."""
    from paddle_tpu_torch.ops import fused_rnn as fr
    grid = [(n, r) for n in fr._GRU_CLUSTERS for r in fr._GRU_ROWS]
    for b, h, dtype in GRU_ROUTE_SHAPES:
        lens = torch.tensor([len(s) for s, _ in _tagger_sentences(b, 21)],
                            dtype=torch.int32, device="cuda")
        x3, w, bias, _ = _rnn_inputs(b, h, 64, 3, dtype, 173)
        plan = fr.gru_fwd_plan(b, h, dtype, _sms())
        times = _gru_sweep(x3, lens, w, bias, grid)
        times["coop"] = device_ms(
            lambda i: fr.gru_fwd_coop_launch(x3, lens, w, bias), iters=3,
            reps=3)
        mine = times["coop" if plan.route == "coop" else
                     (plan.cluster, plan.rows)]
        best = min(times, key=times.get)
        log(f"gru routes {str(dtype)[6:]} b{b} h{h} T64 (plan {plan.route} "
            f"n {plan.cluster} R {plan.rows}: {mine * 1e3:.2f} us): "
            + ", ".join(f"{'coop' if k == 'coop' else f'n{k[0]} R{k[1]}'} "
                        f"{ms * 1e3:.2f}" for k, ms in times.items())
            + f" us; fastest {best} ({times[best] / mine:.3f} of the "
            "plan's)")
        del x3, w


# ------------------------------------------------------------ phase 17
def _quant_window_case(h, g, W, dtype, seed):
    """Phase 2's full-width window inputs with int8 pools: the float
    pages quantized on the card, q in ``dtype``; a tenth of the rows
    scaled down, so scales differ across rows."""
    from paddle_tpu_torch.ops import paged_decode as ops
    args, tables, lens = _window_case(h, g, W, torch.float32, seed)
    q, k, v, tb, ln = args
    rows = torch.rand(k.shape[:3], device=k.device) < 0.1
    k = torch.where(rows[..., None], k * 0.01, k)
    kq, ks = ops.quantize_kv(k)
    vq, vs = ops.quantize_kv(v)
    return dict(q=q.to(dtype), kq=kq, vq=vq, ks=ks, vs=vs, tb=tb, ln=ln,
                k=k, v=v), tables, lens


def phase_dequant_vs_plain():
    """Kernel 8 (the int8 path of paged window attention) against its
    plain version at full width: q float32 and bfloat16, h/g 8/8, 8/2,
    8/1, W 1, 3 and 4, ragged lengths straddling pages; NaN scales in
    every page past each slot's used count change nothing; a kv_len-0
    row returns the mean of dequantized V over the used pages; and
    quantize_kv on the card is bit-equal to the CPU port's."""
    from paddle_tpu_torch.ops import paged_decode as ops
    worst = 0.0
    for (h, g) in ((8, 8), (8, 2), (8, 1)):
        for W in (1, 3, 4):
            for dtype in (torch.float32, torch.bfloat16):
                a, tables, lens = _quant_window_case(h, g, W, dtype,
                                                     seed=h * 10 + g + W)
                kw = dict(k_scales=a["ks"], v_scales=a["vs"])
                got = ops.paged_window_attention(a["q"], a["kq"], a["vq"],
                                                 a["tb"], a["ln"], **kw)
                torch.cuda.synchronize()
                want = ops.paged_window_reference(
                    a["q"].float(), a["kq"], a["vq"], a["tb"], a["ln"], **kw)
                err = (got.float() - want).abs().max().item()
                if dtype == torch.float32:
                    torch.testing.assert_close(got, want, **F32_TOL)
                    worst = max(worst, err)
                elif err > BF16_ATOL:
                    raise AssertionError(
                        f"bf16 int8 kernel off by {err} > {BF16_ATOL}")
                # allocated-pages contract: the scales of pages past each
                # slot's used count are never read — poison them
                P = tables.shape[1]
                used = np.clip(-(-lens.max(axis=1) // PAGE), 1, P)
                tail = np.concatenate([tables[s, used[s]:]
                                       for s in range(SLOTS)])
                tail = torch.from_numpy(tail[tail > 0].astype(np.int64))
                ks, vs = a["ks"].clone(), a["vs"].clone()
                ks[tail.cuda()] = float("nan")
                vs[tail.cuda()] = float("nan")
                again = ops.paged_window_attention(
                    a["q"], a["kq"], a["vq"], a["tb"], a["ln"],
                    k_scales=ks, v_scales=vs)
                torch.cuda.synchronize()
                if not torch.equal(again, got):
                    raise AssertionError("int8 kernel read a page or scale "
                                         "past a slot's used count")
                _check_corrupt_entry(
                    lambda tb: ops.paged_window_attention(
                        a["q"], a["kq"], a["vq"], tb, a["ln"], **kw),
                    a["tb"], lens, got)
                zero_err = _check_zero_len_row_int8(ops, a, tables, lens,
                                                    dtype)
                log(f"int8 kernel vs plain h={h} g={g} W={W} "
                    f"{str(dtype)[6:]}: max_abs_err {err:.3e}, kv_len-0 "
                    f"row {zero_err:.3e}")
    k = torch.randn(SLOTS * 34 + 1, PAGE, 8, 64, device="cuda") * \
        torch.rand(SLOTS * 34 + 1, PAGE, 8, 1, device="cuda") * 10
    gq, gs = ops.quantize_kv(k)
    cq, cs = ops.quantize_kv(k.cpu())
    if not (torch.equal(gq.cpu(), cq) and torch.equal(gs.cpu(), cs)):
        raise AssertionError(
            f"quantize_kv on the card differs from the CPU port's: "
            f"{int((gq.cpu() != cq).sum())} values, "
            f"{int((gs.cpu() != cs).sum())} scales")
    log(f"quantize_kv: {k.numel()} values bit-equal to the CPU port's")
    return worst


def _check_zero_len_row_int8(ops, a, tables, lens, dtype):
    """Window token 0 of slot 2 with kv_len 0: the mean of dequantized
    V over every column of the slot's used pages (the TPU kernel's
    value); the other rows unchanged."""
    s = 2
    lens0 = lens.copy()
    lens0[s, 0] = 0
    ln = torch.from_numpy(lens0).to(a["ln"].device)
    kw = dict(k_scales=a["ks"], v_scales=a["vs"])
    got = ops.paged_window_attention(a["q"], a["kq"], a["vq"], a["tb"], ln,
                                     **kw)
    torch.cuda.synchronize()
    h, g = a["q"].shape[2], a["vq"].shape[2]
    used = min(max(-(-int(lens0[s].max()) // PAGE), 1), tables.shape[1])
    pages = torch.from_numpy(tables[s, :used].astype(np.int64)).cuda()
    vdq = ops.dequantize_kv(a["vq"][pages], a["vs"][pages])
    want = vdq.reshape(-1, g, vdq.shape[-1]).mean(dim=0) \
        .repeat_interleave(h // g, dim=0)
    err = (got[s, 0].float() - want).abs().max().item()
    if err > (F32_TOL["atol"] if dtype == torch.float32 else BF16_ATOL):
        raise AssertionError(f"int8 kv_len-0 row off the mean of V by {err}")
    keep = torch.ones(got.shape[:2], dtype=torch.bool, device=got.device)
    keep[s, 0] = False
    rest = ops.paged_window_reference(a["q"].float(), a["kq"], a["vq"],
                                      a["tb"], ln, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(got[keep], rest[keep], **F32_TOL)
    elif (got[keep].float() - rest[keep]).abs().max() > BF16_ATOL:
        raise AssertionError("an int8 kv_len-0 row changed the other rows")
    return err


# ------------------------------------------------------------ phase 18
DECODE_T = FULL["max_len"]
DECODE_LENS = [544, 1, 17, 100, 255, 256, 0, 513]


# cache widths whose rows are not 16-byte aligned: the kernel copies
# them in 8-byte (float32 542), 4-byte (float32 541, bfloat16 542)
# pieces and element by element (bfloat16 541)
DECODE_ODD_T = (541, 542)


def _decode_case(g, dtype, seed, T=DECODE_T):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h, dh = FULL["n_heads"], 64
    q = torch.randn(SLOTS, h, dh, generator=gen, device="cuda")
    k = torch.randn(SLOTS, g, dh, T, generator=gen, device="cuda")
    v = torch.randn(SLOTS, g, dh, T, generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _decode_check(ops, q, k, v, lens, label):
    """One decode_attention call against decode_reference on the same
    values (float32 F32_TOL, bfloat16 BF16_ATOL); each kv_len-0 row
    also against the mean of its V over T. Returns the max error."""
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = ops.decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    want = ops.decode_reference(q.float(), k.float(), v.float(), ln)
    err = (got.float() - want).abs().max().item()
    rep = q.shape[1] // k.shape[1]
    for i, n in enumerate(lens):
        if n == 0:
            mean_v = v[i].float().mean(dim=-1).repeat_interleave(rep, dim=0)
            zerr = (got[i].float() - mean_v).abs().max().item()
            limit = F32_TOL["atol"] if q.dtype == torch.float32 else \
                BF16_ATOL
            if zerr > limit:
                raise AssertionError(f"decode kernel {label}: kv_len-0 row "
                                     f"{i} off the mean of V by {zerr}")
    if q.dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32_TOL)
    elif err > BF16_ATOL:
        raise AssertionError(f"bf16 decode kernel {label} off by {err}")
    log(f"decode kernel vs plain {label}: max_abs_err {err:.3e}")
    return err


def _engine_page_view(eng, lens, seed):
    """Tables over the engine's real pools for rows of the given
    lengths: out-of-order pages, null pages past each row's use."""
    k_pool = eng.k_pool["q"] if isinstance(eng.k_pool, dict) else eng.k_pool
    L, n_pages, ps = k_pool.shape[:3]
    P = FULL["max_len"] // ps
    used = -(-np.asarray(lens) // ps)
    rng = np.random.RandomState(seed)
    tables = np.zeros((len(lens), P), np.int32)
    pages = rng.permutation(n_pages - 1) + 1
    at = 0
    for s, u in enumerate(used):
        tables[s, :u] = pages[at:at + u]
        at += u
    return torch.from_numpy(tables).cuda(), \
        torch.tensor(lens, dtype=torch.int32, device="cuda")


def phase_decode_vs_plain(eng):
    """Kernel 9 (dense-cache decode attention) against decode_reference
    at b 8, h 8, g 8/2/1, dh 64, T 544, one shared length and per-row
    lengths (a kv_len-0 row among them, also held against the mean of
    V; rows of 544, 513 and 256 span several chunks, so the merge runs),
    float32 and bfloat16; at g 2 also caches of T 541 and 542, whose
    rows are not 16-byte aligned. Then the op route
    paged_attention(use_kernel=True) against use_kernel=False over the
    phase 3 engine's pools (layer 0 and 5, float32), and every arrival
    counter of the merge back at 0. Returns the worst float32 error and
    decode_attention.launches, which counts these calls (no engine
    route reaches the kernel)."""
    from paddle_tpu_torch.ops import paged_decode as ops
    ops.decode_attention.launches = 0
    worst = 0.0
    for g in (8, 2, 1):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _decode_case(g, dtype, seed=180 + g)
            for lens in ([300], DECODE_LENS):
                err = _decode_check(
                    ops, q, k, v, lens, f"g={g} {str(dtype)[6:]} "
                    f"{'shared' if len(lens) == 1 else 'per-row'} lengths")
                if dtype == torch.float32:
                    worst = max(worst, err)
    for T in DECODE_ODD_T:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _decode_case(2, dtype, seed=T, T=T)
            err = _decode_check(ops, q, k, v, DECODE_LENS,
                                f"g=2 {str(dtype)[6:]} T={T}")
            if dtype == torch.float32:
                worst = max(worst, err)
    lens = [len(p) + n for p, n in zip(eng["prompts"][:SLOTS],
                                       eng["news"][:SLOTS])]
    tb, ln = _engine_page_view(eng["eng"], lens, seed=181)
    q = torch.randn(SLOTS, FULL["n_heads"], 64, device="cuda")
    for layer in (0, FULL["n_layers"] - 1):
        kp, vp = eng["eng"].k_pool[layer], eng["eng"].v_pool[layer]
        ker = ops.paged_attention(q, kp, vp, tb, ln, use_kernel=True)
        ein = ops.paged_attention(q, kp, vp, tb, ln)
        torch.cuda.synchronize()
        torch.testing.assert_close(ker, ein, **F32_TOL)
        worst = max(worst, (ker - ein).abs().max().item())
    _check_counters_zero("decode")
    log(f"paged_attention(use_kernel=True) vs einsum over the engine's "
        f"pages (lens {lens}): held; arrival counters at 0; decode "
        f"launches {ops.decode_attention.launches}")
    return worst, ops.decode_attention.launches


# ------------------------------------------------------------ phase 19
def _serve(eng, prompts, news, timeout=600):
    """Submit every request, run the engine to the end, check each
    finished with its tokens and balanced pages; returns (requests,
    wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, n) for p, n in zip(prompts, news)]
    eng.run(timeout=timeout)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    if st["step_failures"]:
        raise AssertionError(f"{st['step_failures']} step failures: "
                             f"{eng.last_step_error}")
    for i, (r, n) in enumerate(zip(reqs, news)):
        toks = r.get(timeout=1)
        if r.state != "done" or len(toks) != n:
            raise AssertionError(f"request {i}: state {r.state}, "
                                 f"{len(toks)}/{n} tokens")
    acc = eng.page_accounting()
    if acc["leaked"] or acc["free"] + acc["held_by_trie"] != \
            acc["total_usable"] or acc["refs_total"] != \
            acc["held_by_slots"] + acc["held_by_trie"]:
        raise AssertionError(f"page accounting unbalanced: {acc}")
    if eng.spill is not None and acc["spill_puts"] != (
            acc["spill_restores"] + acc["spill_evicted_lru"]
            + acc["spill_dropped_integrity"] + acc["spill_cleared"]
            + acc["spilled"]):
        raise AssertionError(f"spill tier not conserved: {acc}")
    return reqs, wall


def _first_divergence(a, b):
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


def phase_int8_engine(serve):
    """The int8 engine at full width: phase 3's 16 requests with
    kv_quant="int8". Kernel 8 launches == steps x 6 and kernel 7 none;
    balanced pages; the first 4 requests' tokens agree (tie rule) with
    the CPU port's int8 engine on the same table, the near-tie
    reference being the CPU int8 paged step's teacher-forced logits.
    Prints how many requests match the float engine token for token."""
    from paddle_tpu_torch.models.decode import (TransformerDecoder,
                                                tokens_agree)
    from paddle_tpu_torch.ops import paged_decode as ops
    from paddle_tpu_torch.params import init_transformer_lm_params
    from paddle_tpu_torch.serving import DecodeEngine

    prompts, news = serve["prompts"], serve["news"]
    kw = dict(num_slots=SLOTS, page_size=PAGE, max_seq_len=FULL["max_len"],
              kv_quant="int8")
    eng = DecodeEngine(serve["dec"], **kw)
    eng.warmup()
    torch.cuda.synchronize()
    ops.paged_window_attention.launches = 0
    ops.paged_window_attention.dequant_launches = 0
    reqs, wall = _serve(eng, prompts, news)
    launches = ops.paged_window_attention.dequant_launches
    float_launches = ops.paged_window_attention.launches
    st = eng.stats()
    if launches != st["steps"] * FULL["n_layers"] or launches == 0 or \
            float_launches:
        raise AssertionError(
            f"int8 launches {launches} (float {float_launches}) != steps "
            f"{st['steps']} x {FULL['n_layers']}")
    cpu_dec = TransformerDecoder(init_transformer_lm_params(FULL, seed=0),
                                 n_layers=FULL["n_layers"],
                                 n_heads=FULL["n_heads"], device="cpu")
    cpu = DecodeEngine(cpu_dec, **kw)
    cpu_reqs = [cpu.submit(p, n) for p, n in zip(prompts[:4], news[:4])]
    cpu.run(timeout=600)
    ref_step = cpu_dec.paged(num_slots=1, page_size=PAGE, num_pages=36,
                             max_pages_per_slot=FULL["max_len"] // PAGE,
                             window=32, kv_quant="int8")
    for i, r in enumerate(cpu_reqs):
        want = r.get(timeout=1)
        p = prompts[i]
        ref = ref_step.prefill_logits(np.concatenate([p, want]))
        tol = TIE_ATOL + TIE_RTOL * float(np.abs(ref).max())
        if not tokens_agree(reqs[i].get(timeout=1), want, ref[len(p) - 1:],
                            tol):
            raise AssertionError(f"int8 request {i}: card tokens differ "
                                 "from the CPU port's int8 engine")
    same = 0
    firsts = []
    for r, fp in zip(reqs, serve["tokens"]):
        j = _first_divergence(r.get(timeout=1), fp)
        same += j is None
        firsts.append(j)
    gen = st["tokens_out"]
    log(f"int8 engine: {N_REQ} requests, {gen} tokens, {st['steps']} "
        f"steps, {wall:.3f} s, {gen / wall:.1f} tokens/s (float engine "
        f"{serve['tokens_per_s']:.1f}), p50 inter-token "
        f"{st['token_latency_p50_ms']} ms, int8 kernel launches {launches}, "
        f"pool {eng.paged.pool_bytes()} bytes (float "
        f"{serve['pool_bytes']}); 4 requests agree with the "
        f"CPU port's int8 engine")
    log(f"int8 vs float engine: {same}/{N_REQ} requests token-identical; "
        f"first divergence per request {firsts} (random-weight logits "
        "are near-flat: a finding, not a gate)")
    return eng, launches


# ------------------------------------------------------------ phase 20
def phase_speculation(serve):
    """Speculative decoding at full width, spec_k 2 (W 3): the
    same-weights draft, then a disagreeing 2-layer draft from another
    seed. Tokens agree with the dense reference (tie rule, first 4
    requests), kernel 7 launches == target steps x 6, same-weights
    tokens per step > 1."""
    from paddle_tpu_torch.models.decode import TransformerDecoder
    from paddle_tpu_torch.ops import paged_decode as ops
    from paddle_tpu_torch.params import init_transformer_lm_params
    from paddle_tpu_torch.serving import DecodeEngine

    small = dict(FULL, n_layers=2)
    drafts = {"same-weights": serve["dec"],
              "disagreeing 2-layer": TransformerDecoder(
                  init_transformer_lm_params(small, seed=1), n_layers=2,
                  n_heads=FULL["n_heads"])}
    out = {}
    for label, draft in drafts.items():
        eng = DecodeEngine(serve["dec"], num_slots=SLOTS, page_size=PAGE,
                           max_seq_len=FULL["max_len"], draft=draft,
                           spec_k=SPEC_K)
        eng.warmup()
        torch.cuda.synchronize()
        ops.paged_window_attention.launches = 0
        reqs, wall = _serve(eng, serve["prompts"], serve["news"])
        st = eng.stats()
        launches = ops.paged_window_attention.launches
        if launches != st["steps"] * FULL["n_layers"]:
            raise AssertionError(f"{label}: kernel 7 launches {launches} != "
                                 f"target steps {st['steps']} x "
                                 f"{FULL['n_layers']}")
        _check_dense(reqs, serve["dense"], f"speculative ({label})")
        per_step = st["tokens_out"] / st["steps"]
        if label == "same-weights" and per_step <= 1.0:
            raise AssertionError(f"same-weights draft: {per_step} tokens "
                                 "per step")
        gen = st["tokens_out"]
        out[label] = dict(tokens_per_s=gen / wall, per_step=per_step)
        log(f"speculation ({label} draft, spec_k {SPEC_K}): {gen} tokens, "
            f"{st['steps']} target steps, {per_step:.3f} tokens/step, "
            f"accepted {st['spec_accepted_tokens']} of "
            f"{st['spec_proposed_tokens']} proposed, {wall:.3f} s, "
            f"{gen / wall:.1f} tokens/s (phase 3: "
            f"{serve['tokens_per_s']:.1f}), kernel 7 launches {launches}")
        del eng
    return out


# ------------------------------------------------------------ phase 21
# 72 usable pages (phase 3 serves with 272): wave B alone fills them,
# so every trie page of wave A has to leave the device
SPILL_PAGES_POOL = 73
SPILL_CAPACITY = 256


def _spill_waves(seed):
    """Two waves of 8 prompts: within a wave the prompts share a
    32-token (two-page) prefix and differ after it; wave A 64 tokens
    (+16 new: 5 pages a request), wave B 96 tokens (+48 new: 9 pages
    a request, 72 in all — every cold page of A spills host-ward);
    wave C then revisits A's prompts."""
    rng = np.random.RandomState(seed)
    waves = []
    for length in (64, 96):
        shared = rng.randint(0, FULL["vocab_size"], 32)
        waves.append([np.concatenate([shared, rng.randint(
            0, FULL["vocab_size"], length - 32)]).astype(np.int32)
            for _ in range(SLOTS)])
    return waves


def phase_two_tier(serve):
    """int8 pages + host spill + speculation at full width on a pool
    cut to 72 pages with a 256-page spill store: wave A, wave B (cold
    A pages spill host-ward), wave C revisits A (spilled pages restore
    before prefill). spills > 0, restores > 0, revisit tokens equal
    first-visit tokens, both tiers balance. Returns the engine (phase
    22 traces it)."""
    from paddle_tpu_torch.serving import DecodeEngine
    eng = DecodeEngine(serve["dec"], num_slots=SLOTS, page_size=PAGE,
                       max_seq_len=FULL["max_len"],
                       num_pages=SPILL_PAGES_POOL, kv_quant="int8",
                       kv_spill_pages=SPILL_CAPACITY, draft=serve["dec"],
                       spec_k=SPEC_K)
    eng.warmup()
    wave_a, wave_b = _spill_waves(seed=210)
    first, wall_a = _serve(eng, wave_a, [16] * SLOTS)
    _, wall_b = _serve(eng, wave_b, [48] * SLOTS)
    spilled = eng.stats()["kv_pages_spilled"]
    again, wall_c = _serve(eng, wave_a, [16] * SLOTS)
    st = eng.stats()
    acc = eng.page_accounting()
    if not (spilled > 0 and st["kv_pages_restored"] > 0):
        raise AssertionError(f"no spill round trip: spilled {spilled}, "
                             f"restored {st['kv_pages_restored']}")
    for i, (a, b) in enumerate(zip(first, again)):
        if a.get(timeout=1) != b.get(timeout=1):
            raise AssertionError(f"revisit {i}: tokens differ from the "
                                 "first visit")
    hits = sum(r.prefix_hit_pages for r in again)
    log(f"two-tier: pool {SPILL_PAGES_POOL - 1} pages + spill "
        f"{SPILL_CAPACITY}, int8, spec_k {SPEC_K}: spilled "
        f"{st['kv_pages_spilled']}, restored {st['kv_pages_restored']}, "
        f"integrity drops {st['kv_spill_integrity_drops']}, revisit prefix "
        f"hit pages {hits}; waves {wall_a:.3f} / {wall_b:.3f} / "
        f"{wall_c:.3f} s; revisit tokens identical; accounting {acc}")
    return eng


# ------------------------------------------------------------ phase 22
def _int8_timing(int8_eng, tb, lens, W, dtype):
    """Kernel 8 at the int8 engine's shapes: the phase 19 pools, the
    first 8 requests at their final lengths, W tokens, q of
    ``dtype``."""
    k_pool, v_pool = int8_eng.k_pool, int8_eng.v_pool
    L, _, _, _, dh = k_pool["q"].shape
    q = torch.randn(SLOTS, W, FULL["n_heads"], dh, device="cuda").to(dtype)
    layers = [(k_pool["q"][i], v_pool["q"][i], k_pool["s"][i],
               v_pool["s"][i]) for i in range(L)]
    return _window_timing(f"int8 kernel at engine shapes W={W} "
                          f"{str(dtype)[6:]} q", q, layers, tb,
                          _window_lens(lens, W))


# full context: every slot at max_len (34 pages), pool sets enough to
# exceed the 50 MB L2 (6 float32 sets: 107 MB of K/V; 16 int8 sets:
# 76 MB with scales)
FULL_CONTEXT_SETS = {"float32": 6, "int8": 16}
CHUNK_SWEEP = (1, 2, 4, 8)


def phase_full_context_timings(engine_lens):
    """Both window kernels at full context: 8 slots of 544 tokens (34
    pages each, out of order over a 273-page pool), h 8, g 8, dh 64,
    float32 q; float32 pages and int8 pages, W 1 and 3, on seeded
    random pools. Then, on the same pools, the chunk plan swept: device
    time per call with C = 1, 2, 4 and 8 pages a block at the engine's
    lengths and at full context, each held against the plain version
    first. Keyed by (kind, W)."""
    from paddle_tpu_torch.ops import paged_decode as ops
    h, dh = FULL["n_heads"], 64
    P = FULL["max_len"] // PAGE
    n_pages = SLOTS * P + 1
    rng = np.random.RandomState(230)
    tables = (rng.permutation(n_pages - 1)[:SLOTS * P] + 1) \
        .reshape(SLOTS, P).astype(np.int32)
    tb = torch.from_numpy(tables).cuda()
    full = np.full(SLOTS, FULL["max_len"], np.int32)
    gen = torch.Generator(device="cuda").manual_seed(230)
    out = {}
    for kind, n_sets in FULL_CONTEXT_SETS.items():
        layers = []
        for _ in range(n_sets):
            k, v = (torch.randn(n_pages, PAGE, h, dh, generator=gen,
                                device="cuda") for _ in range(2))
            if kind == "int8":
                (kq, ks), (vq, vs) = ops.quantize_kv(k), ops.quantize_kv(v)
                layers.append((kq, vq, ks, vs))
            else:
                layers.append((k, v, None, None))
        for W in (1, SPEC_K + 1):
            q = torch.randn(SLOTS, W, h, dh, generator=gen, device="cuda")
            out[(kind, W)] = _window_timing(
                f"{kind} pages at full context W={W}", q, layers, tb,
                _window_lens(full, W))
        for label, lens in (("engine lengths", engine_lens),
                            ("full context", full)):
            for W in (1, SPEC_K + 1):
                ln = _window_lens(lens, W)
                q = torch.randn(SLOTS, W, h, dh, generator=gen,
                                device="cuda")
                want = ops.paged_window_reference(
                    q, *layers[0][:2], tb, ln, k_scales=layers[0][2],
                    v_scales=layers[0][3])
                row = []
                for C in CHUNK_SWEEP:
                    def call(i, C=C):
                        k, v, ks, vs = layers[i % len(layers)]
                        return ops.paged_window_launch(
                            q, k, v, tb, ln, k_scales=ks, v_scales=vs,
                            chunk_pages=C)
                    torch.testing.assert_close(call(0), want, **F32_TOL)
                    row.append(f"C {C}: {device_ms(call, 60) * 1e3:.2f}")
                log(f"chunk sweep, {kind} pages at {label} W={W}: "
                    + ", ".join(row) + " us/call")
        del layers
    return out


def _decode_bound(g, dtype, lens):
    """(bound_ms, bound_by) of kernel 9 on this run's lengths: a row
    with kv_len > 0 needs its first kv_len columns of K and V (later
    columns weigh exactly 0); a kv_len-0 row needs all T of V (its
    output is their mean) and no K. Plus q, out and the lengths."""
    h, dh, e = FULL["n_heads"], 64, torch.finfo(dtype).bits // 8
    live = [min(int(n), DECODE_T) if n > 0 else 0 for n in lens]
    vcols = [n if n > 0 else DECODE_T for n in live]
    nbytes = (sum(live) + sum(vcols)) * g * dh * e + \
        2 * SLOTS * h * dh * e + len(lens) * 4
    flops = 2.0 * h * dh * (sum(live) + sum(vcols))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOPS_PER_S if e == 2 else FP32_FLOPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations", nbytes


# the decode kernel's columns a block, swept: one warp's worth, two,
# four and the whole T (no split; the plan cuts it to what fits)
DECODE_CHUNK_SWEEP = (32, 64, 128, DECODE_T)
# the kernel's floors, decode_launch modes in the order a launch runs:
# it returns at once, stops after the tile loads, the scores, P.V, and
# before the merge
DECODE_FLOORS = {"launch": 5, "tile loads": 1, "scores": 3, "P.V": 4,
                 "no merge": 2}
# cache sets cycled in a timing: at least this many bytes of K and V,
# past the 50 MB L2 (the full-context calls read every column)
DECODE_POOL_BYTES = 100e6


def _decode_timing(lens, dtype, g=FULL["n_heads"], label="engine lengths"):
    """Kernel 9 at b 8, h 8, g, dh 64, T 544 with the given per-row
    lengths, q and cache of ``dtype``, cycling over seeded cache sets
    of DECODE_POOL_BYTES together: device time per call by CUDA-graph
    replay, its bound, the plain version's time, SDPA on [b, h, 1, T];
    the kernel's floors (DECODE_FLOORS); and the chunk plan swept
    (DECODE_CHUNK_SWEEP columns a block, each held against the plain
    version first)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import paged_decode as ops
    h, dh = FULL["n_heads"], 64
    esize = torch.finfo(dtype).bits // 8
    n_sets = int(min(64, max(6, -(-DECODE_POOL_BYTES // (
        2 * SLOTS * g * dh * DECODE_T * esize)))))
    sets = [_decode_case(g, dtype, seed=230 + i) for i in range(n_sets)]
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")

    def dkernel(i):
        q, k, v = sets[i % n_sets]
        return ops.decode_attention(q, k, v, ln)

    def dplain(i):
        q, k, v = sets[i % n_sets]
        return ops.decode_reference(q, k, v, ln)

    def dlaunch(i, **kw):
        q, k, v = sets[i % n_sets]
        return ops.decode_launch(q, k, v, ln, **kw)

    ms = device_ms(dkernel, iters=60)
    plain_ms = device_ms(dplain, iters=12)
    floors = [device_ms(functools.partial(dlaunch, mode=m), iters=60)
              for m in DECODE_FLOORS.values()]
    sq = [q[:, :, None, :] for q, _, _ in sets]           # [b, h, 1, dh]
    sk = [k.transpose(2, 3) for _, k, _ in sets]           # [b, g, T, dh]
    sv = [v.transpose(2, 3) for _, _, v in sets]
    dmask = (torch.arange(DECODE_T, device="cuda")[None, :]
             < ln[:, None])[:, None, None, :]
    gqa = {} if g == h else {"enable_gqa": True}

    def dsdpa(i):
        return F.scaled_dot_product_attention(
            sq[i % n_sets], sk[i % n_sets], sv[i % n_sets], attn_mask=dmask,
            **gqa)

    want = dplain(0)
    got = dsdpa(0)[:, :, 0]
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32_TOL)
    elif (got.float() - want.float()).abs().max().item() > BF16_ATOL:
        raise AssertionError("bf16 SDPA yardstick off the decode plain path")
    library_ms = device_ms(dsdpa, iters=60)
    sweep = []
    for C in DECODE_CHUNK_SWEEP:
        plan = ops.decode_plan(SLOTS, h, g, dh, DECODE_T, esize, C)
        got = dlaunch(0, chunk_cols=C)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **F32_TOL)
        elif (got.float() - want.float()).abs().max().item() > BF16_ATOL:
            raise AssertionError(f"bf16 decode kernel at C {C} off the "
                                 "plain path")
        t = device_ms(functools.partial(dlaunch, chunk_cols=C), iters=60)
        sweep.append(f"C {C} ({plan.cols} columns, {plan.n_chunks} "
                     f"chunks): {t * 1e3:.2f}")
    bound_ms, bound_by, nbytes = _decode_bound(g, dtype, lens)
    plan = ops.decode_plan(SLOTS, h, g, dh, DECODE_T, esize)
    log(f"decode kernel at b{SLOTS} h{h} g{g} dh{dh} T{DECODE_T} "
        f"{str(dtype)[6:]} at {label} (lens {list(lens)}; {n_sets} cache "
        f"sets; C {plan.cols}, {plan.n_chunks} chunks): {ms * 1e3:.2f} "
        f"us/call, bound {bound_ms * 1e3:.3f} us ({bound_by}, {nbytes} "
        f"bytes), plain {plain_ms * 1e3:.2f} us, sdpa "
        f"{library_ms * 1e3:.2f} us; floors: "
        + ", ".join(f"{name} {t * 1e3:.2f}"
                    for name, t in zip(DECODE_FLOORS, floors)) + " us")
    log(f"decode chunk sweep, g{g} {str(dtype)[6:]} at {label}: "
        + ", ".join(sweep) + " us/call")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_two_tier_timings(int8_eng, serve):
    """Kernel 8 at the int8 engine's shapes (W 1 and W 3) and kernel 9
    at b 8, h 8, dh 64, T 544 over the same 8 lengths (g 8 and 1) and
    at full context (every row 544; g 8 and 1), each with float32 and
    bfloat16 q (kernel 9's cache in q's dtype); keyed by (kernel, W or
    None, dtype) for the engine's shapes, ("decode", label, dtype, g)
    otherwise."""
    lens = np.array([len(p) + n for p, n in
                     zip(serve["prompts"][:SLOTS], serve["news"][:SLOTS])],
                    np.int32)
    tb, _ = _engine_page_view(int8_eng, lens, seed=220)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for W in (1, SPEC_K + 1):
            out[("int8", W, dtype)] = _int8_timing(int8_eng, tb, lens, W,
                                                   dtype)
        out[("decode", None, dtype)] = _decode_timing(lens.tolist(), dtype)
        out[("decode", "engine lengths", dtype, 1)] = _decode_timing(
            lens.tolist(), dtype, g=1)
        for g in (FULL["n_heads"], 1):
            out[("decode", "full context", dtype, g)] = _decode_timing(
                [DECODE_T] * SLOTS, dtype, g=g, label="full context")
    return out


def phase_two_tier_trace(eng):
    """8 fresh requests through the int8 + speculative (+ spill)
    engine under torch.profiler: device busy against the wall clock,
    the top device ops, the int8 kernel's share."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(222)
    steps0 = eng.stats()["steps"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reqs = [eng.submit(rng.randint(0, FULL["vocab_size"], (32,)), 16)
                for _ in range(SLOTS)]
        eng.run(timeout=600)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for r in reqs:
        r.get(timeout=1)
    steps = eng.stats()["steps"] - steps0
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA" and ev.self_device_time_total > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + \
                ev.self_device_time_total / 1e3
    busy_ms = sum(by_kernel.values())
    int8_ms = sum(v for k, v in by_kernel.items() if "paged_window" in k)
    log(f"two-tier trace: {steps} target steps, wall {wall_ms:.3f} ms "
        f"({wall_ms / steps:.3f} ms/step), device busy {busy_ms:.3f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f}), paged window kernel "
        f"{int8_ms:.3f} ms")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"two-tier trace top op: {ms:.3f} ms  {name[:90]}")


# ------------------------------------------------------------ phase 26
# The v2 scripts demo/mnist/train.py and demo/sequence_tagging/train.py,
# copied with only their imports changed: ``paddle`` is the package the
# caller passes (paddle_tpu_torch here; the CPU tests pass the JAX
# package too, to run the same script in both). The arguments stand in
# for the scripts' command lines; ``init_tar`` makes a parity run start
# from one weight tar, and ``num_batches_per_pass`` cuts a run short.
# Each returns what it printed, as numbers, with the trainer and its
# readers.
MNIST_PASSES, MNIST_BATCH, MNIST_STEP_CHECK = 2, 128, 16
MNIST_CPU_RTOL = 1e-4


def mnist_v2_demo(paddle, use_tpu=None, num_passes=5, batch_size=128,
                  output="./mnist_output", init_tar=None,
                  num_batches_per_pass=None, echo=print):
    import io
    import os

    paddle.init(use_tpu=use_tpu, trainer_count=1, seed=42)

    # -- network: 784 -> 128 -> 64 -> softmax(10) (the classic MLP config)
    img = paddle.layer.data("pixel", paddle.data_type.dense_vector(784))
    h1 = paddle.layer.fc(img, size=128, act=paddle.activation.Relu())
    h2 = paddle.layer.fc(h1, size=64, act=paddle.activation.Relu())
    out = paddle.layer.fc(h2, size=10, act=paddle.activation.Softmax(),
                          name="output")
    lbl = paddle.layer.data("label", paddle.data_type.integer_value(10))
    cost = paddle.layer.classification_cost(out, lbl, name="cost")
    err = paddle.layer.classification_error(out, lbl, name="error")

    parameters = paddle.create_parameters(paddle.Topology(cost))
    if init_tar is not None:
        parameters = paddle.Parameters.from_tar(io.BytesIO(init_tar))
    buf = io.BytesIO()
    parameters.to_tar(buf)
    optimizer = paddle.optimizer.Momentum(
        learning_rate=0.1 / batch_size, momentum=0.9,
        regularization=paddle.optimizer.L2Regularization(5e-4))
    trainer = paddle.SGD(cost=cost, parameters=parameters,
                         update_equation=optimizer, extra_layers=[err])
    costs, pass_s, passes = [], {}, []

    def event_handler(e):
        if isinstance(e, paddle.event.BeginPass):
            pass_s[e.pass_id] = time.perf_counter()
        if isinstance(e, paddle.event.EndIteration):
            costs.append(e.cost)
        if isinstance(e, paddle.event.EndIteration) and e.batch_id % 16 == 0:
            echo(f"pass {e.pass_id} batch {e.batch_id} "
                 f"cost {e.cost:.4f} {e.evaluator}")
        if isinstance(e, paddle.event.EndPass):
            pass_s[e.pass_id] = time.perf_counter() - pass_s[e.pass_id]
            passes.append(dict(e.metrics))
            echo(f"== pass {e.pass_id} done: {e.evaluator}")

    train_reader = paddle.reader.batch(
        paddle.reader.shuffle(paddle.dataset.mnist.train(), 8192, seed=1),
        batch_size, drop_last=True)
    trainer.train(train_reader, num_passes=num_passes,
                  event_handler=event_handler,
                  num_batches_per_pass=num_batches_per_pass)

    result = trainer.test(paddle.reader.batch(paddle.dataset.mnist.test(),
                                              batch_size))
    echo(f"test cost {result.cost:.4f} {result.evaluator}")

    trainer.save_pass(output, num_passes - 1)
    echo(f"saved checkpoint under {output}")

    # inference round-trip through the saved checkpoint
    ckpt = os.path.join(output, f"pass-{num_passes - 1:05d}",
                        "params.tar")
    with open(ckpt, "rb") as f:
        loaded = paddle.Parameters.from_tar(f)
    samples = [(s[0],) for _, s in zip(range(8),
                                       paddle.dataset.mnist.test()())]
    probs = paddle.infer(output_layer=out, parameters=loaded, input=samples,
                         feeding={"pixel": 0})
    echo(f"inference probs shape: {probs.shape} argmax: "
         f"{probs.argmax(-1).tolist()}")
    return dict(costs=costs, passes=passes, pass_s=pass_s,
                test_cost=result.cost, test_metrics=dict(result.metrics),
                probs=probs, ckpt=ckpt, init_tar=buf.getvalue(),
                trainer=trainer, train_reader=train_reader, out=out,
                samples=samples)


def tagging_v2_demo(paddle, use_tpu=None, num_passes=2, batch_size=16,
                    init_tar=None, num_batches_per_pass=None, echo=print):
    import importlib
    import io
    evaluator = importlib.import_module(paddle.__name__ + ".evaluator")
    conll05 = importlib.import_module(paddle.__name__ + ".dataset.conll05")
    rnn_crf_tagger = importlib.import_module(
        paddle.__name__ + ".models.tagger").rnn_crf_tagger

    paddle.init(use_tpu=use_tpu, seed=11)

    model = rnn_crf_tagger(vocab_size=conll05.word_dict_len(),
                           num_labels=conll05.label_dict_len(),
                           emb_size=64, hidden_size=128)
    parameters = paddle.create_parameters(paddle.Topology(model.cost))
    if init_tar is not None:
        parameters = paddle.Parameters.from_tar(io.BytesIO(init_tar))
    buf = io.BytesIO()
    parameters.to_tar(buf)
    optimizer = paddle.optimizer.Adam(learning_rate=2e-3)
    # chunk-F1 over the decoded path, IOB with the conll05 label layout
    chunk = evaluator.chunk(model.decoded, model.label, chunk_scheme="IOB",
                            num_chunk_types=(conll05.label_dict_len() - 2) // 2,
                            name="chunk_f1")
    trainer = paddle.SGD(cost=model.cost, parameters=parameters,
                         update_equation=optimizer, evaluators=[chunk])

    # conll05 rows: (word, pred, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
    # mark, label) — the tagger uses the word and label columns
    feeding = {"words": 0, "labels": 8}
    costs, passes = [], []

    def handler(e):
        if isinstance(e, paddle.event.EndIteration):
            costs.append(e.cost)
        if isinstance(e, paddle.event.EndIteration) and e.batch_id % 20 == 0:
            echo(f"pass {e.pass_id} batch {e.batch_id} cost {e.cost:.4f}")
        if isinstance(e, paddle.event.EndPass):
            passes.append(dict(e.metrics))
            echo(f"== pass {e.pass_id}: {e.evaluator}")

    reader = paddle.reader.batch(
        paddle.reader.shuffle(conll05.test(), 1024, seed=3),
        batch_size, drop_last=True)
    trainer.train(reader, num_passes=num_passes, event_handler=handler,
                  feeding=feeding, num_batches_per_pass=num_batches_per_pass)

    test_reader = paddle.reader.batch(conll05.test(), batch_size)
    result = trainer.test(test_reader, feeding=feeding)
    echo(f"test: cost {result.cost:.4f} {result.evaluator}")
    return dict(costs=costs, passes=passes, test_cost=result.cost,
                test_metrics=dict(result.metrics), init_tar=buf.getvalue(),
                trainer=trainer, model=model, feeding=feeding,
                test_reader=test_reader, chunk=chunk)


MNIST_OUT = "mnist_output"     # the demo's own output directory


def _quiet(msg):
    pass


def phase_mnist_v2():
    """Phase 26: the port copy of demo/mnist/train.py on the card at its
    own width (784-128-64-10, batch 128, float32, Momentum(0.1/128,
    0.9, L2 5e-4), the synthetic 8192/1024 set, shuffle(8192, seed=1),
    2 passes), through the v2 entry points: the first 16 per-step costs
    within 1e-4 relative of the port's CPU run from the same init tar
    on the same batches, a finite test cost and classification error,
    the saved pass reloaded with from_tar and inferred on 8 samples.
    Prints step_ms (train_batch: 8 calls after 2 warm-ups, the method
    of phase 7) and samples/s over the second SGD.train pass, reader
    and feeder included."""
    import os

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.registry import reset_name_counters
    card = nvidia_smi_line()
    lines = []
    reset_name_counters()      # one set of layer names for both runs
    r = mnist_v2_demo(paddle, use_tpu=None, num_passes=MNIST_PASSES,
                      batch_size=MNIST_BATCH,
                      output=os.path.join(MNIST_OUT, "card"),
                      echo=lines.append)
    trainer = r["trainer"]
    if trainer.device.type != "cuda":
        raise AssertionError(f"the v2 script trained on {trainer.device}, "
                             "not the card")
    n_steps = len(r["costs"])
    if n_steps != MNIST_PASSES * 8192 // MNIST_BATCH or \
            not np.all(np.isfinite(r["costs"])):
        raise AssertionError(f"mnist v2: {n_steps} steps, costs "
                             f"{r['costs'][:4]}...")
    probs = r["probs"]
    if probs.shape != (8, 10) or not np.all(np.isfinite(probs)) or \
            not np.allclose(probs.sum(-1), 1.0, atol=1e-5):
        raise AssertionError(f"mnist v2 infer: probs {probs}")
    err = r["test_metrics"]["error"]
    if not np.isfinite(r["test_cost"]) or not 0.0 <= err <= 1.0:
        raise AssertionError(f"mnist v2 test: cost {r['test_cost']}, "
                             f"error {err}")
    with open(r["ckpt"], "rb") as f:
        loaded = paddle.Parameters.from_tar(f)
    stale = [k for k in trainer.parameters.raw
             if not torch.equal(loaded.raw[k].cpu(),
                                trainer.parameters.raw[k].detach().cpu())]
    if stale:
        raise AssertionError(f"the saved pass differs from the trained "
                             f"parameters: {stale}")
    with open(r["ckpt"], "rb") as f:
        cpu_params = paddle.Parameters.from_tar(f, device="cpu")
    cpu_probs = paddle.infer(output_layer=r["out"], parameters=cpu_params,
                             input=r["samples"], feeding={"pixel": 0},
                             device="cpu")
    probs_err = float(np.abs(probs - cpu_probs).max())
    if probs_err > 1e-5:
        raise AssertionError(f"card infer differs from the CPU port's by "
                             f"{probs_err}")
    samples_s = 8192 / r["pass_s"][1]
    batch = next(iter(r["train_reader"]()))
    for _ in range(2):
        trainer.train_batch(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        trainer.train_batch(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    phase_train_trace(trainer, batch, "mnist v2 train", "GEMM kernels",
                      ("gemm",))
    # the port on the CPU, from the card run's init tar, on the same batches
    reset_name_counters()
    c = mnist_v2_demo(paddle, use_tpu=False, num_passes=1,
                      batch_size=MNIST_BATCH, num_batches_per_pass=16,
                      output=os.path.join(MNIST_OUT, "cpu"),
                      init_tar=r["init_tar"], echo=_quiet)
    got = np.asarray(r["costs"][:MNIST_STEP_CHECK])
    want = np.asarray(c["costs"][:MNIST_STEP_CHECK])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    from paddle_tpu_torch import config
    config.init(seed=0, compute_dtype="float32")      # back to the card
    if len(want) != MNIST_STEP_CHECK or rel > MNIST_CPU_RTOL:
        raise AssertionError(f"mnist v2: card costs {got} against the CPU "
                             f"port's {want}: max rel {rel}")
    for line in lines:
        log(f"mnist v2: {line}")
    log(f"mnist v2 ({card}): {n_steps} steps over {MNIST_PASSES} passes, "
        f"step_ms {step_ms:.3f} (train_batch, 8 after 2 warm-ups), "
        f"{samples_s:.1f} samples/s over pass 1 ({r['pass_s'][1]:.3f} s, "
        f"reader and feeder included); test cost {r['test_cost']:.6f}, "
        f"classification_error {err:.6f}; first {MNIST_STEP_CHECK} costs "
        f"within {rel:.3g} relative of the CPU port's; saved pass reloaded, "
        f"infer argmax {probs.argmax(-1).tolist()} (CPU infer within "
        f"{probs_err:.3g})")
    return dict(step_ms=step_ms, samples_s=samples_s)


# ------------------------------------------------------------ phase 27
TAGGING_TRAIN_BATCHES = 8
TIE_SCORE_RTOL = 1e-4


def _crf_path_score(emis, trans_w, path):
    """The CRF score of one label path (float64): start + emissions +
    transitions + end; trans_w is the (n + 2, n) CRF parameter."""
    start, end, trans = trans_w[0], trans_w[1], trans_w[2:]
    s = start[path[0]] + end[path[-1]] + emis[np.arange(len(path)), path].sum()
    return float(s + trans[path[:-1], path[1:]].sum())


def _tagging_ties(model, trainer, test_reader, feeding, plain_gru):
    """Sentences whose decoded ids differ between the GRU kernel and its
    plain version, each with its two paths' CRF scores under the plain
    route's emissions."""
    from paddle_tpu_torch.trainer import Inference
    from paddle_tpu_torch.ops import fused_rnn as fr
    inf = Inference(output_layer=[model.decoded, model.output],
                    parameters=trainer.parameters, device=trainer.device)
    trans_w = trainer.parameters.raw["_rcrf_trans_w"].detach().cpu() \
        .double().numpy()
    out, sent = [], 0
    for batch in test_reader():
        dec_k, _ = inf.forward_batch(batch, feeding)
        kernel = fr.gru_forward
        fr.gru_forward = plain_gru
        try:
            dec_p, emis = inf.forward_batch(batch, feeding)
        finally:
            fr.gru_forward = kernel
        for i, sample in enumerate(batch):
            n = len(sample[0])
            a, b = dec_k[i, :n], dec_p[i, :n]
            if not np.array_equal(a, b):
                e = emis[i, :n].astype(np.float64)
                out.append((sent + i, _crf_path_score(e, trans_w, a),
                            _crf_path_score(e, trans_w, b)))
        sent += len(batch)
    return out


def phase_tagging_v2():
    """Phase 27: the port copy of demo/sequence_tagging/train.py on the
    card at its own width (rnn_crf_tagger, vocab 44068, 106 labels, emb
    64, hidden 128, batch 16, synthetic conll05, Adam(2e-3), the chunk
    evaluator): 8 training batches, then SGD.test over the 400 test
    sentences. The test sweep runs the GRU forward under no_grad, so
    each of its 25 batches launches gru_fwd_sm90.cu (training runs the
    plain scans and launches none). The chunk F1 must equal the chunk
    evaluator's on the decoded ids of the plain GRU version, run on the
    card with the same parameters; a sentence whose ids differ must be a
    near-tie (its two paths' CRF scores within 1e-4 relative) and is
    reported."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.registry import reset_name_counters
    from paddle_tpu_torch.ops import fused_rnn as fr

    reset_name_counters()
    card = nvidia_smi_line()
    lines = []
    _rnn_counts(fr, zero=True)
    t0 = time.perf_counter()
    r = tagging_v2_demo(paddle, use_tpu=None, num_passes=1,
                        num_batches_per_pass=TAGGING_TRAIN_BATCHES,
                        echo=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _rnn_counts(fr)
    n_test = -(-400 // 16)
    if counts["gru_fwd"] != n_test or \
            counts["gru_fwd_routes"]["sm90"] != n_test:
        raise AssertionError(f"GRU kernel launches {counts['gru_fwd']} (by "
                             f"route {counts['gru_fwd_routes']}) != {n_test} "
                             "test batches on the sm90 route")
    trainer, metrics = r["trainer"], r["test_metrics"]
    f1 = metrics["chunk_f1_f1"]
    if not np.all(np.isfinite(r["costs"])) or not np.isfinite(r["test_cost"]):
        raise AssertionError(f"tagging v2: costs {r['costs']}, test cost "
                             f"{r['test_cost']}")

    def plain_gru(x3, lens, w, bias):
        return fr.gru_reference(x3.float(), lens, w.float(), bias)

    kernel = fr.gru_forward
    fr.gru_forward = plain_gru
    try:
        plain = trainer.test(r["test_reader"], feeding=r["feeding"])
    finally:
        fr.gru_forward = kernel
    if _rnn_counts(fr)["gru_fwd"] != n_test:
        raise AssertionError("the plain GRU run launched the kernel")
    plain_f1 = plain.metrics["chunk_f1_f1"]
    ties = []
    if f1 != plain_f1:
        ties = _tagging_ties(r["model"], trainer, r["test_reader"],
                             r["feeding"], plain_gru)
        far = [t for t in ties if abs(t[1] - t[2]) >
               TIE_SCORE_RTOL * max(1.0, abs(t[2]))]
        if far or not ties:
            raise AssertionError(
                f"tagging v2: chunk F1 {f1} (kernel) != {plain_f1} (plain "
                f"GRU); differing sentences (index, kernel path score, "
                f"plain path score) {ties}, not near-ties {far}")
    for line in lines:
        log(f"tagging v2: {line}")
    log(f"tagging v2 ({card}): {TAGGING_TRAIN_BATCHES} train batches + "
        f"test over 400 sentences in {wall:.3f} s; GRU kernel launches "
        f"{counts['gru_fwd']} (by route {counts['gru_fwd_routes']}), all in "
        f"the test sweep; chunk F1 {f1!r} (kernel) vs {plain_f1!r} (plain "
        f"GRU on the card); near-ties {ties}")
    # where a test batch's time goes
    _trace(lambda: trainer.test(paddle.reader.firstn(r["test_reader"], 1),
                                feeding=r["feeding"]),
           "tagging v2 test", "1 test batch of 16 sentences", "GRU kernels",
           ("gru_fwd_sm90_kernel", "gru_fwd_kernel"),
           launched=lambda: fr.gru_forward.launches)
    from paddle_tpu_torch import config
    config.init(seed=0, compute_dtype="float32")
    return counts["gru_fwd"]


# ------------------------------------------------------------ phase 28
CONV_PASSES, CONV_BATCH, CONV_STEP_CHECK = 100, 128, 16
CONV_CPU_RTOL = 1e-4
CONV_TARGET = 0.98                 # the convergence script's own target


def convergence_cnn(paddle, in_dim=64, drop_rate=0.5):
    """The digits-tier network of demo/mnist/convergence.py: (cost, the
    softmax output, the classification error)."""
    L, act = paddle.layer, paddle.activation
    img = L.data("pixel", paddle.data_type.dense_vector(in_dim),
                 height=8, width=8)
    c1 = L.img_conv(img, filter_size=3, num_filters=32, padding=1,
                    num_channels=1, act=act.Relu())
    c2 = L.img_conv(c1, filter_size=3, num_filters=64, padding=1,
                    act=act.Relu())
    p = L.img_pool(c2, pool_size=2, stride=2)
    h = L.dropout(L.fc(p, size=256, act=act.Relu()), drop_rate)
    out = L.fc(h, size=10, act=act.Softmax())
    lbl = L.data("label", paddle.data_type.integer_value(10))
    cost = L.classification_cost(out, lbl)
    err = L.classification_error(out, lbl, name="error")
    return cost, out, err


# C3D (Tran et al., ICCV 2015, section 3.3 and Fig. 3): eight 3x3x3 convs,
# five max pools (pool1 1x2x2), fc6 and fc7 of 4096, a Sports-1M softmax
C3D = dict(depth=16, height=112, width=112, filters=(64, 128, 256, 256, 512,
                                                     512, 512, 512),
           fc=4096, classes=487)
C3D_POOLS = (1, 2, 4, 6, 8)          # a pool after these convs (1-based)


def c3d_net(paddle, depth, height, width, filters, fc, classes):
    """C3D built with the DSL of ``paddle`` (either package): a flat
    channel-major clip [3 * depth * height * width], 3x3x3 convs with
    padding 1 and ReLU, max pools (pool1 1x2x2 / 1x2x2, the rest 2x2x2
    / 2), fc6 and fc7 with ReLU and a softmax over ``classes``. No
    dropout after fc6 and fc7 (the paper has 0.5): the card's losses
    are held against the CPU port's. Returns (cost, the softmax
    output)."""
    L, act = paddle.layer, paddle.activation
    x = L.data("clip", paddle.data_type.dense_vector(
        3 * depth * height * width))
    c, d, h, w = 3, depth, height, width
    for i, nf in enumerate(filters, 1):
        x = L.img_conv3d(x, filter_size=3, num_filters=nf, input_depth=d,
                         num_channels=c, input_height=h, input_width=w,
                         padding=1, act=act.Relu(), name=f"c3d_conv{i}")
        c = nf
        if i in C3D_POOLS:
            k = [1, 2, 2] if i == 1 else 2
            x = L.img_pool3d(x, pool_size=k, stride=k, input_depth=d,
                             num_channels=c, input_height=h, input_width=w,
                             name=f"c3d_pool{C3D_POOLS.index(i) + 1}")
            h, w = x.meta.height, x.meta.width
            d = x.meta.size // (c * h * w)
    x = L.fc(x, size=fc, act=act.Relu(), name="c3d_fc6")
    x = L.fc(x, size=fc, act=act.Relu(), name="c3d_fc7")
    out = L.fc(x, size=classes, act=act.Softmax(), name="c3d_fc8")
    lbl = L.data("label", paddle.data_type.integer_value(classes))
    return L.classification_cost(out, lbl), out


def ocr_ctc_net(paddle, height, width, hidden, classes):
    """The OCR stack built with the DSL of ``paddle``: a one-channel
    image, 1x1 conv gates (5 x ``hidden``), mdlstm, block_expand into
    one step a column, an fc softmax and a ctc cost (the blank the last
    class). Returns the cost."""
    L, dt = paddle.layer, paddle.data_type
    im = L.data("im", dt.dense_vector(height * width), height=height,
                width=width)
    g = L.img_conv(im, filter_size=1, num_filters=5 * hidden,
                   num_channels=1, name="gates")
    md = L.mdlstm(g, name="md")
    cols = L.block_expand(md, block_x=1, block_y=height, name="cols")
    probs = L.fc(cols, size=classes, act=paddle.activation.Softmax(),
                 name="probs")
    lbl = L.data("lbl", dt.integer_value_sequence(classes))
    return L.ctc(probs, lbl, size=classes, name="ctc_cost")


def speech_ctc_net(paddle, dim, hidden, context, classes):
    """The DeepSpeech2-style stack built with the DSL of ``paddle``: fc
    with ReLU, a lookahead row_conv of ``context`` steps with ReLU, fc
    logits and a warp_ctc cost (blank 0). Returns the cost."""
    L, dt, act = paddle.layer, paddle.data_type, paddle.activation
    x = L.data("audio", dt.dense_vector_sequence(dim))
    h = L.fc(x, size=hidden, act=act.Relu(), name="h1")
    rc = L.row_conv(h, context_len=context, act=act.Relu(), name="rc")
    logits = L.fc(rc, size=classes, name="logits")
    lbl = L.data("lbl", dt.integer_value_sequence(classes))
    return L.warp_ctc(logits, lbl, size=classes, name="ctc_cost")


# SSD300 (Liu et al., ECCV 2016, section 2.2 and Fig. 2; the authors'
# Caffe ssd_pascal.py): the source maps, their priors and heads
SSD_SOURCES = (  # (layer, min size, max size, aspect ratios)
    ("conv4_3_norm", 30, 60, (2.0,)), ("fc7", 60, 111, (2.0, 3.0)),
    ("conv6_2", 111, 162, (2.0, 3.0)), ("conv7_2", 162, 213, (2.0, 3.0)),
    ("conv8_2", 213, 264, (2.0,)), ("conv9_2", 264, 315, (2.0,)))
SSD_VARIANCE = (0.1, 0.1, 0.2, 0.2)
SSD_PRIORS = 8732


def ssd300_net(paddle, size=300, width_div=1, classes=21):
    """SSD300 built with the DSL of ``paddle`` (either package): the
    VGG-16 trunk through conv5_3 (Caffe ceil-mode pools, 75 -> 38 at
    pool3), pool5 3x3 stride 1 pad 1, fc6 a 3x3 conv of 1024 with
    dilation 6, fc7 a 1x1 conv of 1024, the extra layers conv6 to conv9
    (1x1 then 3x3: 256/512 and 128/256 at stride 2, then 128/256 valid
    twice), ``cross_channel_norm`` on conv4_3 (scale 20), and on each of
    the six source maps (38, 19, 10, 5, 3, 1 at 300 x 300) 3x3 loc and
    conf heads and a ``priorbox`` (4, 6, 6, 6, 4, 4 priors a cell; 8,732
    in all), the six concatenated in map order. ``width_div`` divides
    every channel count (a narrow copy for the CPU tests). Two
    departures from Caffe, both the JAX layer's own: priors are always
    clipped to [0, 1], and a map's prior step is image / map (300 / 38),
    not a fixed 8. Returns (multibox_loss cost, detection_output)."""
    L, act = paddle.layer, paddle.activation
    img = L.data("image", paddle.data_type.dense_vector(3 * size * size),
                 height=size, width=size)
    gt = L.data("gt", paddle.data_type.dense_vector_sequence(6))

    def conv(x, name, nf, k=3, stride=1, pad=1, dilation=1, channels=None):
        return L.img_conv(x, filter_size=k, num_filters=max(nf // width_div,
                                                            1),
                          num_channels=channels, stride=stride, padding=pad,
                          dilation=dilation, act=act.Relu(), name=name)

    x, nodes = img, {}
    for block, (nf, n) in enumerate(((64, 2), (128, 2), (256, 3), (512, 3),
                                     (512, 3)), 1):
        for i in range(1, n + 1):
            x = conv(x, f"conv{block}_{i}", nf,
                     channels=3 if x is img else None)
        nodes[f"conv{block}_{n}"] = x
        if block < 5:
            x = L.img_pool(x, pool_size=2, stride=2, name=f"pool{block}")
    x = L.img_pool(x, pool_size=3, stride=1, padding=1, name="pool5")
    x = conv(x, "fc6", 1024, pad=6, dilation=6)
    x = nodes["fc7"] = conv(x, "fc7", 1024, k=1, pad=0)
    for i, (nf1, nf2, stride, pad) in enumerate(
            ((256, 512, 2, 1), (128, 256, 2, 1), (128, 256, 1, 0),
             (128, 256, 1, 0)), 6):
        x = conv(x, f"conv{i}_1", nf1, k=1, pad=0)
        x = nodes[f"conv{i}_2"] = conv(x, f"conv{i}_2", nf2, stride=stride,
                                       pad=pad)
    nodes["conv4_3_norm"] = L.cross_channel_norm(nodes["conv4_3"],
                                                 name="conv4_3_norm")
    locs, confs, priors = [], [], []
    for src, lo, hi, ratios in SSD_SOURCES:
        n_priors = 2 + 2 * len(ratios)
        locs.append(L.img_conv(nodes[src], filter_size=3, padding=1,
                               num_filters=n_priors * 4, name=f"{src}_loc"))
        confs.append(L.img_conv(nodes[src], filter_size=3, padding=1,
                                num_filters=n_priors * classes,
                                name=f"{src}_conf"))
        priors.append(L.priorbox(nodes[src], img, aspect_ratio=ratios,
                                 variance=SSD_VARIANCE, min_size=[lo],
                                 max_size=[hi], name=f"{src}_priorbox"))
    pb = L.concat(priors, name="priorbox")
    cost = L.multibox_loss(locs, confs, pb, gt, num_classes=classes,
                           overlap_threshold=0.5, neg_pos_ratio=3.0,
                           neg_overlap=0.5, name="multibox_loss")
    det = L.detection_output(locs, confs, pb, num_classes=classes,
                             nms_threshold=0.45, nms_top_k=400,
                             keep_top_k=200, confidence_threshold=0.01,
                             name="detection_output")
    return cost, det


def ssd_samples(n, size, classes, seed, max_boxes=8):
    """n seeded synthetic detection samples: a 3 x size x size image
    (flat, channel-major) with 1..max_boxes boxes of random classes
    (1..classes-1) painted in their class's colour over noise, and the
    gt rows (label, xmin, ymin, xmax, ymax, difficult 0) in [0, 1]."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        im = 0.1 * rng.randn(3, size, size).astype(np.float32)
        rows = []
        for _ in range(int(rng.randint(1, max_boxes + 1))):
            c = int(rng.randint(1, classes))
            w, h = rng.uniform(0.1, 0.6, 2)
            x0, y0 = rng.uniform(0.0, 1.0 - w), rng.uniform(0.0, 1.0 - h)
            x1, y1 = x0 + w, y0 + h
            im[:, int(y0 * size):int(y1 * size),
               int(x0 * size):int(x1 * size)] += np.array(
                [c % 3, c % 5, c % 7], np.float32)[:, None, None] / 3.0
            rows.append([c, x0, y0, x1, y1, 0.0])
        out.append((im.reshape(-1), np.asarray(rows, np.float32)))
    return out


def detection_rows_match(got, want, score_tol=1e-6, atol=1e-5):
    """Hold detection_output rows ``got`` against ``want`` ([b, K * 7],
    numpy): image ids and labels identical, scores and boxes within
    ``atol``, row for row. Rows whose scores lie within ``score_tol`` of
    each other (a run of near-ties in ``want``) may come in another
    order: such a run is compared as a set. Returns the count of runs
    that came reordered; raises where the rows differ otherwise."""
    b = want.shape[0]
    got, want = got.reshape(b, -1, 7), want.reshape(b, -1, 7)
    if got.shape != want.shape:
        raise AssertionError(f"detections {got.shape} against {want.shape}")

    def same(g, w):
        return np.array_equal(g[:, :2], w[:, :2]) and \
            np.allclose(g[:, 2:], w[:, 2:], rtol=0.0, atol=atol)

    swaps = 0
    for n in range(b):
        i, k = 0, want.shape[1]
        while i < k:
            j = i + 1
            while j < k and abs(want[n, j, 2] - want[n, j - 1, 2]) <= \
                    score_tol:
                j += 1
            g, w = got[n, i:j], want[n, i:j]
            if not same(g, w):
                key = (lambda r: np.lexsort(r[:, ::-1].T))
                if j - i < 2 or not same(g[key(np.round(g, 4))],
                                         w[key(np.round(w, 4))]):
                    raise AssertionError(
                        f"detections of image {n}, rows {i}..{j - 1}: "
                        f"{g.tolist()} against {w.tolist()}")
                swaps += 1
            i = j
    return swaps


def convergence_demo(paddle, readers, use_tpu=None, num_passes=100,
                     batch_size=128, drop_rate=0.5, init_tar=None,
                     num_batches_per_pass=None):
    """demo/mnist/convergence.py's digits tier with only its imports and
    its data source changed: the package and ``readers`` (a callable
    giving (train reader, test reader, input dim)) come in as arguments.
    ``drop_rate`` 0 is the copy the parity checks run."""
    import io
    paddle.init(use_tpu=use_tpu, seed=42)
    train_reader, test_reader, in_dim = readers()
    cost, out, err = convergence_cnn(paddle, in_dim, drop_rate)

    params = paddle.create_parameters(paddle.Topology(cost))
    if init_tar is not None:
        params = paddle.Parameters.from_tar(io.BytesIO(init_tar))
    buf = io.BytesIO()
    params.to_tar(buf)
    opt = paddle.optimizer.Adam(learning_rate=1e-3)
    trainer = paddle.SGD(cost=cost, parameters=params, update_equation=opt,
                         extra_layers=[err])
    reader = paddle.reader.batch(
        paddle.reader.shuffle(train_reader, 8192, seed=1),
        batch_size, drop_last=True)
    costs = []

    def handler(e):
        if isinstance(e, paddle.event.EndIteration):
            costs.append(e.cost)

    t0 = time.perf_counter()
    trainer.train(reader, num_passes=num_passes, event_handler=handler,
                  num_batches_per_pass=num_batches_per_pass)
    wall = time.perf_counter() - t0
    res = trainer.test(paddle.reader.batch(test_reader, batch_size))
    acc = 1.0 - res.metrics.get("error", 1.0)
    return dict(costs=costs, wall_clock_s=wall, test_accuracy=float(acc),
                test_cost=float(res.cost), trainer=trainer,
                init_tar=buf.getvalue(), out=out)


def phase_convergence():
    """Phase 28: the digits-CNN convergence run on the card — the port
    copy of demo/mnist/convergence.py's digits tier (conv 32 and 64,
    pool, fc 256 with dropout 0.5, Adam(1e-3), init(seed=42), batch
    128, 100 passes over the 1437 training digits of the copy in
    paddle_tpu_torch/dataset/). Gates: test accuracy >= 0.98, the
    script's own target; every cost and parameter finite; the first 16
    step costs of a dropout-0 copy on the card within 1e-4 relative of
    the same copy on the CPU port, from the card run's init tar. cuDNN
    runs its deterministic algorithms for the phase: with its default
    ones the 1100 steps end on another test cost each run, and one
    whole-script run on an H100 ended at accuracy 0.97987, under the
    target; with them five runs ended on one test cost, accuracy
    0.98572."""
    keep = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _phase_convergence()
    finally:
        torch.backends.cudnn.deterministic = keep


def _phase_convergence():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.registry import reset_name_counters
    from paddle_tpu_torch.dataset import digits
    card = nvidia_smi_line()
    reset_name_counters()
    r = convergence_demo(paddle, digits.readers, num_passes=CONV_PASSES,
                         batch_size=CONV_BATCH)
    trainer = r["trainer"]
    if trainer.device.type != "cuda":
        raise AssertionError(f"the convergence run trained on "
                             f"{trainer.device}, not the card")
    n_steps = len(r["costs"])
    n_train = sum(1 for _ in digits.readers()[0]())
    bad = [k for k, v in trainer.parameters.raw.items()
           if not bool(torch.isfinite(v).all())]
    if n_steps != CONV_PASSES * (n_train // CONV_BATCH) or bad or \
            not np.all(np.isfinite(r["costs"])):
        raise AssertionError(f"convergence: {n_steps} steps, non-finite "
                             f"parameters {bad}, costs {r['costs'][:4]}...")
    acc = r["test_accuracy"]
    # the dropout-0 copy, 16 steps on the card and on the CPU port
    got, want = [], []
    for use_tpu, costs in ((None, got), (False, want)):
        reset_name_counters()
        costs += convergence_demo(
            paddle, digits.readers, use_tpu=use_tpu, num_passes=2,
            batch_size=CONV_BATCH, drop_rate=0.0, init_tar=r["init_tar"],
            num_batches_per_pass=CONV_STEP_CHECK // 2)["costs"]
    from paddle_tpu_torch import config
    config.init(seed=0, compute_dtype="float32")      # back to the card
    rel = float(np.max(np.abs(np.asarray(got) - np.asarray(want)) /
                       np.abs(np.asarray(want))))
    if len(got) != CONV_STEP_CHECK or len(want) != CONV_STEP_CHECK or \
            rel > CONV_CPU_RTOL:
        raise AssertionError(f"convergence dropout-0 copy: card costs {got} "
                             f"against the CPU port's {want}: max rel {rel}")
    artifact = {"benchmark": "mnist_convergence", "data": "sklearn-digits",
                "num_passes": CONV_PASSES, "batch_size": CONV_BATCH,
                "wall_clock_s": r["wall_clock_s"], "test_accuracy": acc,
                "test_cost": r["test_cost"],
                "target": "real-data test_accuracy >= 0.98",
                "met": bool(acc >= CONV_TARGET)}
    log(f"convergence ({card}): {json.dumps(artifact)}; {n_steps} steps, "
        f"{r['wall_clock_s'] / n_steps * 1e3:.3f} ms a step (reader and "
        f"feeder included); dropout-0 copy: first {CONV_STEP_CHECK} costs "
        f"within {rel:.3g} relative of the CPU port's")
    if not artifact["met"]:
        raise AssertionError(f"convergence: test accuracy {acc} below the "
                             f"script's target {CONV_TARGET}")
    return artifact


# ------------------------------------------------------------ phase 29
# bench.py:194 bench_image at its resnet50_bs128 row (phase 40 runs its
# googlenet_bs128 row at the same shapes, batch and steps)
RESNET = dict(height=224, width=224, channels=3, num_classes=1000)
RESNET_BATCH, RESNET_WARMUP, RESNET_STEPS = 128, 2, 8
RESNET_CHECK_ROWS = 4
# the card's float32 test-mode forward against the CPU port's on the
# same weights and inputs: probabilities within the tests' forward
# tolerance (cuDNN's and the CPU's convolutions sum in different orders
# over 53 convs; the first card run's largest |diff| was 1.10e-5)
RESNET_PROBS_TOL = dict(rtol=1e-4, atol=1e-5)


def _model_flops(topo):
    """Analytic model FLOPs per sample of one forward pass: 2 x the
    multiply-adds of every conv (2-D and 3-D) and fc (batch norm,
    pooling and the activations, a few percent more, not counted)."""
    flops = 0
    for l in topo.layers:
        if l.type == "conv":
            cfg, m = l.config, l.meta
            flops += 2 * cfg["filter_size"] ** 2 * (
                cfg["_ic"] // cfg.get("groups", 1)) * m.channels * \
                m.height * m.width
        elif l.type in ("conv3d", "deconv3d"):
            # each input (deconv) or output (conv) voxel: k^3 x ic x oc
            cfg = l.config
            k = cfg["filter_size"]
            k = [k] * 3 if isinstance(k, int) else k
            ic, idp, ih, iw = cfg["_in"]
            voxels = idp * ih * iw if l.type == "deconv3d" else \
                l.meta.size // l.meta.channels
            flops += 2 * int(np.prod(k)) * ic * l.meta.channels * voxels
        elif l.type == "fc":
            flops += 2 * sum(p.meta.size for p in l.parents) * l.meta.size
    return flops


def _image_samples(n, seed):
    """bench_image's seeded batch at its 224 x 224 x 3, 1000-class rows."""
    rng = np.random.RandomState(seed)
    dim = RESNET["height"] * RESNET["width"] * RESNET["channels"]
    img = rng.randn(n, dim).astype(np.float32)
    lbl = rng.randint(0, RESNET["num_classes"], n)
    return [(img[i], int(lbl[i])) for i in range(n)]


def _image_train(model, compute_dtype, batch):
    """bench_image's row of ``model`` (resnet50_bs128, googlenet_bs128):
    Momentum(0.01/128, 0.9, L2 0.0005 x 128) on one repeated batch. As
    bench.py's _measure does, the batch goes to the card once and the
    timed steps (2 warm-ups, then 8) are the trainer's step on that
    feed; 8 train_batch calls on the host samples follow, timed apart
    (the feeder and the host copy included). Losses finite and falling,
    parameters finite, and every moving statistic (if the model has
    any) changed, finite and detached. Returns the trainer, the spec,
    the device feed and the step's numbers."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import config, models
    from paddle_tpu_torch.core.registry import reset_name_counters
    config.init(seed=0, compute_dtype=compute_dtype)
    reset_name_counters()
    spec = getattr(models, model)(**RESNET)
    topo = paddle.Topology(spec.cost)
    params = paddle.create_parameters(topo)
    state0 = {k: v.clone() for k, v in params.state.items()}
    trainer = paddle.SGD(
        cost=spec.cost, parameters=params,
        update_equation=paddle.optimizer.Momentum(
            learning_rate=0.01 / RESNET_BATCH, momentum=0.9,
            regularization=paddle.optimizer.L2Regularization(
                0.0005 * RESNET_BATCH)))
    feed = trainer._feeder(None)(batch)
    n_real = int(feed.pop("__batch_size__"))

    def step():
        return trainer._step(feed, n_real, fetch_evals=False)[0]

    losses = [step() for _ in range(RESNET_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        losses.append(step())
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / RESNET_STEPS * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        losses.append(trainer.train_batch(batch)[0])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / RESNET_STEPS * 1e3
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{model} {compute_dtype}: losses not finite "
                             f"and falling on the repeated batch: {losses}")
    bad = [k for k, p in params.raw.items()
           if not bool(torch.isfinite(p).all())]
    state = params.state
    moved = [k for k in state0 if not torch.equal(state[k], state0[k])]
    finite = all(bool(torch.isfinite(v).all()) for v in state.values())
    if bad or len(moved) != len(state0) or not finite or \
            any(v.requires_grad for v in state.values()):
        raise AssertionError(
            f"{model} {compute_dtype}: non-finite parameters {bad}; "
            f"{len(moved)} of {len(state0)} moving statistics changed, "
            f"finite {finite}")
    flops = _model_flops(topo)
    train_flops = 3 * flops
    tflops = train_flops * RESNET_BATCH / (step_ms / 1e3) / 1e12
    log(f"{model} {compute_dtype} ({nvidia_smi_line()}): batch "
        f"{RESNET_BATCH}, feed on the card, {RESNET_STEPS} timed steps "
        f"after {RESNET_WARMUP}: step_ms {step_ms:.3f}, "
        f"{RESNET_BATCH / (step_ms / 1e3):.1f} samples/s; "
        f"{RESNET_STEPS} train_batch calls on the host samples (feeder "
        f"and host copy included): {host_ms:.3f} ms, "
        f"{RESNET_BATCH / (host_ms / 1e3):.1f} samples/s; model FLOPs "
        f"{flops / 1e9:.4f} G a sample forward, {train_flops / 1e9:.4f} G "
        f"trained (forward + 2 x forward for the backward; convs and fc "
        f"only), {tflops:.1f} TFLOP/s at step_ms; peak {peak_gb:.3f} GB; "
        f"losses {[round(x, 5) for x in losses]}; {len(moved)} moving "
        f"statistics changed, all finite")
    return trainer, spec, feed, dict(step_ms=step_ms, host_ms=host_ms,
                                     peak_gb=peak_gb, losses=losses,
                                     tflops=tflops)


def phase_resnet50():
    """Phase 29: ResNet-50 training at bench.py's resnet50_bs128 (224 x
    224 x 3, 1000 classes, batch 128, the bench's Momentum) in bf16, the
    bench's --dtype default, then in float32, the package default (TF32
    off): step_ms and samples/s of the trainer's step on a feed already
    on the card (bench.py's convention) with the train_batch time
    beside it, model TFLOP/s, peak memory; losses finite and falling on
    the repeated batch, every moving statistic changed, finite and
    detached. One bf16 step on the card's feed traced. In float32, the card's
    test-mode forward of 4 samples against the CPU port's on the same
    weights, moving statistics and inputs, and one infer call of 128
    samples timed."""
    import io

    import paddle_tpu_torch as paddle
    torch.backends.cudnn.benchmark = True
    log("resnet50: torch.backends.cudnn.benchmark on (the warm-up steps "
        "absorb cuDNN's autotuning)")
    batch = _image_samples(RESNET_BATCH, 0)
    out = {}
    trainer, _, feed, out["bfloat16"] = _image_train("resnet50", "bfloat16",
                                                     batch)
    _trace(lambda: trainer._step(feed, RESNET_BATCH, fetch_evals=False),
           "resnet50 bf16 train (feed on the card)", "1 step",
           "conv kernels", ("conv", "xmma", "implicit", "cudnn"))
    del trainer, feed
    trainer, spec, _, out["float32"] = _image_train("resnet50", "float32",
                                                    batch)
    params = trainer.parameters
    samples = [(img,) for img, _ in batch]
    paddle.infer(output_layer=spec.output, parameters=params,
                 input=samples, feeding={"image": 0})         # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = paddle.infer(output_layer=spec.output, parameters=params,
                         input=samples, feeding={"image": 0})
    infer_s = time.perf_counter() - t0
    buf = io.BytesIO()
    params.to_tar(buf)
    buf.seek(0)
    cpu_params = paddle.Parameters.from_tar(buf, device="cpu")
    cpu_probs = paddle.infer(output_layer=spec.output, parameters=cpu_params,
                             input=samples[:RESNET_CHECK_ROWS],
                             feeding={"image": 0}, device="cpu")
    diff = np.abs(probs[:RESNET_CHECK_ROWS] - cpu_probs)
    err = float(diff.max())
    held = np.allclose(probs[:RESNET_CHECK_ROWS], cpu_probs,
                       **RESNET_PROBS_TOL)
    if probs.shape != (RESNET_BATCH, RESNET["num_classes"]) or \
            not np.all(np.isfinite(probs)) or not held:
        raise AssertionError(
            f"resnet50 infer: probs {probs.shape}, finite "
            f"{np.all(np.isfinite(probs))}; card against the CPU port's "
            f"on {RESNET_CHECK_ROWS} samples: max |diff| {err}, not within "
            f"{RESNET_PROBS_TOL}")
    log(f"resnet50 float32 infer: {RESNET_BATCH} samples in "
        f"{infer_s * 1e3:.3f} ms ({RESNET_BATCH / infer_s:.1f} samples/s, "
        f"feeder and host copy included); test-mode probs of "
        f"{RESNET_CHECK_ROWS} samples within {err:.3g} of the CPU port's "
        f"(held at {RESNET_PROBS_TOL}, the largest |p| "
        f"{float(np.abs(cpu_probs).max()):.4f})")
    torch.backends.cudnn.benchmark = False
    del trainer, params
    from paddle_tpu_torch import config
    config.init(seed=0, compute_dtype="float32")
    return out


# ------------------------------------------------------------ phase 30
# models/seq2seq.py at its defaults, BASELINE.json's attention NMT
NMT = dict(src_vocab=30000, trg_vocab=30000, emb_size=512, enc_size=512,
           dec_size=512)
NMT_PARAMS = 53193520
NMT_BATCH, NMT_WARMUP, NMT_STEPS, NMT_CPU_STEPS = 64, 2, 8, 4
NMT_CPU_RTOL = 1e-4
NMT_BEAM, NMT_MAX_LEN = 4, 50
NMT_SCORE_TOL = 1e-4
NMT_FEEDING = {"source_words": 0, "target_words": 1, "target_next_words": 2}
NMT_OUT = "nmt_output"          # the inference artifact's directory


def _nmt_batches(n, split="train"):
    """The first n batches of NMT_BATCH pairs of the port's wmt14 reader
    (the synthetic pairs when no WMT-14 files are in DATA_HOME)."""
    from paddle_tpu_torch.dataset import wmt14
    reader = getattr(wmt14, split)(NMT["src_vocab"])
    pairs = [s for _, s in zip(range(n * NMT_BATCH), reader())]
    return [pairs[i * NMT_BATCH:(i + 1) * NMT_BATCH] for i in range(n)]


def _nmt_flops(batch):
    """Model FLOPs of one forward over a batch's valid tokens, 2 a
    multiply-add of every product: each source token through both
    encoder GRUs (input projection and recurrence) and the attention
    projection; each target token through the attention over each valid
    source token (its score and its weighted sum), the decoder's input
    projection, gru_step and the output projection; the boot once a
    sample. A training step is 3 forwards (the backward's two
    products a forward product)."""
    E, H, D, V = (NMT["emb_size"], NMT["enc_size"], NMT["dec_size"],
                  NMT["trg_vocab"])
    f = 0.0
    for src, trg, _ in batch:
        s, t = len(src), len(trg)
        f += s * (2 * (2 * E * 3 * H + 2 * H * 3 * H) + 2 * 2 * H * H)
        f += 2 * H * D
        f += t * (s * (2 * D + 2 * 2 * H) + 2 * (2 * H + E) * 3 * D
                  + 2 * D * 3 * D + 2 * D * V)
    return f


def _same_paths(label, got, want):
    """Beam results as to_list(): token-identical paths and scores within
    NMT_SCORE_TOL x max(1, |score|); returns the largest score gap."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if [p for _, p in g] != [p for _, p in w]:
            raise AssertionError(f"{label}: source {i} paths {g} != {w}")
        for (sg, _), (sw, _) in zip(g, w):
            gap = abs(sg - sw)
            if gap > NMT_SCORE_TOL * max(1.0, abs(sw)):
                raise AssertionError(f"{label}: source {i} score {sg} != "
                                     f"{sw}")
            worst = max(worst, gap)
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} results, {len(want)}")
    return worst


def phase_nmt():
    """Phase 30: the attention NMT at full width — train through SGD on
    the card against the CPU port, decode through beam_search on the
    trained parameters with the encoder's GRU on the cooperative kernel,
    the plain GRU route and the inference artifact compared, and the
    cooperative kernel timed at the decode's shape."""
    import io
    import os

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.registry import reset_name_counters
    from paddle_tpu_torch.models import nmt_attention, nmt_generator
    from paddle_tpu_torch.ops import fused_rnn as fr
    from paddle_tpu_torch.trainer import (DataFeeder, load_inference_model,
                                          save_inference_model)

    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    paddle.init(seed=5)                       # float32, on the card
    reset_name_counters()
    spec = nmt_attention(**NMT)
    topo = paddle.Topology(spec.cost)
    n_params = sum(int(np.prod(ps.shape))
                   for ps in topo.param_specs.values())
    if n_params != NMT_PARAMS:
        raise AssertionError(f"nmt_attention has {n_params} parameters, "
                             f"not {NMT_PARAMS}")
    params = paddle.create_parameters(topo)
    buf = io.BytesIO()
    params.to_tar(buf)
    init_tar = buf.getvalue()

    def sgd(p, device=None):
        return paddle.SGD(cost=spec.cost, parameters=p,
                          update_equation=paddle.optimizer.Adam(
                              learning_rate=1e-3),
                          extra_layers=spec.extra_layers, device=device)

    trainer = sgd(params)
    batches = _nmt_batches(NMT_WARMUP + NMT_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _rnn_counts(fr, zero=True)
    costs, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        costs.append(trainer.train_batch(batch, feeding=NMT_FEEDING)[0])
        times.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if _rnn_counts(fr)["gru_fwd"]:
        raise AssertionError("nmt training launched the GRU kernel (the "
                             "training path runs the plain scans)")
    bad = [k for k, v in params.raw.items()
           if not bool(torch.isfinite(v).all())]
    if not np.all(np.isfinite(costs)) or bad or not costs[-1] < costs[0]:
        raise AssertionError(f"nmt training: costs {costs}, non-finite "
                             f"parameters {bad}")
    timed = times[NMT_WARMUP:]
    step_ms = 1e3 * sum(timed) / len(timed)
    tokens = sum(len(t) for b in batches[NMT_WARMUP:] for _, _, t in b)
    flops = 3 * sum(_nmt_flops(b) for b in batches[NMT_WARMUP:]) / NMT_STEPS
    log(f"nmt train ({card}): nmt_attention {NMT}, {n_params} parameters, "
        f"float32, batch {NMT_BATCH}, Adam(1e-3): costs "
        f"{[round(c, 4) for c in costs]}; step_ms {step_ms:.3f} "
        f"(train_batch, {NMT_STEPS} after {NMT_WARMUP} warm-ups), "
        f"{NMT_BATCH / (step_ms / 1e3):.1f} samples/s, "
        f"{tokens / sum(timed):.1f} target tokens/s; model "
        f"{flops / 1e9:.3f} GFLOP a step (valid tokens, 2 a multiply-add, "
        f"3 forwards a step), {flops / (step_ms / 1e3) / 1e12:.3f} TFLOP/s; "
        f"peak memory {peak_gb:.3f} GB")
    _trace(lambda: trainer.train_batch(batches[-1], feeding=NMT_FEEDING),
           "nmt train", "1 step", "GEMM kernels", ("gemm", "Gemm"))

    # the same 4 steps in the port on the CPU, from the same init tar
    t0 = time.perf_counter()
    cpu = sgd(paddle.Parameters.from_tar(io.BytesIO(init_tar),
                                         device="cpu"), device="cpu")
    want = [cpu.train_batch(b, feeding=NMT_FEEDING)[0]
            for b in batches[:NMT_CPU_STEPS]]
    cpu_s = time.perf_counter() - t0
    got = np.asarray(costs[:NMT_CPU_STEPS])
    rel = float(np.max(np.abs(got - np.asarray(want)) / np.abs(want)))
    if rel > NMT_CPU_RTOL:
        raise AssertionError(f"nmt: card costs {got} against the CPU "
                             f"port's {want}: max rel {rel}")
    log(f"nmt train: first {NMT_CPU_STEPS} costs within {rel:.3g} relative "
        f"of the CPU port's ({want}; {cpu_s:.1f} s on the CPU)")
    del cpu

    # generation on the trained parameters
    reset_name_counters()
    beam = nmt_generator(**NMT, beam_size=NMT_BEAM, max_length=NMT_MAX_LEN)
    gen = paddle.Topology(beam)
    gparams = {k: params.raw[k] for k in gen.param_specs}
    sources = [(s[0],) for s in _nmt_batches(1, "test")[0]]
    feed = DataFeeder(gen.data_type(), {"source_words": 0})(sources)
    feed.pop("__batch_size__")

    def decode(table=gparams, topo=gen):
        outs, _ = topo.forward(table, {}, feed, mode="test")
        return outs[beam.name].to_list()

    decode()                                              # warm-up
    torch.cuda.synchronize()
    _rnn_counts(fr, zero=True)
    t0 = time.perf_counter()
    paths = decode()
    gen_s = time.perf_counter() - t0
    counts = _rnn_counts(fr)
    routes = counts["gru_fwd_routes"]
    if routes["coop"] < 1 or routes["sm90"]:
        raise AssertionError(f"nmt decode: GRU launches by route {routes}, "
                             "not the cooperative gru_fwd.cu")

    def plain_gru(x3, lens, w, bias):
        return fr.gru_reference(x3.float(), lens, w.float(), bias)

    kernel = fr.gru_forward
    fr.gru_forward = plain_gru
    try:
        plain = decode()
    finally:
        fr.gru_forward = kernel
    gap = _same_paths("nmt decode, kernel vs plain GRU", paths, plain)

    # the encoder's forward GRU at the decode's shape, kernel vs plain
    enc = paddle.Topology(gen.by_name["enc_fw_transform"])
    with torch.no_grad():
        x3seq = enc.forward(gparams, {}, feed, mode="test")[0][
            "enc_fw_transform"]
    x3 = x3seq.data.float().contiguous()
    lens = x3seq.lengths.to(torch.int32).contiguous()
    w = params.raw["_enc_fw.w0"].detach().float().contiguous()
    bias = params.raw["_enc_fw.wbias"].detach().float().contiguous()
    b, T, three_h = x3.shape
    h = three_h // 3
    plan = fr.gru_fwd_plan(b, h, torch.float32, _sms())
    out, hT = fr.gru_forward(x3, lens, w, bias)
    ref_out, ref_hT = fr.gru_reference(x3, lens, w, bias)
    torch.cuda.synchronize()
    err = max(_held("nmt gru out", out, ref_out, torch.float32),
              _held("nmt gru hT", hT, ref_hT, torch.float32))

    # the inference artifact, saved and loaded on the card
    os.makedirs(NMT_OUT, exist_ok=True)
    path = os.path.join(NMT_OUT, "nmt_beam.tar")
    save_inference_model(path, beam, paddle.Parameters(
        {k: v.detach() for k, v in gparams.items()}))
    inf = load_inference_model(path)
    os.remove(path)
    art_gap = _same_paths("nmt decode, artifact vs trained", decode(
        inf.parameters.raw, inf.topology), paths)

    for i in range(3):
        score, ids = paths[i][0]
        log(f"nmt decode: source {i} {list(sources[i][0])} -> [{score:.4f}] "
            f"{ids}")
    log(f"nmt decode ({card}): nmt_generator beam {NMT_BEAM}, max_length "
        f"{NMT_MAX_LEN}, {len(sources)} wmt14.test() sources in "
        f"{gen_s * 1e3:.3f} ms, {len(sources) / gen_s:.2f} sentences/s; "
        f"GRU launches by route {routes} (plan {plan}); best paths "
        f"token-identical to the plain GRU's on the card (scores within "
        f"{gap:.3g}); GRU out/hT within {err:.3g} of the plain GRU; the "
        f"artifact's paths identical (scores within {art_gap:.3g})")
    _trace(decode, "nmt decode", f"1 decode of {len(sources)} sources",
           "GRU kernels", ("gru_fwd_kernel",),
           launched=lambda: fr.gru_forward.launches)

    # the cooperative GRU at the decode's shape
    ms = device_ms(lambda i: fr.gru_forward(x3, lens, w, bias), iters=3,
                   reps=3)
    plain_ms = device_ms(lambda i: fr.gru_reference(x3, lens, w, bias),
                         iters=1, reps=3)
    lens_l = [int(n) for n in lens.tolist()]
    bound_ms, bound_by = _rnn_bound("gru_fwd", torch.float32, b, h, T, lens_l)
    if ms < bound_ms:
        raise AssertionError(f"gru coop: {ms} ms reads under its bound "
                             f"{bound_ms} ms")
    bf16_plan = fr.gru_fwd_plan(b, h, torch.bfloat16, _sms())
    log(f"gru_fwd float32 cooperative gru_fwd.cu at the nmt decode's b{b} "
        f"h{h} T{T} ({max(lens_l)} run steps, {sum(lens_l)} valid "
        f"row-steps; {card}): {ms * 1e3:.2f} us/call "
        f"({ms / max(lens_l) * 1e3:.3f} us/step), bound "
        f"{bound_ms * 1e3:.3f} us ({bound_by}), plain {plain_ms * 1e3:.2f} "
        f"us; the bf16 plan of this shape (not on this path): {bf16_plan}")
    log(f"nmt phase wall {time.perf_counter() - t_phase:.1f} s")
    from paddle_tpu_torch import config
    config.init(seed=0, compute_dtype="float32")
    return dict(launches=routes["coop"], err=err,
                timing=dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by))


# ------------------------------------------------------------ phase 31
SEQ2SEQ_CPU_BATCHES = 8
SEQ2SEQ_CPU_RTOL = 1e-4


def seqtoseq_v2_demo(paddle, use_tpu=None, num_passes=2, batch_size=16,
                     dict_size=1000, beam_size=3, init_tar=None,
                     num_batches_per_pass=None, echo=print):
    import importlib
    import io

    import numpy as np
    seq2seq = importlib.import_module(paddle.__name__ + ".models.seq2seq")
    DataFeeder = importlib.import_module(
        paddle.__name__ + ".trainer.data_feeder").DataFeeder

    paddle.init(use_tpu=use_tpu, seed=5)

    model = seq2seq.nmt_attention(src_vocab=dict_size, trg_vocab=dict_size,
                                  emb_size=64, enc_size=64, dec_size=64)
    parameters = paddle.create_parameters(paddle.Topology(model.cost))
    if init_tar is not None:
        parameters = paddle.Parameters.from_tar(io.BytesIO(init_tar))
    buf = io.BytesIO()
    parameters.to_tar(buf)
    optimizer = paddle.optimizer.Adam(learning_rate=1e-3)
    trainer = paddle.SGD(cost=model.cost, parameters=parameters,
                         update_equation=optimizer,
                         extra_layers=model.extra_layers)

    feeding = {"source_words": 0, "target_words": 1, "target_next_words": 2}
    costs = []

    def handler(e):
        if isinstance(e, paddle.event.EndIteration):
            costs.append(e.cost)
        if isinstance(e, paddle.event.EndIteration) and e.batch_id % 20 == 0:
            echo(f"pass {e.pass_id} batch {e.batch_id} cost {e.cost:.4f}")
        if isinstance(e, paddle.event.EndPass):
            echo(f"== pass {e.pass_id}: {e.evaluator}")

    reader = paddle.reader.batch(
        paddle.reader.shuffle(
            paddle.dataset.wmt14.train(dict_size=dict_size), 1024,
            seed=9),
        batch_size, drop_last=True)
    trainer.train(reader, num_passes=num_passes, event_handler=handler,
                  feeding=feeding, num_batches_per_pass=num_batches_per_pass)

    # --- generation: same parameters drive the beam-search graph
    beam = seq2seq.nmt_generator(src_vocab=dict_size, trg_vocab=dict_size,
                                 emb_size=64, enc_size=64, dec_size=64,
                                 beam_size=beam_size, max_length=12)
    gen_topo = paddle.Topology(beam)
    feeder = DataFeeder(gen_topo.data_type(), {"source_words": 0})
    samples = [s for _, s in zip(range(3),
                                 paddle.dataset.wmt14.test(dict_size)())]
    feed = feeder([(s[0],) for s in samples])
    feed.pop("__batch_size__", None)
    outs, _ = gen_topo.forward(parameters.raw, {}, feed, mode="test")
    res = outs[beam.name]
    for i, paths in enumerate(res.to_list()):
        echo(f"source {i}:")
        for score, ids in paths:
            echo(f"  [{score:8.3f}] {' '.join(str(t) for t in ids)}")

    # seq_text_printer: the best beam path per source as text, ids
    # mapped through the target dictionary (the synthetic data has no
    # word list, so ids render as "w<i>")
    trg_dict = {i: f"w{i}" for i in range(dict_size)}
    printer = paddle.evaluator.seq_text_printer(beam, dict_data=trg_dict)
    printer.start()
    best = [paths[0][1] if paths else [] for paths in res.to_list()]
    T = max(1, max(len(b) for b in best))
    ids = np.zeros((len(best), T), np.int32)
    for i, b in enumerate(best):
        ids[i, :len(b)] = b
    lengths = np.array([len(b) for b in best], np.int32)
    echo("translations (best beam, seq_text_printer):")
    printer.eval_batch([(ids, lengths)], len(best))
    return dict(costs=costs, paths=res.to_list(), init_tar=buf.getvalue(),
                trainer=trainer)


def phase_seqtoseq_v2():
    """Phase 31: the port copy of demo/seqToseq/train.py on the card at
    its own widths (dict 1000, 64, batch 16, Adam(1e-3), beam 3), 1 pass
    (the script's 2, cut): its costs, beam paths and seq_text_printer
    lines; the costs of its first 8 batches within 1e-4 relative of the
    same copy on the CPU port from the card run's init tar."""
    import contextlib
    import io

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.registry import reset_name_counters
    card = nvidia_smi_line()
    lines, printed = [], io.StringIO()
    reset_name_counters()             # one set of layer names for both runs
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        r = seqtoseq_v2_demo(paddle, use_tpu=None, num_passes=1,
                             echo=lines.append)
    wall = time.perf_counter() - t0
    trainer = r["trainer"]
    if trainer.device.type != "cuda":
        raise AssertionError(f"the seqToseq script trained on "
                             f"{trainer.device}, not the card")
    if len(r["costs"]) != 2000 // 16 or not np.all(np.isfinite(r["costs"])):
        raise AssertionError(f"seqToseq v2: {len(r['costs'])} steps, costs "
                             f"{r['costs'][:4]}...")
    if len(r["paths"]) != 3 or any(len(p) != 1 or not p[0][1]
                                   for p in r["paths"]):
        raise AssertionError(f"seqToseq v2: beam paths {r['paths']}")
    reset_name_counters()
    with contextlib.redirect_stdout(io.StringIO()):
        c = seqtoseq_v2_demo(paddle, use_tpu=False, num_passes=1,
                             num_batches_per_pass=SEQ2SEQ_CPU_BATCHES,
                             init_tar=r["init_tar"], echo=_quiet)
    from paddle_tpu_torch import config
    config.init(seed=0, compute_dtype="float32")      # back to the card
    got = np.asarray(r["costs"][:SEQ2SEQ_CPU_BATCHES])
    want = np.asarray(c["costs"])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    if len(want) != SEQ2SEQ_CPU_BATCHES or rel > SEQ2SEQ_CPU_RTOL:
        raise AssertionError(f"seqToseq v2: card costs {got} against the "
                             f"CPU port's {want}: max rel {rel}")
    for line in lines + printed.getvalue().splitlines():
        log(f"seqToseq v2: {line}")
    log(f"seqToseq v2 ({card}): {len(r['costs'])} train batches and 3 "
        f"beam decodes in {wall:.3f} s; costs {r['costs'][0]:.4f} -> "
        f"{r['costs'][-1]:.4f}; first {SEQ2SEQ_CPU_BATCHES} costs within "
        f"{rel:.3g} relative of the CPU port's")


# ------------------------------------------------------------ phase 32
# models/recommender.py at its defaults, BASELINE.json's Wide&Deep CTR
WD_VOCABS = (100000, 100000, 10000)
WD_HIGH_VOCABS = (1000000, 1000000, 100000)   # "high-dim": 1 M-row tables
WD_PARAMS = 13744050
WD_TABLES = {f"_wd_{kind}{i}_w": f"sparse_{i}"
             for kind in ("emb", "wide") for i in range(3)}
WD_BATCH, WD_WARMUP, WD_TIMED, WD_STEPS, WD_CPU_STEPS = 512, 2, 8, 50, 4
WD_MOMENTUM_STEPS = 8
WD_CPU_RTOL = 1e-4
WD_ZIPF = 1.1
WD_DENSE = 13
WD_FEEDING = {"sparse_0": 0, "sparse_1": 1, "sparse_2": 2,
              "dense_features": 3, "label": 4}
WD_MOMENTUM_TOL = dict(rtol=1e-5, atol=1e-6)   # tests/test_sparse.py:98-100
WD_TABLE_BYTES = 1000000 * 64 * 4              # one 1 M x 64 float32 table


class CtrData:
    """Seeded synthetic Criteo-shaped rows: 3 id slots and 13 dense
    features a row. Each slot's ids follow a Zipf law (exponent 1.1)
    over ranks shuffled by a seeded permutation, so most rows go
    untouched for many steps; the label is a fixed seeded logistic rule
    over the dense features and slot 0's id."""

    def __init__(self, vocabs, seed=0):
        rng = np.random.RandomState(seed)
        self.vocabs = vocabs
        self.cdf, self.perm = [], []
        for v in vocabs:
            w = np.arange(1, v + 1, dtype=np.float64) ** -WD_ZIPF
            self.cdf.append(np.cumsum(w) / w.sum())
            self.perm.append(rng.permutation(v))
        self.w = rng.randn(WD_DENSE) / np.sqrt(WD_DENSE)
        self.id_logit = 2.0 * rng.randn(vocabs[0])
        self.rng = np.random.RandomState(seed + 1)

    def batch(self, n=WD_BATCH):
        ids = [perm[np.minimum(np.searchsorted(cdf, self.rng.rand(n)),
                               len(perm) - 1)]
               for cdf, perm in zip(self.cdf, self.perm)]
        dense = self.rng.randn(n, WD_DENSE).astype(np.float32)
        logit = dense @ self.w + self.id_logit[ids[0]]
        label = (self.rng.rand(n) < 1.0 / (1.0 + np.exp(-logit)))
        return [(int(ids[0][r]), int(ids[1][r]), int(ids[2][r]), dense[r],
                 int(label[r])) for r in range(n)]


def _wd_build(paddle, vocabs, sparse=True):
    """(cost node, Topology) of wide_and_deep at ``vocabs``; with
    sparse False the same graph with dense tables (its serialized
    topology with every ``sparse`` attribute off)."""
    from paddle_tpu_torch.core.registry import reset_name_counters
    from paddle_tpu_torch.models import wide_and_deep
    reset_name_counters()
    spec = wide_and_deep(sparse_dims=vocabs)
    topo = paddle.Topology(spec.cost)
    if not sparse:
        blob = topo.serialize().replace('"sparse": true', '"sparse": false')
        topo = paddle.Topology.deserialize(blob)
    return topo.by_name[spec.cost.name], topo


def _wd_trainer(paddle, cost, init, optimizer=None, device=None):
    """An SGD on a copy of the ``init`` tables (``Adam(1e-3)`` unless an
    optimizer is given)."""
    params = paddle.Parameters({k: v.detach().clone().to(device)
                                for k, v in init.items()})
    return paddle.SGD(cost=cost, parameters=params, device=device,
                      update_equation=optimizer or paddle.optimizer.Adam(
                          learning_rate=1e-3))


def _wd_steps(trainer, batches):
    """train_batch over ``batches``: (costs, seconds of each step)."""
    costs, secs = [], []
    for b in batches:
        t0 = time.perf_counter()
        costs.append(trainer.train_batch(b, feeding=WD_FEEDING)[0])
        secs.append(time.perf_counter() - t0)
    return costs, secs


def _wd_timed(label, trainer, batches, card):
    """Warm-ups then timed steps, with the peak memory's growth over the
    memory held before the first timed step; returns (costs, step_ms,
    growth bytes)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    costs, secs = _wd_steps(trainer, batches)
    growth = torch.cuda.max_memory_allocated() - base
    step_ms = 1e3 * float(np.mean(secs[WD_WARMUP:]))
    log(f"{label} ({card}): step_ms {step_ms:.3f} (train_batch, "
        f"{len(secs) - WD_WARMUP} after {WD_WARMUP} warm-ups), "
        f"{WD_BATCH / (step_ms / 1e3):.1f} samples/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, "
        f"{growth / 1e6:.1f} MB over the {base / 1e6:.1f} MB held before "
        f"the steps")
    return costs, step_ms, growth


def _unique_per_table(batches):
    """Mean unique ids a step in each of the three id slots."""
    return [float(np.mean([len({s[i] for s in b}) for b in batches]))
            for i in range(3)]


def _wd_rows_check(trainer, batches):
    """After ``batches`` (the trainer's every step): rows never fed have
    Adam's m, v and the clock _t exactly 0; each fed row's _t is the
    last step that fed it."""
    for pname, src in WD_TABLES.items():
        slot = trainer.opt_state["slots"][pname]
        i = int(src[-1])
        vocab = slot["_t"].shape[0]
        last = np.zeros(vocab, np.int32)
        for step, b in enumerate(batches, 1):
            last[[s[i] for s in b]] = step
        t = slot["_t"].cpu().numpy()
        if not np.array_equal(t, last):
            bad = np.flatnonzero(t != last)[:5]
            raise AssertionError(f"{pname}: _t {t[bad]} at rows {bad}, "
                                 f"not the last feeding steps {last[bad]}")
        fed = torch.from_numpy(last > 0).to(slot["m"].device)
        for kk in ("m", "v"):
            if bool((slot[kk][~fed] != 0).any()):
                raise AssertionError(f"{pname}: {kk} nonzero on a row "
                                     "never fed")
            if not bool((slot[kk][fed] != 0).any()):
                raise AssertionError(f"{pname}: {kk} zero on every fed row")


def phase_wide_deep():
    """Phase 32: Wide&Deep at full width on the row-sparse path — sparse
    against dense tables at the default and at 1 M-row vocabularies,
    the CPU port's costs, the rows' clocks and moments, and Momentum's
    exact catch-up."""
    import paddle_tpu_torch as paddle

    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    paddle.init(seed=11)                      # float32, on the card
    cost, topo = _wd_build(paddle, WD_VOCABS)
    n_params = sum(int(np.prod(ps.shape))
                   for ps in topo.param_specs.values())
    if n_params != WD_PARAMS or topo.sparse_tables() != WD_TABLES:
        raise AssertionError(f"wide_and_deep: {n_params} parameters, "
                             f"sparse tables {topo.sparse_tables()}")
    init = paddle.create_parameters(topo).raw
    data = CtrData(WD_VOCABS, seed=11)
    batches = [data.batch() for _ in range(WD_STEPS)]
    uniq = _unique_per_table(batches)
    log(f"wide&deep: wide_and_deep{WD_VOCABS}, emb 64, dense 13, hidden "
        f"(256, 128, 64), {n_params} parameters, float32, Adam(1e-3), "
        f"batch {WD_BATCH}; Zipf {WD_ZIPF} ids: mean unique ids a step "
        f"{[round(u, 1) for u in uniq]} (slots 0-2; each feeds its emb and "
        "wide table)")

    sparse = _wd_trainer(paddle, cost, init)
    costs, step_ms, _ = _wd_timed(
        "wide&deep sparse train", sparse, batches[:WD_WARMUP + WD_TIMED],
        card)
    more, _ = _wd_steps(sparse, batches[WD_WARMUP + WD_TIMED:])
    costs += more
    if not np.all(np.isfinite(costs)) or \
            not np.mean(costs[-5:]) < np.mean(costs[:5]):
        raise AssertionError(f"wide&deep: costs {costs} not finite and "
                             "falling")
    _wd_rows_check(sparse, batches)
    log(f"wide&deep sparse: {WD_STEPS} steps, costs {costs[0]:.4f} -> "
        f"{costs[-1]:.4f} (first 5 mean {np.mean(costs[:5]):.4f}, last 5 "
        f"{np.mean(costs[-5:]):.4f}); untouched rows' m, v, _t exactly 0 "
        "and each fed row's _t its last step, in all six tables")
    _trace(lambda: sparse.train_batch(batches[-1], feeding=WD_FEEDING),
           "wide&deep sparse train", "1 step", "index, sort and scatter "
           "kernels", ("index", "sort", "scatter", "gather"))
    del sparse

    dense_cost, dtopo = _wd_build(paddle, WD_VOCABS, sparse=False)
    if dtopo.sparse_tables():
        raise AssertionError("the dense twin still has sparse tables")
    dense = _wd_trainer(paddle, dense_cost, init)
    dcosts, dense_ms, _ = _wd_timed(
        "wide&deep dense train", dense, batches[:WD_WARMUP + WD_TIMED],
        card)
    _trace(lambda: dense.train_batch(batches[-1], feeding=WD_FEEDING),
           "wide&deep dense train", "1 step", "index, sort and scatter "
           "kernels", ("index", "sort", "scatter", "gather"))
    del dense
    log(f"wide&deep: sparse {step_ms:.3f} ms a step against dense "
        f"{dense_ms:.3f} (x{dense_ms / step_ms:.3f}); first costs "
        f"{[round(c, 5) for c in costs[:3]]} sparse, "
        f"{[round(c, 5) for c in dcosts[:3]]} dense")

    # the first steps in the port on the CPU, from the same init
    t0 = time.perf_counter()
    cpu = _wd_trainer(paddle, cost, init, device="cpu")
    want = _wd_steps(cpu, batches[:WD_CPU_STEPS])[0]
    del cpu
    got = np.asarray(costs[:WD_CPU_STEPS])
    rel = float(np.max(np.abs(got - np.asarray(want)) / np.abs(want)))
    if rel > WD_CPU_RTOL:
        raise AssertionError(f"wide&deep: card costs {got} against the CPU "
                             f"port's {want}: max rel {rel}")
    log(f"wide&deep: first {WD_CPU_STEPS} costs within {rel:.3g} relative "
        f"of the CPU port's ({time.perf_counter() - t0:.1f} s on the CPU)")

    # Momentum: the exact catch-up makes sparse == dense
    def momentum():
        return paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9)

    runs = []
    for c in (cost, dense_cost):
        tr = _wd_trainer(paddle, c, init, momentum())
        _wd_steps(tr, batches[:WD_MOMENTUM_STEPS])
        runs.append(tr.optimizer.test_params(tr._own_params(), tr.opt_state))
        del tr
    worst = 0.0
    for k, want_t in runs[1].items():
        got_t = runs[0][k].detach()
        excess = (torch.abs(got_t - want_t.detach()) -
                  WD_MOMENTUM_TOL["rtol"] * torch.abs(want_t.detach()))
        worst = max(worst, float(excess.max()))
    if worst > WD_MOMENTUM_TOL["atol"]:
        raise AssertionError(f"wide&deep Momentum: sparse test_params off "
                             f"the dense run's by {worst} past rtol 1e-5")
    log(f"wide&deep Momentum(0.01, 0.9): {WD_MOMENTUM_STEPS} sparse and "
        f"dense steps give test_params within rtol 1e-5 + {worst:.3g} "
        "(atol 1e-6)")
    del runs, init

    # high-dim: 1 M-row tables, sparse against dense
    h_cost, h_topo = _wd_build(paddle, WD_HIGH_VOCABS)
    h_init = paddle.create_parameters(h_topo).raw
    h_params = sum(int(v.numel()) for v in h_init.values())
    h_data = CtrData(WD_HIGH_VOCABS, seed=12)
    h_batches = [h_data.batch() for _ in range(WD_WARMUP + WD_TIMED)]
    log(f"wide&deep high-dim: wide_and_deep{WD_HIGH_VOCABS}, {h_params} "
        f"parameters; mean unique ids a step "
        f"{[round(u, 1) for u in _unique_per_table(h_batches)]}")
    tr = _wd_trainer(paddle, h_cost, h_init)
    _, h_sparse_ms, h_growth = _wd_timed("wide&deep high-dim sparse train",
                                         tr, h_batches, card)
    _trace(lambda: tr.train_batch(h_batches[-1], feeding=WD_FEEDING),
           "wide&deep high-dim sparse train", "1 step", "index, sort and "
           "scatter kernels", ("index", "sort", "scatter", "gather"))
    del tr
    if h_growth >= WD_TABLE_BYTES:
        raise AssertionError(f"wide&deep high-dim: the sparse step grew "
                             f"memory by {h_growth} bytes, not below one "
                             f"1 M x 64 float32 table ({WD_TABLE_BYTES})")
    hd_cost, _ = _wd_build(paddle, WD_HIGH_VOCABS, sparse=False)
    tr = _wd_trainer(paddle, hd_cost, h_init)
    _, h_dense_ms, h_dense_growth = _wd_timed(
        "wide&deep high-dim dense train", tr, h_batches, card)
    _trace(lambda: tr.train_batch(h_batches[-1], feeding=WD_FEEDING),
           "wide&deep high-dim dense train", "1 step", "index, sort and "
           "scatter kernels", ("index", "sort", "scatter", "gather"))
    del tr, h_init
    log(f"wide&deep high-dim: sparse {h_sparse_ms:.3f} ms a step against "
        f"dense {h_dense_ms:.3f} (x{h_dense_ms / h_sparse_ms:.3f}); the "
        f"sparse step's memory growth {h_growth / 1e6:.1f} MB (< one 1 M x "
        f"64 table, {WD_TABLE_BYTES / 1e6:.0f} MB), the dense step's "
        f"{h_dense_growth / 1e6:.1f} MB")
    log(f"wide&deep phase wall {time.perf_counter() - t_phase:.1f} s")
    from paddle_tpu_torch import config
    config.init(seed=0, compute_dtype="float32")


# ------------------------------------------------------------ phase 33
RECO_CPU_BATCHES = 8
RECO_CPU_RTOL = 1e-4


def recommendation_v2_demo(paddle, use_tpu=None, num_passes=2, batch_size=64,
                           init_tar=None, num_batches_per_pass=None,
                           echo=print):
    import importlib
    import io

    import numpy as np
    movielens = importlib.import_module(paddle.__name__ + ".dataset.movielens")
    movielens_regression = importlib.import_module(
        paddle.__name__ + ".models.recommender").movielens_regression

    paddle.init(use_tpu=use_tpu, seed=13)

    model = movielens_regression(user_dim=movielens.max_user_id() + 1,
                                 movie_dim=movielens.max_movie_id() + 1,
                                 emb_size=32)
    parameters = paddle.create_parameters(paddle.Topology(model.cost))
    if init_tar is not None:
        parameters = paddle.Parameters.from_tar(io.BytesIO(init_tar))
    buf = io.BytesIO()
    parameters.to_tar(buf)
    optimizer = paddle.optimizer.Adam(learning_rate=2e-3)
    trainer = paddle.SGD(cost=model.cost, parameters=parameters,
                         update_equation=optimizer)

    def to_sample(r):
        # movielens rows: (uid, gender, age, job, mid, categories, title,
        # rating) -> (user_id, movie_id, [rating])
        def reader():
            for row in r():
                yield row[0], row[4], np.asarray([row[7]], np.float32)
        return reader

    feeding = {"user_id": 0, "movie_id": 1, "score": 2}
    costs = []

    def handler(e):
        if isinstance(e, paddle.event.EndIteration):
            costs.append(e.cost)
        if isinstance(e, paddle.event.EndIteration) and e.batch_id % 25 == 0:
            echo(f"pass {e.pass_id} batch {e.batch_id} cost {e.cost:.4f}")
        if isinstance(e, paddle.event.EndPass):
            echo(f"== pass {e.pass_id} done")

    reader = paddle.reader.batch(
        paddle.reader.shuffle(to_sample(movielens.train()), 4096, seed=2),
        batch_size, drop_last=True)
    trainer.train(reader, num_passes=num_passes, event_handler=handler,
                  feeding=feeding, num_batches_per_pass=num_batches_per_pass)

    result = trainer.test(
        paddle.reader.batch(to_sample(movielens.test()), batch_size),
        feeding=feeding)
    echo(f"test mse cost {result.cost:.4f}")
    return dict(costs=costs, test_cost=result.cost, init_tar=buf.getvalue(),
                trainer=trainer)


def phase_recommendation_v2():
    """Phase 33: the port copy of demo/recommendation/train.py on the
    card at its own settings (emb 32, Adam(2e-3), batch 64, 2 passes on
    the synthetic MovieLens): its costs and test mse cost; the costs of
    its first 8 batches within 1e-4 relative of the same copy on the CPU
    port from the card run's init tar."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.registry import reset_name_counters
    card = nvidia_smi_line()
    lines = []
    reset_name_counters()             # one set of layer names for both runs
    t0 = time.perf_counter()
    r = recommendation_v2_demo(paddle, use_tpu=None, echo=lines.append)
    wall = time.perf_counter() - t0
    trainer = r["trainer"]
    if trainer.device.type != "cuda":
        raise AssertionError(f"the recommendation script trained on "
                             f"{trainer.device}, not the card")
    n_train = sum(1 for _ in paddle.dataset.movielens.train()())
    if len(r["costs"]) != 2 * (n_train // 64) or \
            not np.all(np.isfinite(r["costs"])) or \
            not np.isfinite(r["test_cost"]):
        raise AssertionError(f"recommendation v2: {len(r['costs'])} steps, "
                             f"costs {r['costs'][:4]}..., test "
                             f"{r['test_cost']}")
    reset_name_counters()
    c = recommendation_v2_demo(paddle, use_tpu=False,
                               num_passes=1,
                               num_batches_per_pass=RECO_CPU_BATCHES,
                               init_tar=r["init_tar"], echo=_quiet)
    from paddle_tpu_torch import config
    config.init(seed=0, compute_dtype="float32")      # back to the card
    got = np.asarray(r["costs"][:RECO_CPU_BATCHES])
    want = np.asarray(c["costs"])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    if len(want) != RECO_CPU_BATCHES or rel > RECO_CPU_RTOL:
        raise AssertionError(f"recommendation v2: card costs {got} against "
                             f"the CPU port's {want}: max rel {rel}")
    for line in lines:
        log(f"recommendation v2: {line}")
    log(f"recommendation v2 ({card}): {len(r['costs'])} train batches and "
        f"the test sweep in {wall:.3f} s; costs {r['costs'][0]:.4f} -> "
        f"{r['costs'][-1]:.4f}, test mse cost {r['test_cost']:.4f}; first "
        f"{RECO_CPU_BATCHES} costs within {rel:.3g} relative of the CPU "
        "port's")


# ------------------------------------------------------------ phase 34
# bench.py's moe_lm_bs8_t1024 (bench_moe_lm, :528-570): phase 7's LM with
# every FFN an 8-expert top-2 MoE (capacity factor 1.25, aux coeff 0.01)
MOE_TRAIN = dict(TRAIN, moe_experts=8)
MOE_PARAMS, MOE_EXPERT_PARAMS = 123900928, 100663296
MOE_COSTS = 1 + TRAIN["n_layers"]          # the CE + one aux a layer
# sort against einsum for one MoE layer at 8192 tokens, float32: max
# |diff| of y and of each gradient within this share of the tensor's
# max |ref| (the einsum's one-hot sums are exact; what differs is the
# order of the k = 2 products a token sums)
MOE_PATH_TOL = 2e-5


@contextlib.contextmanager
def _moe_ranges():
    """The MoE block's entry points (ops/moe.py's moe_ffn and
    moe_aux_loss, which the layers call through the module) inside
    profiler ranges named "moe_ffn" / "moe_aux"."""
    from paddle_tpu_torch.ops import moe as moe_ops
    orig = (moe_ops.moe_ffn, moe_ops.moe_aux_loss)

    def ranged(name, fn):
        def call(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return call

    moe_ops.moe_ffn = ranged("moe_ffn", orig[0])
    moe_ops.moe_aux_loss = ranged("moe_aux", orig[1])
    try:
        yield
    finally:
        moe_ops.moe_ffn, moe_ops.moe_aux_loss = orig


MOE_RANGES = ("moe_ffn", "moe_aux")


def _kernels_ms(e):
    """Device ms of the kernels launched by profiler event ``e`` and
    its descendants (the ranges' own GPU annotations left out)."""
    own = sum(k.duration for k in e.kernels if k.name not in MOE_RANGES)
    return own / 1e3 + sum(_kernels_ms(c) for c in e.cpu_children)


def _moe_share(prof):
    """Device ms of the MoE block in one traced step: the kernels under
    the forward's MOE_RANGES, and those of the backward nodes whose
    sequence numbers are those of the forward operations inside them
    (the autograd engine runs them on its own thread)."""
    events = prof.events()
    ranges = [e for e in events if e.name in MOE_RANGES]
    seqs = set()

    def walk(e):
        if getattr(e, "sequence_nr", -1) >= 0:
            seqs.add(e.sequence_nr)
        for c in e.cpu_children:
            walk(c)

    for e in ranges:
        walk(e)
    fwd = sum(_kernels_ms(e) for e in ranges)
    bwd_nodes = [e for e in events if e.name.startswith(
        "autograd::engine::evaluate_function:")
        and getattr(e, "sequence_nr", -1) in seqs]
    if not bwd_nodes:     # the node events themselves, where the engine's
        bwd_nodes = [e for e in events    # wrappers carry no number
                     if re.search(r"Backward\d+$", e.name)
                     and getattr(e, "sequence_nr", -1) in seqs]
    bwd = sum(_kernels_ms(e) for e in bwd_nodes)
    return fwd, bwd, len(bwd_nodes)


def phase_moe_train():
    """Phase 34: the MoE LM at full width in bfloat16 (the bench's
    dtype), Adam(1e-4), 2 warm-ups then 8 timed train_batch steps on
    phase 7's seeded batch; the 7 costs finite each step, the total
    falling, 48 launches of each bf16 flash kernel (none of the float32
    ones), one step traced. Then the sort path against the einsum path
    for one MoE layer at 8192 tokens in float32. Returns the trainer."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import SGD, create

    card = nvidia_smi_line()
    spec = _lm_spec("bfloat16", **MOE_TRAIN)
    costs = [c.name for c in spec.cost]
    if len(costs) != MOE_COSTS:
        raise AssertionError(f"MoE LM cost nodes {costs}")
    topo = Topology(spec.cost, extra_outputs=[spec.output])
    params = create(topo, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in params.raw.values())
    n_expert = sum(p.numel() for k, p in params.raw.items()
                   if "moe_up" in k or "moe_down" in k)
    if (n_params, n_expert) != (MOE_PARAMS, MOE_EXPERT_PARAMS):
        raise AssertionError(f"MoE LM has {n_params} parameters, "
                             f"{n_expert} in experts")
    trainer = SGD(spec.cost, params, Adam(learning_rate=1e-4))
    batch = _lm_batch()
    steps = [trainer.train_batch(batch) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _flash_counts(fa, zero=True)
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        steps.append(trainer.train_batch(batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _flash_counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [c for c, _ in steps]
    for c, m in steps:
        if sorted(m) != sorted(costs) or not all(np.isfinite(list(
                m.values()))) or not np.isfinite(c):
            raise AssertionError(f"MoE LM costs {c} {m}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"MoE LM total cost not falling: {losses}")
    want = TRAIN_STEPS * TRAIN["n_layers"]
    expect = {k: {"sm90": want, "tf32x3": 0} for k in launches}
    if launches != expect:
        raise AssertionError(f"MoE LM flash launches {launches} != "
                             f"{expect}")
    step_ms = wall / TRAIN_STEPS * 1e3
    tokens = TRAIN_ROWS * TRAIN["max_len"]
    aux = [round(steps[-1][1][c], 5) for c in costs[1:]]
    log(f"moe train ({card}): {n_params} parameters ({n_expert} in "
        f"experts), bfloat16, {TRAIN_STEPS} timed steps after "
        f"{TRAIN_WARMUP}: step_ms {step_ms:.3f}, "
        f"{tokens / (step_ms / 1e3):.1f} tokens/s, peak {peak_gb:.3f} GB; "
        f"total costs {[round(x, 4) for x in losses]}; last step's aux "
        f"costs {aux}; flash launches by route {launches}")

    torch.cuda.synchronize()
    with _moe_ranges(), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_batch(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, n_ops = {}, 0
    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA" and ev.self_device_time_total > 0 \
                and ev.key not in MOE_RANGES:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + \
                ev.self_device_time_total / 1e3
            n_ops += ev.count
    busy = sum(by_kernel.values())
    flash = sum(v for k, v in by_kernel.items() if "flash_" in k)
    fwd, bwd, n_bwd = _moe_share(prof)
    log(f"moe train trace ({card}): 1 step, wall {wall_ms:.3f} ms, device "
        f"busy {busy:.3f} ms (idle share {1 - busy / wall_ms:.3f}) in "
        f"{n_ops} device operations; MoE operations {fwd + bwd:.3f} ms "
        f"({(fwd + bwd) / busy:.3f} of busy: forward {fwd:.3f}, backward "
        f"{bwd:.3f} over {n_bwd} autograd nodes), flash kernels "
        f"{flash:.3f} ms ({flash / busy:.3f} of busy)")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"moe train trace top kernel: {ms:.3f} ms  {name[:90]}")
    _moe_paths_check(params.raw)
    return trainer


def _moe_paths_check(raw):
    """Layer 0's MoE block of the trained table at 8192 seeded tokens in
    float32: the sort path (the layer's "auto") against the einsum path
    — y, aux, and the gradients of x, the gate and both expert tables
    of sum(y * proj) + aux."""
    from paddle_tpu_torch.ops import moe as moe_ops
    gen = torch.Generator(device="cuda").manual_seed(34)
    n, d = TRAIN_ROWS * TRAIN["max_len"], TRAIN["d_model"]
    x0 = torch.randn(n, d, generator=gen, device="cuda")
    proj = torch.randn(n, d, generator=gen, device="cuda")
    w0 = [raw[f"_tfm_l0_moe.{w}"].detach().float().clone()
          for w in ("gate", "moe_up", "moe_down")]
    cap = moe_ops.moe_capacity(n, MOE_TRAIN["moe_experts"], 2, 1.25)
    outs = {}
    for mode in ("einsum", "sort"):
        leaves = [t.clone().requires_grad_() for t in [x0] + w0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = moe_ops.moe_ffn(leaves[0], None, *leaves[1:], k=2,
                                 capacity=cap, dispatch_mode=mode)
        grads = torch.autograd.grad((y * proj).sum() + aux, leaves)
        torch.cuda.synchronize()
        outs[mode] = ([y.detach(), aux.detach().reshape(1)] + list(grads),
                      (time.perf_counter() - t0) * 1e3,
                      torch.cuda.max_memory_allocated() / 1e9)
    names = ["y", "aux", "dx", "dgate", "dup", "ddown"]
    ratios = []
    for name, got, ref in zip(names, outs["sort"][0], outs["einsum"][0]):
        r = ((got - ref).abs().max() / ref.abs().max()).item()
        ratios.append(f"{name} {r:.3e}")
        if not r <= MOE_PATH_TOL:
            raise AssertionError(f"moe sort vs einsum at {n} tokens: {name} "
                                 f"max|diff|/max|ref| {r} > {MOE_PATH_TOL}")
    log(f"moe paths ({nvidia_smi_line()}): one layer at {n} tokens, E "
        f"{MOE_TRAIN['moe_experts']}, k 2, capacity {cap}, float32: sort "
        f"vs einsum max|diff|/max|ref| {', '.join(ratios)} (bound "
        f"{MOE_PATH_TOL}); forward + backward {outs['sort'][1]:.3f} ms "
        f"(sort, first call) vs {outs['einsum'][1]:.3f} ms (einsum)")


# ------------------------------------------------------------ phase 35
def phase_moe_serve(trainer):
    """Phase 35: phase 34's trained table through Parameters.to_tar and
    load_params_tar into TransformerDecoder(moe_k=2), drop-free, served
    by DecodeEngine at the serving cell's shapes (8 slots, 16-token
    pages, the prefix cache on) on 8 seeded requests: window-kernel
    launches == steps x 6, every request's tokens equal to the dense
    decoder's generate under the tie rule."""
    import io

    from paddle_tpu_torch.models.decode import TransformerDecoder
    from paddle_tpu_torch.ops import paged_decode as ops
    from paddle_tpu_torch.params import load_params_tar
    from paddle_tpu_torch.serving import DecodeEngine

    buf = io.BytesIO()
    trainer.save_parameter_to_tar(buf)
    buf.seek(0)
    table = load_params_tar(buf)
    if not any("_moe." in k for k in table):
        raise AssertionError("the trained table has no MoE blocks")
    dec = TransformerDecoder(table, n_layers=TRAIN["n_layers"],
                             n_heads=TRAIN["n_heads"], moe_k=2)
    eng = DecodeEngine(dec, num_slots=SLOTS, page_size=PAGE,
                       max_seq_len=FULL["max_len"])
    eng.warmup()
    prompts, news = serving_requests()
    prompts, news = prompts[:SLOTS], news[:SLOTS]
    torch.cuda.synchronize()
    ops.paged_window_attention.launches = 0
    reqs, wall = _serve(eng, prompts, news)
    launches = ops.paged_window_attention.launches
    st = eng.stats()
    if launches != st["steps"] * TRAIN["n_layers"] or launches == 0:
        raise AssertionError(f"MoE engine: window launches {launches} != "
                             f"steps {st['steps']} x {TRAIN['n_layers']}")
    dense = []
    for p, n in zip(prompts, news):
        want = dec.generate(p[None, :], max_len=len(p) + n)[0]
        ref = dec.prefill_logits(np.concatenate([p, want])[None, :])[0]
        dense.append((want, ref[len(p) - 1:]))
    _check_dense(reqs, dense, "moe engine")
    gen = st["tokens_out"]
    log(f"moe engine ({nvidia_smi_line()}): the trained MoE table, "
        f"{len(reqs)} requests, {gen} tokens, {st['steps']} steps, "
        f"{wall:.3f} s, {gen / wall:.1f} tokens/s, window kernel launches "
        f"{launches}; every request's tokens equal the dense decoder's "
        f"(tie rule)")


# ------------------------------------------------------------ phase 36
PREFILL_T, PREFILL_ROWS = 512, 2


def _serving_lm(device=None):
    """The serving cell's LM (bench.py:434-441; float32, random weights
    from seed 0): phase 3's decoder."""
    from paddle_tpu_torch.models.decode import TransformerDecoder
    from paddle_tpu_torch.params import init_transformer_lm_params
    table = init_transformer_lm_params(FULL, seed=0)
    return table, TransformerDecoder(table, n_layers=FULL["n_layers"],
                                     n_heads=FULL["n_heads"], device=device)


def phase_flash_prefill():
    """Phase 36: a 512-token prompt (2 rows) into the serving cell's LM:
    the prefill logits on the flash route against the einsum route
    (use_flash_attention off) at rtol 2e-4 / atol 2e-4, exactly 6
    launches of the float32 flash forward per prefill and none of the
    others, both prefill times, and generate with and without the route
    agreeing under the tie rule."""
    from paddle_tpu_torch.config import global_config
    from paddle_tpu_torch.models.decode import tokens_agree
    from paddle_tpu_torch.ops import flash_attention as fa

    _, dec = _serving_lm()
    rng = np.random.RandomState(36)
    prompt = rng.randint(0, FULL["vocab_size"],
                         (PREFILL_ROWS, PREFILL_T)).astype(np.int32)
    ids = dec._ids(prompt)

    def prefill(flag):
        global_config().use_flash_attention = flag
        try:
            with torch.no_grad():
                return dec._prefill(ids, FULL["max_len"])[0]
        finally:
            global_config().use_flash_attention = True

    times = {}
    for flag in (True, False):
        prefill(flag)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            prefill(flag)
        torch.cuda.synchronize()
        times[flag] = (time.perf_counter() - t0) / 5 * 1e3
    counts0 = _flash_counts(fa, zero=True)
    lg_f = prefill(True)
    torch.cuda.synchronize()
    counts = _flash_counts(fa)
    lg_e = prefill(False)
    if _flash_counts(fa) != counts:
        raise AssertionError("the einsum prefill launched a flash kernel")
    want = {"fwd": {"sm90": 0, "tf32x3": FULL["n_layers"]},
            "dq": {"sm90": 0, "tf32x3": 0}, "dkv": {"sm90": 0, "tf32x3": 0}}
    if counts != want:
        raise AssertionError(f"flash prefill launches {counts} != {want} "
                             f"(zeroed from {counts0})")
    torch.testing.assert_close(lg_f, lg_e, rtol=2e-4, atol=2e-4)
    err = (lg_f - lg_e).abs().max().item()
    news = PREFILL_ROWS * [FULL["max_len"] - PREFILL_T]
    got = dec.generate(prompt, max_len=FULL["max_len"])
    global_config().use_flash_attention = False
    try:
        plain = dec.generate(prompt, max_len=FULL["max_len"])
        ref = dec.prefill_logits(np.concatenate(
            [prompt, np.asarray(plain)], axis=1))
    finally:
        global_config().use_flash_attention = True
    for i in range(PREFILL_ROWS):
        tol = TIE_ATOL + TIE_RTOL * float(np.abs(ref[i]).max())
        if not tokens_agree(got[i], plain[i], ref[i, PREFILL_T - 1:], tol):
            raise AssertionError(f"flash prefill row {i}: generate differs "
                                 "from the einsum route's")
    log(f"flash prefill ({nvidia_smi_line()}): {PREFILL_ROWS} x "
        f"{PREFILL_T} tokens, float32: flash route {times[True]:.3f} ms, "
        f"einsum route {times[False]:.3f} ms a prefill; logits max|diff| "
        f"{err:.3e} (rtol 2e-4 / atol 2e-4); flash launches by route "
        f"{counts} (one float32 forward a layer); generate of {news[0]} "
        f"tokens agrees with the einsum route (tie rule)")
    return counts["fwd"]["tf32x3"]


# ------------------------------------------------------------ phase 37
BEAM_PROMPTS, BEAM_PLEN, BEAM_MAX_LEN, BEAM_K = 8, 32, 96, 4
BEAM_SCORE_TOL = 1e-4


def phase_beam():
    """Phase 37: beam search on the serving cell's LM, 8 seeded 32-token
    prompts, max_len 96, beam 4, raw-sum then GNMT (alpha 0.6): the
    n-best lists equal the CPU port's same call under ``_beam_same``'s
    near-tie rule; sentences/s; one traced raw-sum search."""
    from paddle_tpu_torch.models.decode import TransformerDecoder

    table, dec = _serving_lm()
    cpu = TransformerDecoder(table, n_layers=FULL["n_layers"],
                             n_heads=FULL["n_heads"], device="cpu")
    rng = np.random.RandomState(37)
    prompts = rng.randint(0, FULL["vocab_size"],
                          (BEAM_PROMPTS, BEAM_PLEN)).astype(np.int32)
    eos = FULL["vocab_size"] - 1
    card = nvidia_smi_line()
    for alpha in (0.0, 0.6):
        kw = dict(max_len=BEAM_MAX_LEN, beam_size=BEAM_K, eos_id=eos,
                  length_penalty=alpha)
        dec.beam_search(prompts, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = dec.beam_search(prompts, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = cpu.beam_search(prompts, **kw)
        gap, tied = _beam_same(f"beam alpha {alpha}", got, want)
        log(f"beam ({card}): alpha {alpha}, {BEAM_PROMPTS} prompts x "
            f"{BEAM_PLEN} tokens, max_len {BEAM_MAX_LEN}, beam {BEAM_K}: "
            f"{wall * 1e3:.3f} ms, {BEAM_PROMPTS / wall:.2f} sentences/s; "
            f"n-best paths equal the CPU port's ({tied} of "
            f"{BEAM_PROMPTS * BEAM_K} ranks ordered within a near-tie), "
            f"scores within {gap:.3e}; best {got[0][0][0]:.4f} over "
            f"{len(got[0][0][1])} tokens")
    _trace(lambda: dec.beam_search(prompts, max_len=BEAM_MAX_LEN,
                                   beam_size=BEAM_K, eos_id=eos),
           "beam", "1 raw-sum search", "sort kernels", ("Sort", "sort"))


def _beam_same(label, got, want):
    """n-best lists against the CPU port's: rank by rank the scores
    within BEAM_SCORE_TOL and the same path, except where the CPU's
    score at that rank ties another of its ranks within the tolerance
    (two correct runs may order such a near-tie either way). Returns
    (the largest score gap, the ranks ordered within a near-tie)."""
    worst, tied = 0.0, 0
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} results, {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        ws = [s for s, _ in w]
        if len(g) != len(w):
            raise AssertionError(f"{label}: prompt {i}: {len(g)} results")
        for j, ((sg, pg), (sw, pw)) in enumerate(zip(g, w)):
            worst = max(worst, abs(sg - sw))
            if pg == pw:
                continue
            if not any(abs(ws[m] - sw) <= BEAM_SCORE_TOL
                       for m in range(len(ws)) if m != j):
                raise AssertionError(
                    f"{label}: prompt {i} rank {j}: path {pg} ({sg}) "
                    f"against the CPU port's {pw} ({sw}), no near-tie")
            tied += 1
    if worst > BEAM_SCORE_TOL:
        raise AssertionError(f"{label}: scores off the CPU port's by "
                             f"{worst}")
    return worst, tied


# ------------------------------------------------------------ phase 38
def masked_lm_demo(paddle, use_tpu=None, pretrain_passes=6,
                   finetune_passes=3, init_tars=None,
                   num_batches_per_pass=None, echo=print):
    """The port copy of demo/masked_lm/train.py, its imports changed to
    the package passed in; ``use_tpu`` False runs on the CPU,
    ``init_tars`` (the encoder's and the classifier's, from another run)
    replace the seeded inits, and ``num_batches_per_pass`` cuts each
    pass. Returns the MLM losses, the fine-tune (cost, error) pairs, the
    loaded trunk parameter count, the encoder's parameter count and the
    two init tars."""
    import importlib
    import io

    import numpy as np
    registry = importlib.import_module(paddle.__name__ + ".core.registry")
    models = importlib.import_module(paddle.__name__ + ".models")
    transformer_classifier = models.transformer_classifier
    transformer_encoder = models.transformer_encoder

    V, T, B = 67, 16, 32
    D, H, L_ = 48, 4, 2
    NUM_CLASSES = 3
    MASK_ID = 0

    def _row(rng):
        a, b = int(rng.randint(1, V)), int(rng.randint(1, V))
        ids = (a + np.arange(T) * b) % (V - 1) + 1       # ids in [1, V)
        return ids.astype("int32"), b % NUM_CLASSES

    def mlm_reader(rng, n_batches):
        def reader():
            for _ in range(n_batches):
                rows = []
                for _ in range(B):
                    ids, _ = _row(rng)
                    mask = rng.rand(T) < 0.25
                    mask[0] = True
                    rows.append((np.where(mask, MASK_ID, ids).astype("int32"),
                                 np.arange(T, dtype="int32"), ids,
                                 mask.astype("float32")[:, None]))
                yield rows
        return reader

    def cls_reader(rng, n_batches):
        def reader():
            for _ in range(n_batches):
                rows = []
                for _ in range(B):
                    ids, label = _row(rng)
                    rows.append((ids, np.arange(T, dtype="int32"), label))
                yield rows
        return reader

    def init_params(topo, i):
        if init_tars is None:
            params = paddle.create_parameters(topo)
        else:
            params = paddle.Parameters.from_tar(io.BytesIO(init_tars[i]))
        buf = io.BytesIO()
        params.to_tar(buf)
        tars.append(buf.getvalue())
        return params

    tars = []
    paddle.init(use_tpu=use_tpu, seed=0)
    rng = np.random.RandomState(7)

    # ---------------- pretrain: masked-LM over the bidirectional trunk
    registry.reset_name_counters()
    enc = transformer_encoder(vocab_size=V, d_model=D, n_heads=H,
                              n_layers=L_, d_ff=2 * D, max_len=T)
    params = init_params(
        paddle.Topology(enc.cost, extra_outputs=[enc.output]), 0)
    pre = paddle.SGD(cost=enc.cost, parameters=params,
                     extra_layers=[enc.output],
                     update_equation=paddle.optimizer.Adam(
                         learning_rate=3e-3))
    mlm_losses = []
    pre.train(mlm_reader(rng, 20), num_passes=pretrain_passes,
              event_handler=lambda e: mlm_losses.append(e.cost)
              if isinstance(e, paddle.event.EndIteration) else None,
              num_batches_per_pass=num_batches_per_pass)
    echo(f"pretrain: first4 {np.mean(mlm_losses[:4]):.3f} -> "
         f"last4 {np.mean(mlm_losses[-4:]):.3f}")

    # ---------------- fine-tune: pooled class head over the SAME trunk
    registry.reset_name_counters()
    cls = transformer_classifier(vocab_size=V, num_classes=NUM_CLASSES,
                                 d_model=D, n_heads=H, n_layers=L_,
                                 d_ff=2 * D, max_len=T)
    cls_params = init_params(paddle.Topology(cls.cost), 1)
    loaded = 0
    for name in cls_params.raw:
        if name in pre.parameters.raw:       # trunk names match
            cls_params.raw[name] = pre.parameters.raw[name]
            loaded += 1
    echo(f"fine-tune: {loaded} trunk parameters loaded from pretraining")
    fin = paddle.SGD(cost=cls.cost, parameters=cls_params,
                     update_equation=paddle.optimizer.Adam(
                         learning_rate=1e-3),
                     extra_layers=cls.extra_layers)
    cls_metrics = []
    fin.train(cls_reader(rng, 20), num_passes=finetune_passes,
              event_handler=lambda e: cls_metrics.append(
                  (e.cost, e.metrics.get(cls.error.name)))
              if isinstance(e, paddle.event.EndIteration) else None,
              num_batches_per_pass=num_batches_per_pass)
    errs = [float(m) for _, m in cls_metrics if m is not None]
    echo(f"fine-tune: error {np.mean(errs[:4]):.3f} -> "
         f"{np.mean(errs[-4:]):.3f}")
    return dict(mlm_losses=mlm_losses, cls_metrics=cls_metrics,
                loaded=loaded, n_params=len(pre.parameters.raw),
                init_tars=tars, trainer=fin)


def phase_masked_lm():
    """Phase 38: the port copy of demo/masked_lm/train.py on the card at
    its own sizes (pretraining 6 passes, fine-tuning 3): the MLM loss
    falls (its last 4 under 0.75 of its first 4, the JAX demo test's
    rule), the fine-tune error falls, every trunk parameter loads, and
    the first 4 MLM costs are within 1e-4 relative of the same copy on
    the CPU port from the card run's init tars."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import config
    lines = []
    t0 = time.perf_counter()
    r = masked_lm_demo(paddle, echo=lines.append)
    wall = time.perf_counter() - t0
    if r["trainer"].device.type != "cuda":
        raise AssertionError(f"the masked-LM script trained on "
                             f"{r['trainer'].device}, not the card")
    mlm = np.asarray(r["mlm_losses"])
    errs = [float(m) for _, m in r["cls_metrics"] if m is not None]
    c = masked_lm_demo(paddle, use_tpu=False, pretrain_passes=1,
                       finetune_passes=1, init_tars=r["init_tars"],
                       echo=_quiet)
    config.init(seed=0, compute_dtype="float32")      # back to the card
    rel = float(np.max(np.abs(mlm[:4] - c["mlm_losses"][:4])
                       / np.abs(c["mlm_losses"][:4])))
    for line in lines:
        log(f"masked lm: {line}")
    if not (np.isfinite(mlm).all() and mlm[-4:].mean()
            < 0.75 * mlm[:4].mean()):
        raise AssertionError(f"masked lm: MLM losses {mlm}")
    if not np.mean(errs[-4:]) < np.mean(errs[:4]):
        raise AssertionError(f"masked lm: fine-tune errors {errs}")
    if r["loaded"] != r["n_params"] - 1 or rel > SEQ2SEQ_CPU_RTOL:
        raise AssertionError(f"masked lm: {r['loaded']} of "
                             f"{r['n_params']} loaded; first costs "
                             f"{mlm[:4]} vs the CPU port's "
                             f"{c['mlm_losses'][:4]}")
    log(f"masked lm ({nvidia_smi_line()}): {len(mlm)} MLM steps and "
        f"{len(errs)} fine-tune steps in {wall:.3f} s; MLM first4 "
        f"{mlm[:4].mean():.4f} -> last4 {mlm[-4:].mean():.4f}; fine-tune "
        f"error {np.mean(errs[:4]):.4f} -> {np.mean(errs[-4:]):.4f}; "
        f"{r['loaded']} trunk parameters loaded; first 4 MLM costs within "
        f"{rel:.3g} relative of the CPU port's")


# ------------------------------------------------------------ phase 39
RAGGED_STEPS = 4
ENCODER = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
               d_ff=2048, max_len=512)
DROPOUT = 0.1


def _ragged_lm_batch(seed=39):
    """TRAIN_ROWS rows of seeded lengths in 256-1024."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(TRAIN_ROWS):
        n = int(rng.randint(256, TRAIN["max_len"] + 1))
        toks = rng.randint(0, TRAIN["vocab_size"], (n + 1,)).astype(np.int32)
        rows.append((toks[:-1], np.arange(n, dtype=np.int32), toks[1:]))
    return rows


def _encoder_batch(seed=40):
    """TRAIN_ROWS masked-LM rows of seeded lengths in 128-512: 15% of
    the tokens masked to id 0, the weight 1.0 there."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(TRAIN_ROWS):
        n = int(rng.randint(128, ENCODER["max_len"] + 1))
        ids = rng.randint(1, ENCODER["vocab_size"], (n,)).astype(np.int32)
        mask = rng.rand(n) < 0.15
        mask[0] = True
        rows.append((np.where(mask, 0, ids).astype(np.int32),
                     np.arange(n, dtype=np.int32), ids,
                     mask.astype(np.float32)[:, None]))
    return rows


def _encoder_spec(compute_dtype):
    from paddle_tpu_torch import config
    from paddle_tpu_torch.core.registry import reset_name_counters
    from paddle_tpu_torch.models import transformer_encoder
    config.init(seed=0, compute_dtype=compute_dtype)
    reset_name_counters()
    return transformer_encoder(**ENCODER)


def _timed_steps(trainer, batch, warmup, steps):
    """(losses, step_ms, flash launches by kernel and route) of
    ``steps`` train_batch calls after ``warmup``."""
    from paddle_tpu_torch.ops import flash_attention as fa
    losses = [trainer.train_batch(batch)[0] for _ in range(warmup)]
    torch.cuda.synchronize()
    _flash_counts(fa, zero=True)
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(trainer.train_batch(batch)[0])
    torch.cuda.synchronize()
    return losses, (time.perf_counter() - t0) / steps * 1e3, \
        _flash_counts(fa)


def _grads_of_kernels(q, k, v, do, lse, dd, kv_lens, causal):
    """(dq, dk, dv) as the bf16 dq and dk/dv kernels compute them, in
    float32 but for their roundings: p and dS = p (dO V^T - D) scale
    recomputed from the saved lse and D, rounded to bf16 as the wgmma
    operands they are, times K (dq), Q (dk) and dO (dv)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    p, ds = fa._recompute(q, k, v, do, lse, dd, None, kv_lens, causal,
                          q.shape[-1] ** -0.5)
    p, ds = (x.to(torch.bfloat16).float() for x in (p, ds))
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()),
            torch.einsum("bhqk,bqhd->bkhd", ds, q.float()),
            torch.einsum("bhqk,bqhd->bkhd", p, do.float()))


def _encoder_grad_check(batch):
    """The encoder's non-causal flash route at full width in bfloat16,
    from one table. (1) Every launch of one step at the shapes and
    values the model gives it — each layer's q, k, v, kv_lens and
    incoming dO, recorded in the kernel route — per (batch row, head)
    slice at phase 6's bf16 bound (dO scaled by a power of two to order
    one): out against autograd of the plain version in float32; dq, dk
    and dv against the plain version of the functions the kernels
    compute (_grads_of_kernels: p and dS rounded to bf16), where the
    two planted faults of dq and of dv (_planted) must fail. Against
    the float32 reference the gradients are printed, not bounded: at
    this init the rows share a large common part, so dq = sum_j dS_j
    K_j and dk = sum_i dS_i Q_i cancel and the bf16 rounding of dS
    shows (measured: dq off by up to 0.53 of a slice's max). (2) The
    cost within 2e-2 of the plain route's. (3)
    Printed, not bounded: each route's gradient distance to a float32
    run of the plain route, and a planted dv x 0.85's — that cancellation
    makes the last layer's q gradient move by as much as the fault
    moves it (PERF.md, PR 20), so phase 7's spread bound cannot hold
    this model."""
    from paddle_tpu_torch.config import global_config
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.trainer import DataFeeder, create

    spec = _encoder_spec("bfloat16")
    topo = Topology(spec.cost)
    params = create(topo, torch.Generator().manual_seed(1)).raw
    feed = DataFeeder(topo.data_type(), device="cuda")(batch)
    n_real = feed.pop("__batch_size__")
    names = sorted(params)
    leaves = [params[k].requires_grad_() for k in names]
    cfg = global_config()
    real_attn, real_dkv = fa.flash_attention, fa.flash_backward_dkv
    calls = []

    def recording(q, k, v, q_lens=None, kv_lens=None, causal=False,
                  scale=None):
        out = real_attn(q, k, v, q_lens, kv_lens, causal, scale)
        rec = [q.detach(), k.detach(), v.detach(), kv_lens, causal]
        out.register_hook(lambda g: rec.append(g.detach().contiguous()))
        calls.append(rec)
        return out

    def faulty_dkv(*args):
        dk, dv = real_dkv(*args)
        return dk, dv * 0.85

    faulty_dkv.launches = 0
    faulty_dkv.route_launches = dict.fromkeys(fa.flash_routes("dkv"), 0)

    def grads(dtype, flash_on, attn=None, dkv=None):
        cfg.compute_dtype, cfg.use_flash_attention = dtype, flash_on
        fa.flash_attention = attn or real_attn
        fa.flash_backward_dkv = dkv or real_dkv
        try:
            outs, _ = topo.forward(params, {}, feed, n_real=n_real)
            cost = outs[spec.cost.name].sum() / n_real
            return cost.item(), torch.autograd.grad(cost, leaves)
        finally:
            cfg.compute_dtype, cfg.use_flash_attention = "bfloat16", True
            fa.flash_attention, fa.flash_backward_dkv = real_attn, real_dkv

    cost_k, g_k = grads("bfloat16", True, attn=recording)
    cost_p, g_p = grads("bfloat16", False)
    cost_32, g_32 = grads("float32", False)
    _, g_bad = grads("bfloat16", True, dkv=faulty_dkv)
    worst, planted = {}, {}
    for rec in calls:
        q, k, v, kv_lens, causal, do = rec
        # dO times a power of two (exact in bf16; dq, dk, dv scale with
        # it) to max |dO| in [1, 2): the slice floor assumes values of
        # order 1, and a token-averaged cost's dO is far below
        do = do * float(2.0 ** -np.floor(np.log2(do.abs().max().item())))
        lens2 = torch.stack([torch.full_like(kv_lens, q.shape[1]),
                             kv_lens], 1).to(torch.int32).contiguous()
        out, lse, dd, dq, dk, dv = _flash_kernels(q, k, v, do, lens2,
                                                  causal)
        qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
        ref = fa.flash_attention_reference(qf, kf, vf, None, kv_lens,
                                           causal, q.shape[-1] ** -0.5)
        gq, gk, gv = torch.autograd.grad(ref, (qf, kf, vf), do.float())
        fq, fk, fv = _grads_of_kernels(q, k, v, do, lse, dd, kv_lens,
                                       causal)
        for name, g, r in (("out", out, ref), ("dq", dq, fq),
                           ("dk", dk, fk), ("dv", dv, fv),
                           ("dq vs float32", dq, gq),
                           ("dk vs float32", dk, gk),
                           ("dv vs float32", dv, gv)):
            worst[name] = max(worst.get(name, 0.0), _slice_ratio(g, r)[0])
        for name, g, r in (("dq", dq, fq), ("dv", dv, fv)):
            for fault, bad in _planted(name, g, r):
                planted[fault] = min(planted.get(fault, np.inf),
                                     _slice_ratio(bad, r)[0])

    def dist(ga):
        return [((a.float() - c.float()).norm() / c.float().norm()).item()
                for a, c in zip(ga, g_32)]

    r_k, r_p, r_bad = dist(g_k), dist(g_p), dist(g_bad)
    i_k = max(range(len(names)), key=lambda i: r_k[i])
    log(f"encoder bfloat16 kernels at the step's {len(calls)} launches "
        f"(shape {tuple(calls[0][0].shape)}, non-causal), per-slice "
        f"max|err|/max|ref|: " + ", ".join(f"{n} {r:.3e}"
                                           for n, r in worst.items())
        + f" (limit {BF16_ATOL} on out and the kernels' own functions, "
        f"_grads_of_kernels); planted "
        f"faults, least ratio: " + ", ".join(f"{n} {r:.3e}"
                                            for n, r in planted.items()))
    log(f"encoder bfloat16 grads over {len(names)} parameters, distance "
        f"to a float32 run of the plain route: kernel route worst "
        f"{r_k[i_k]:.3e} ({names[i_k]}; the plain bf16 route there "
        f"{r_p[i_k]:.3e}, worst {max(r_p):.3e}); planted dv x 0.85 worst "
        f"{max(r_bad):.3e}; costs {cost_k:.6f} (kernels) / {cost_p:.6f} "
        f"(plain) / {cost_32:.6f} (float32)")
    held = [n for n in worst if "float32" not in n]
    if len(calls) != ENCODER["n_layers"] or \
            max(worst[n] for n in held) > BF16_ATOL:
        raise AssertionError(f"encoder: {len(calls)} launches, per-slice "
                             f"ratios {worst}")
    if min(planted.values()) <= BF16_ATOL:
        raise AssertionError(f"encoder: the slice check passes a planted "
                             f"fault: {planted}")
    if abs(cost_k - cost_p) > 2e-2 * abs(cost_p):
        raise AssertionError(f"encoder: cost {cost_k} vs {cost_p}")


def phase_ragged_and_encoder():
    """Phase 39: in bfloat16 at full width, (1) phase 7's LM on ragged
    rows (lengths 256-1024): 2 + 4 steps, tokens/s counted on valid
    tokens, 4 x 6 launches of each bf16 flash kernel, and one cost's
    gradients through the kernels against the plain route (phase 7's
    spread-based bounds and planted fault); (2) transformer_encoder at
    its defaults on ragged masked-LM rows (lengths 128-512): one MLM
    step (6 launches each, the non-causal route), held by
    _encoder_grad_check;
    (3) one LM step with dropout 0.1: its loss finite, and in a
    train-mode forward each residual dropout keeps a share within 5
    sigma of 0.9 and scales what it keeps by 1 / 0.9 exactly."""
    from paddle_tpu_torch import config
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import SGD, DataFeeder, create

    card = nvidia_smi_line()
    want = {"sm90": RAGGED_STEPS * TRAIN["n_layers"], "tf32x3": 0}
    spec = _lm_spec("bfloat16")
    params = create(Topology(spec.cost), torch.Generator().manual_seed(0))
    trainer = SGD(spec.cost, params, Adam(learning_rate=1e-4))
    batch = _ragged_lm_batch()
    valid = sum(len(r[0]) for r in batch)
    losses, step_ms, launches = _timed_steps(trainer, batch, TRAIN_WARMUP,
                                             RAGGED_STEPS)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            any(v != want for v in launches.values()):
        raise AssertionError(f"ragged LM: losses {losses}, launches "
                             f"{launches}")
    log(f"ragged lm ({card}): lengths {[len(r[0]) for r in batch]}, "
        f"{valid} valid tokens, bfloat16, {RAGGED_STEPS} timed steps after "
        f"{TRAIN_WARMUP}: step_ms {step_ms:.3f}, "
        f"{valid / (step_ms / 1e3):.1f} valid tokens/s; losses "
        f"{[round(x, 4) for x in losses]}; flash launches by route "
        f"{launches}")
    del trainer, params
    phase_flash_grad_check(batch, "bfloat16", label="ragged lm bfloat16")

    spec = _encoder_spec("bfloat16")
    params = create(Topology(spec.cost, extra_outputs=[spec.output]),
                    torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in params.raw.values())
    trainer = SGD(spec.cost, params, Adam(learning_rate=1e-4))
    batch = _encoder_batch()
    losses, step_ms, launches = _timed_steps(trainer, batch, 0, 1)
    one = {"sm90": TRAIN["n_layers"], "tf32x3": 0}
    if not np.isfinite(losses[0]) or any(v != one
                                         for v in launches.values()):
        raise AssertionError(f"encoder: loss {losses}, launches {launches}")
    log(f"encoder ({card}): {n_params} parameters, lengths "
        f"{[len(r[0]) for r in batch]}, "
        f"{sum(int(r[3].sum()) for r in batch)} masked tokens, bfloat16, "
        f"one MLM step {step_ms:.3f} ms (first call), cost "
        f"{losses[0]:.4f}; flash launches by route {launches} "
        f"(non-causal)")
    del trainer, params
    _encoder_grad_check(batch)

    spec = _lm_spec("bfloat16", **dict(TRAIN, dropout=DROPOUT))
    topo = Topology(spec.cost)
    params = create(topo, torch.Generator().manual_seed(0))
    trainer = SGD(spec.cost, params, Adam(learning_rate=1e-4))
    batch = _lm_batch()
    loss = trainer.train_batch(batch)[0]
    feed = DataFeeder(topo.data_type(), device="cuda")(batch)
    feed.pop("__batch_size__")
    pairs = [(f"tfm_l{i}_{a}", f"tfm_l{i}_{b}")
             for i in range(TRAIN["n_layers"])
             for a, b in (("proj", "drop1"), ("down", "drop2"))]
    with torch.no_grad():
        outs, _ = topo.forward(params.raw, {}, feed, mode="train", rng=39,
                               output_names=[n for p in pairs for n in p])
    shares = []
    for a, b in pairs:
        x, y = outs[a].data, outs[b].data
        kept = y != 0
        share = kept.float().mean().item()
        sigma = (DROPOUT * (1 - DROPOUT) / kept.numel()) ** 0.5
        if abs(share - (1 - DROPOUT)) > 5 * sigma or not torch.equal(
                y[kept], (x / (1 - DROPOUT))[kept]):
            raise AssertionError(f"dropout {b}: kept share {share}, or "
                                 "kept values not x / (1 - p)")
        shares.append(share)
    if not np.isfinite(loss):
        raise AssertionError(f"dropout LM loss {loss}")
    log(f"dropout lm ({card}): p {DROPOUT}, one bfloat16 step, loss "
        f"{loss:.4f}; kept shares {[round(v, 5) for v in shares]} (0.9 "
        f"within 5 sigma, kept values x / 0.9 exactly)")
    config.init(seed=0, compute_dtype="float32")


# ------------------------------------------------------------ phase 40
# bench.py:194 bench_image at its googlenet_bs128 row (:1573), at
# phase 29's shapes, batch and optimizer; the 2017 reference's own
# figure for this row (BASELINE.md:18, from its benchmark/README.md:50):
# one K40m, not a target
GOOGLENET_K40M_MS = 1149.0


def phase_googlenet():
    """Phase 40: GoogleNet training at bench.py's googlenet_bs128 (224 x
    224 x 3, 1000 classes, batch 128, the bench's Momentum) in bf16 and
    in float32 (TF32 off), with cuDNN's autotuner on for the phase, as
    phase 29 trains ResNet-50 (``_image_train``): step_ms, samples/s,
    model TFLOP/s and peak memory; losses finite and falling on the
    repeated batch, parameters finite; one bf16 step traced. In
    float32, the card's test-mode probabilities of 4 samples against
    the CPU port's on the same weights and inputs."""
    import io

    import paddle_tpu_torch as paddle
    torch.backends.cudnn.benchmark = True
    log("googlenet: torch.backends.cudnn.benchmark on (the warm-up steps "
        "absorb cuDNN's autotuning)")
    batch = _image_samples(RESNET_BATCH, 0)
    out = {}
    trainer, _, feed, out["bfloat16"] = _image_train("googlenet",
                                                     "bfloat16", batch)
    _trace(lambda: trainer._step(feed, RESNET_BATCH, fetch_evals=False),
           "googlenet bf16 train (feed on the card)", "1 step",
           "conv kernels", ("conv", "xmma", "implicit", "cudnn"))
    del trainer, feed
    trainer, spec, _, out["float32"] = _image_train("googlenet", "float32",
                                                    batch)
    for dt, r in out.items():
        log(f"googlenet {dt}: {r['step_ms']:.3f} ms a batch of "
            f"{RESNET_BATCH} against the 2017 reference's "
            f"{GOOGLENET_K40M_MS} ms on one K40m (BASELINE.md:18; its "
            f"figure, not a target)")
    params = trainer.parameters
    samples = [(img,) for img, _ in batch[:RESNET_CHECK_ROWS]]
    probs = paddle.infer(output_layer=spec.output, parameters=params,
                         input=samples, feeding={"image": 0})
    buf = io.BytesIO()
    params.to_tar(buf)
    buf.seek(0)
    cpu_params = paddle.Parameters.from_tar(buf, device="cpu")
    cpu_probs = paddle.infer(output_layer=spec.output, parameters=cpu_params,
                             input=samples, feeding={"image": 0},
                             device="cpu")
    err = float(np.abs(probs - cpu_probs).max())
    if probs.shape != (RESNET_CHECK_ROWS, RESNET["num_classes"]) or \
            not np.all(np.isfinite(probs)) or \
            not np.allclose(probs, cpu_probs, **RESNET_PROBS_TOL):
        raise AssertionError(
            f"googlenet infer: probs {probs.shape}, finite "
            f"{np.all(np.isfinite(probs))}; card against the CPU port's: "
            f"max |diff| {err}, not within {RESNET_PROBS_TOL}")
    log(f"googlenet float32: test-mode probs of {RESNET_CHECK_ROWS} "
        f"samples within {err:.3g} of the CPU port's (held at "
        f"{RESNET_PROBS_TOL}, the largest |p| "
        f"{float(np.abs(cpu_probs).max()):.4f})")
    torch.backends.cudnn.benchmark = False
    del trainer, params
    from paddle_tpu_torch import config
    config.init(seed=0, compute_dtype="float32")
    return out


# ------------------------------------------------------------ phase 41
# the goldens of the layer families, held on the card against the CPU
# port from one init tar (forward and the gradients of a seeded
# projection of the outputs; util_layers has no parameter: the
# gradients of its float feeds)
FAMILY_GOLDENS = ("util_layers", "op_sugar_net", "projections",
                  "misc_utils", "extra_algebra_layers", "selection_layers",
                  "switch_order_net")
GOLDEN_TOL = dict(rtol=1e-4, atol=1e-5)
GOLDEN_LENGTHS = (6, 2, 11)
DEMO_CPU_BATCHES = 8
DEMO_CPU_RTOL = 1e-4


def vae_v2_demo(paddle, use_tpu=None, passes=40, batch_size=128,
                batches_per_pass=10, init_tar=None, echo=print):
    """The port copy of demo/vae/vae_train.py, its imports changed to the
    package passed in; ``use_tpu`` False runs on the CPU and
    ``init_tar`` (another run's) replaces the seeded init. Returns the
    per-pass ELBO losses (the script's history), every batch's cost,
    the prior samples' mean |coordinate| and the init tar."""
    import importlib
    import io

    import numpy as np
    registry = importlib.import_module(paddle.__name__ + ".core.registry")

    NZ = 2           # latent dimension
    DIM = 2          # data dimension

    def build(nz=NZ, dim=DIM, hidden=64):
        L = paddle.layer
        act = paddle.activation

        x = L.data("x", paddle.data_type.dense_vector(dim))
        eps = L.data("eps", paddle.data_type.dense_vector(nz))

        h = L.fc(x, size=hidden, act=act.Relu(), name="enc_h")
        mu = L.fc(h, size=nz, act=None, name="enc_mu")
        logvar = L.fc(h, size=nz, act=None, name="enc_logvar")

        # z = mu + exp(0.5*logvar) * eps
        std = L.addto([L.slope_intercept(logvar, slope=0.5)],
                      act=act.Exp(), name="enc_std")
        z = L.addto([mu, L.dotmul(std, eps)], name="z")

        hd = L.fc(z, size=hidden, act=act.Relu(), name="dec_h")
        recon = L.fc(hd, size=dim, act=None, name="dec_out")

        # ELBO = -(recon_mse + KL); KL = -0.5 * sum(1 + logvar - mu^2 - e^lv)
        mse = L.mse_cost(recon, x, name="recon_cost")
        neg_mu2 = L.slope_intercept(L.dotmul(mu, mu), slope=-1.0)
        neg_expv = L.slope_intercept(L.addto([logvar], act=act.Exp()),
                                     slope=-1.0)
        kl_inner = L.slope_intercept(
            L.addto([logvar, neg_mu2, neg_expv]), slope=-0.5, intercept=-0.5)
        kl = L.sum_cost(kl_inner, name="kl_cost")
        return [mse, kl], x, eps, z, recon

    def data_batch(rng, n):
        """Two tight Gaussian clusters at (+2,+2) and (-2,-2)."""
        which = rng.randint(0, 2, n)
        centers = np.where(which[:, None] == 0, 2.0, -2.0)
        return (centers + 0.3 * rng.randn(n, DIM)).astype("float32")

    paddle.init(use_tpu=use_tpu, seed=0)
    registry.reset_name_counters()
    costs, x_node, eps_node, z_node, recon_node = build()
    params = paddle.create_parameters(paddle.Topology(costs))
    if init_tar is not None:
        params = paddle.Parameters.from_tar(io.BytesIO(init_tar))
    buf = io.BytesIO()
    params.to_tar(buf)
    trainer = paddle.SGD(cost=costs, parameters=params,
                         update_equation=paddle.optimizer.Adam(
                             learning_rate=4e-3))
    rng = np.random.RandomState(0)
    n = batch_size

    hist, batch_costs = [], []
    for p in range(passes):
        for _ in range(batches_per_pass):
            xs = data_batch(rng, n)
            es = rng.randn(n, NZ).astype("float32")
            loss, metrics = trainer.train_batch(
                [(xs[i], es[i]) for i in range(n)])
            batch_costs.append(loss)
        hist.append(loss)
        echo(f"pass {p}: elbo_loss={loss:.4f} "
             f"recon={metrics['recon_cost']:.4f} "
             f"kl={metrics['kl_cost']:.4f}")

    # decode prior samples with the trained decoder weights: they should
    # land near the two clusters (|coords| ~ 2)
    zs = rng.randn(256, NZ).astype("float32")
    w1 = np.asarray(params["_dec_h.w0"])
    b1 = np.asarray(params["_dec_h.wbias"])
    w2 = np.asarray(params["_dec_out.w0"])
    b2 = np.asarray(params["_dec_out.wbias"])
    dec = np.maximum(zs @ w1 + b1, 0.0) @ w2 + b2
    echo(f"prior-sample abs mean: {np.abs(dec).mean(0).round(3)}")
    return dict(hist=hist, costs=batch_costs, init_tar=buf.getvalue(),
                prior_abs_mean=np.abs(dec).mean(0), trainer=trainer)


def quick_start_v2_demo(paddle, use_tpu=None, num_passes=3, batch_size=64,
                        init_tar=None, num_batches_per_pass=None,
                        echo=print):
    """The port copy of demo/quick_start/train.py (the IMDB text CNN with
    AUC), its imports changed to the package passed in; ``use_tpu``
    False runs on the CPU, ``init_tar`` (another run's) replaces the
    seeded init and ``num_batches_per_pass`` cuts each pass. Returns
    every batch's cost, the pass results, the test result's cost and
    metrics and the init tar."""
    import importlib
    import io
    evaluator = importlib.import_module(paddle.__name__ + ".evaluator")
    imdb = importlib.import_module(paddle.__name__ + ".dataset.imdb")
    convolution_net = importlib.import_module(
        paddle.__name__ + ".models.text").convolution_net

    paddle.init(use_tpu=use_tpu, seed=7)

    vocab = len(imdb.word_dict())
    model = convolution_net(vocab_size=vocab, emb_size=64, hidden_size=64)
    parameters = paddle.create_parameters(paddle.Topology(model.cost))
    if init_tar is not None:
        parameters = paddle.Parameters.from_tar(io.BytesIO(init_tar))
    buf = io.BytesIO()
    parameters.to_tar(buf)
    optimizer = paddle.optimizer.Adam(learning_rate=1e-3)
    auc = evaluator.auc(model.output, model.label, name="auc")
    trainer = paddle.SGD(cost=model.cost, parameters=parameters,
                         update_equation=optimizer,
                         extra_layers=model.extra_layers,
                         evaluators=[auc])
    costs, passes = [], []

    def handler(e):
        if isinstance(e, paddle.event.EndIteration):
            costs.append(e.cost)
        if isinstance(e, paddle.event.EndIteration) and e.batch_id % 25 == 0:
            echo(f"pass {e.pass_id} batch {e.batch_id} cost {e.cost:.4f} "
                 f"{e.evaluator}")
        if isinstance(e, paddle.event.EndPass):
            passes.append(dict(e.metrics))
            echo(f"== pass {e.pass_id}: {e.evaluator}")

    reader = paddle.reader.batch(
        paddle.reader.shuffle(imdb.train(), 2048, seed=1),
        batch_size, drop_last=True)
    trainer.train(reader, num_passes=num_passes, event_handler=handler,
                  feeding={"word": 0, "label": 1},
                  num_batches_per_pass=num_batches_per_pass)

    result = trainer.test(
        paddle.reader.batch(imdb.test(), batch_size),
        feeding={"word": 0, "label": 1})
    echo(f"test: cost {result.cost:.4f} {result.evaluator}")
    return dict(costs=costs, passes=passes, test_cost=result.cost,
                test_metrics=dict(result.metrics), init_tar=buf.getvalue(),
                trainer=trainer)


def golden_samples(data_types, seed=4):
    """The golden harness's seeded batch (tests/test_torch_golden.py):
    one sample per entry of GOLDEN_LENGTHS; every sequence column of a
    sample has that length, a nested one cut into seeded subsequences
    of 1-4 steps."""
    rng = np.random.RandomState(seed)
    out = []
    for L in GOLDEN_LENGTHS:
        row = []
        for _, it in data_types:
            seq = it.seq_type.value > 0
            shape = (L,) if seq else ()
            if it.kind == "integer":
                v = rng.randint(0, it.dim, shape).astype(np.int32) \
                    if seq else int(rng.randint(0, it.dim))
            else:
                v = rng.randn(*(shape + (it.dim,))).astype(np.float32)
            if it.seq_type.value == 2:
                cuts, at = [], 0
                while at < L:
                    cuts.append(v[at:at + int(rng.randint(1, 5))])
                    at += len(cuts[-1])
                v = cuts
            row.append(v)
        out.append(tuple(row))
    return out


def _golden_run(topo, tar, samples, device, dtype=torch.float32):
    """Test-mode outputs, then the gradients of a seeded projection of
    the train-mode outputs (of the parameters, or of the float feeds
    where there is none), all as numpy. ``dtype`` float64 runs the
    parameters and float feeds in float64 (a reference run)."""
    import io

    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.trainer import Parameters
    from paddle_tpu_torch.trainer.data_feeder import DataFeeder
    raw = {k: v.to(dtype) for k, v in
           Parameters.from_tar(io.BytesIO(tar), device=device).raw.items()}
    feed = DataFeeder(topo.data_type(), device=device)(samples)
    feed.pop("__batch_size__")
    feed = {k: v.to(dtype) if isinstance(v, torch.Tensor) and
            v.is_floating_point() else v for k, v in feed.items()}
    state = topo.init_state(device=device)
    leaves = {k: v.detach().clone().requires_grad_() for k, v in raw.items()}

    def payload(v):
        return v.data if isinstance(v, SequenceBatch) else v

    outs, _ = topo.forward(leaves, state, feed, mode="test")
    names = [o.name for o in topo.outputs]
    got = {k: payload(outs[k]).detach().cpu().numpy() for k in names}
    rng = np.random.RandomState(9)
    proj = {k: torch.as_tensor(rng.randn(*got[k].shape).astype(np.float32),
                               device=device).to(dtype) for k in names}
    if leaves:
        wrt = dict(sorted(leaves.items()))
    else:
        wrt = {k: v.clone().requires_grad_() for k, v in sorted(feed.items())
               if isinstance(v, torch.Tensor) and v.is_floating_point()}
        feed = dict(feed, **wrt)
    outs, _ = topo.forward(leaves, state, feed, mode="train",
                           output_names=names)
    loss = sum((payload(outs[k]) * proj[k]).sum() for k in names)
    grads = torch.autograd.grad(loss, list(wrt.values()))
    got.update({f"d/d{k}": g.detach().cpu().numpy()
                for k, g in zip(wrt, grads)})
    return got


def _goldens_on_card(names):
    """The goldens ``names`` (tests/golden/) on the card against the CPU
    port, from the CPU port's init tar: {name: (worst |diff|, gradients
    held)}."""
    import io
    import pathlib

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.topology import Topology
    root = pathlib.Path(__file__).resolve().parent / "tests" / "golden"
    worst = {}
    for name in names:
        blob = (root / f"{name}.json").read_text()
        topo = Topology.deserialize(blob)
        if json.loads(topo.serialize()) != json.loads(blob):
            raise AssertionError(f"golden {name}: does not serialize back "
                                 "equal to the file")
        buf = io.BytesIO()
        paddle.create_parameters(topo, device="cpu").to_tar(buf)
        samples = golden_samples(topo.data_type())
        card = _golden_run(topo, buf.getvalue(), samples, "cuda")
        cpu = _golden_run(topo, buf.getvalue(), samples, "cpu")
        if sorted(card) != sorted(cpu):
            raise AssertionError(f"golden {name}: {sorted(card)} against "
                                 f"{sorted(cpu)}")
        err = 0.0
        for k in cpu:
            if card[k].shape != cpu[k].shape or \
                    not np.all(np.isfinite(card[k])) or \
                    not np.allclose(card[k], cpu[k], **GOLDEN_TOL):
                raise AssertionError(
                    f"golden {name} {k}: card against the CPU port's, "
                    f"max |diff| {float(np.abs(card[k] - cpu[k]).max())}, "
                    f"not within {GOLDEN_TOL}")
            err = max(err, float(np.abs(card[k] - cpu[k]).max()))
        worst[name] = (err, len(cpu) - len(topo.outputs))
    return worst


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def phase_layer_families():
    """Phase 41: the layer families on the card. The seven goldens that
    the slice unlocks (util_layers, op_sugar_net, projections,
    misc_utils, extra_algebra_layers, selection_layers,
    switch_order_net) from the CPU port's init tar: outputs and
    gradients against the CPU port's at rtol 1e-4 / atol 1e-5 in
    float32. The port copy of demo/vae at 6 passes of 8 batches: its
    ELBO falls (the last pass under 0.7 of the first, the JAX demo
    test's rule) and its first 8 costs are within 1e-4 relative of the
    same copy on the CPU port from the card run's init tar. The port
    copy of demo/quick_start at its own widths for 1 pass (of the
    script's 3) and its test sweep: its cost and AUC lines, and its
    first 8 costs within 1e-4 relative of the CPU port's."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import config
    from paddle_tpu_torch.core.registry import reset_name_counters
    card = nvidia_smi_line()
    config.init(seed=0, compute_dtype="float32")
    t0 = time.perf_counter()
    worst = _goldens_on_card(FAMILY_GOLDENS)
    log(f"layer families ({card}): {len(worst)} goldens on the card "
        f"against the CPU port in {time.perf_counter() - t0:.3f} s, "
        f"outputs and gradients within {GOLDEN_TOL}; worst |diff| (and "
        f"gradients held) by golden: "
        f"{ {k: (float(f'{e:.3g}'), n) for k, (e, n) in worst.items()} }")

    lines = []
    t0 = time.perf_counter()
    v = vae_v2_demo(paddle, passes=6, batches_per_pass=8, echo=lines.append)
    wall = time.perf_counter() - t0
    if v["trainer"].device.type != "cuda":
        raise AssertionError(f"the vae script trained on "
                             f"{v['trainer'].device}, not the card")
    c = vae_v2_demo(paddle, use_tpu=False, passes=1,
                    batches_per_pass=DEMO_CPU_BATCHES,
                    init_tar=v["init_tar"], echo=_quiet)
    config.init(seed=0, compute_dtype="float32")      # back to the card
    rel = _rel(v["costs"][:DEMO_CPU_BATCHES], c["costs"])
    for line in lines:
        log(f"vae v2: {line}")
    hist = np.asarray(v["hist"])
    if not (np.isfinite(hist).all() and hist[-1] < hist[0] * 0.7) or \
            rel > DEMO_CPU_RTOL:
        raise AssertionError(f"vae v2: elbo per pass {hist}; first costs "
                             f"{v['costs'][:DEMO_CPU_BATCHES]} against the "
                             f"CPU port's {c['costs']}")
    log(f"vae v2 ({card}): {len(v['costs'])} train batches in {wall:.3f} s; "
        f"elbo {hist[0]:.4f} -> {hist[-1]:.4f}; first {DEMO_CPU_BATCHES} "
        f"costs within {rel:.3g} relative of the CPU port's")

    lines = []
    reset_name_counters()             # one set of layer names for both runs
    t0 = time.perf_counter()
    q = quick_start_v2_demo(paddle, num_passes=1, echo=lines.append)
    wall = time.perf_counter() - t0
    if q["trainer"].device.type != "cuda":
        raise AssertionError(f"the quick_start script trained on "
                             f"{q['trainer'].device}, not the card")
    reset_name_counters()
    c = quick_start_v2_demo(paddle, use_tpu=False, num_passes=1,
                            num_batches_per_pass=DEMO_CPU_BATCHES,
                            init_tar=q["init_tar"], echo=_quiet)
    config.init(seed=0, compute_dtype="float32")      # back to the card
    rel = _rel(q["costs"][:DEMO_CPU_BATCHES], c["costs"])
    for line in lines:
        log(f"quick_start v2: {line}")
    n_train = sum(1 for _ in paddle.dataset.imdb.train()())
    test_auc = q["test_metrics"].get("auc")
    if len(q["costs"]) != n_train // 64 or \
            not np.all(np.isfinite(q["costs"])) or \
            not np.isfinite(q["test_cost"]) or test_auc is None or \
            len(c["costs"]) != DEMO_CPU_BATCHES or rel > DEMO_CPU_RTOL:
        raise AssertionError(
            f"quick_start v2: {len(q['costs'])} steps, costs "
            f"{q['costs'][:DEMO_CPU_BATCHES]} against the CPU port's "
            f"{c['costs']}, test {q['test_cost']} {q['test_metrics']}")
    log(f"quick_start v2 ({card}): {len(q['costs'])} train batches and the "
        f"test sweep in {wall:.3f} s; costs {q['costs'][0]:.4f} -> "
        f"{q['costs'][-1]:.4f}, test cost {q['test_cost']:.4f}, test auc "
        f"{float(test_auc):.4f}; first {DEMO_CPU_BATCHES} costs within "
        f"{rel:.3g} relative of the CPU port's")


# ------------------------------------------------------------ phase 42
# C3D (c3d_net, C3D) at c3d_bs30: the paper's batch of 30 clips of 3 x 16
# x 112 x 112, SGD momentum 0.9 at lr 0.003, 487 Sports-1M classes
C3D_BATCH, C3D_WARMUP, C3D_STEPS = 30, 2, 8
C3D_LR, C3D_MOMENTUM = 0.003, 0.9
C3D_CHECK_CLIPS = 2
C3D_PROBS_ATOL = 1e-5
CONV_MARKS = ("conv", "xmma", "implicit", "cudnn")


def _clips(n, seed):
    """A seeded batch of flat channel-major clips and their labels."""
    rng = np.random.RandomState(seed)
    dim = 3 * C3D["depth"] * C3D["height"] * C3D["width"]
    x = rng.randn(n, dim).astype(np.float32)
    lbl = rng.randint(0, C3D["classes"], n)
    return [(x[i], int(lbl[i])) for i in range(n)]


def _c3d_train(compute_dtype, batch):
    """C3D trained in ``compute_dtype`` on one repeated batch put on the
    card once, as phase 29 trains ResNet-50: 2 warm-ups, then 8 timed
    steps of the trainer's step. Losses finite and falling, parameters
    finite, the feed and every parameter on the card. Returns the
    trainer, the topology, the softmax node, the feed, the init tar and
    the step's numbers."""
    import io

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import config
    from paddle_tpu_torch.core.registry import reset_name_counters
    config.init(seed=0, compute_dtype=compute_dtype)
    reset_name_counters()
    cost, out = c3d_net(paddle, **C3D)
    topo = paddle.Topology(cost)
    params = paddle.create_parameters(topo)
    init = io.BytesIO()
    params.to_tar(init)
    trainer = paddle.SGD(cost=cost, parameters=params,
                         update_equation=paddle.optimizer.Momentum(
                             learning_rate=C3D_LR, momentum=C3D_MOMENTUM))
    feed = trainer._feeder(None)(batch)
    n_real = int(feed.pop("__batch_size__"))
    off = [k for k, v in list(feed.items()) + list(params.raw.items())
           if v.device.type != "cuda"]
    if off:
        raise AssertionError(f"c3d {compute_dtype}: {off} not on the card")

    def step():
        return trainer._step(feed, n_real, fetch_evals=False)[0]

    losses = [step() for _ in range(C3D_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(C3D_STEPS):
        losses.append(step())
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / C3D_STEPS * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bad = [k for k, p in params.raw.items()
           if not bool(torch.isfinite(p).all())]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or bad:
        raise AssertionError(f"c3d {compute_dtype}: losses {losses}, "
                             f"non-finite parameters {bad}")
    flops = _model_flops(topo)
    tflops = 3 * flops * C3D_BATCH / (step_ms / 1e3) / 1e12
    n_params = sum(p.numel() for p in params.raw.values())
    log(f"c3d {compute_dtype} ({nvidia_smi_line()}): c3d_bs30, "
        f"{n_params} parameters, batch {C3D_BATCH} of 3 x {C3D['depth']} "
        f"x {C3D['height']} x {C3D['width']}, feed on the card, "
        f"{C3D_STEPS} timed steps after {C3D_WARMUP}: step_ms "
        f"{step_ms:.3f}, {C3D_BATCH / (step_ms / 1e3):.1f} clips/s; model "
        f"FLOPs {flops / 1e9:.4f} G a clip forward, {3 * flops / 1e9:.4f} G "
        f"trained (forward + 2 x forward; convs and fc only), "
        f"{tflops:.1f} TFLOP/s at step_ms; peak {peak_gb:.3f} GB; losses "
        f"{[round(x, 5) for x in losses]}")
    return trainer, topo, out, feed, init.getvalue(), dict(
        step_ms=step_ms, peak_gb=peak_gb, losses=losses, tflops=tflops)


def phase_c3d():
    """Phase 42: C3D (Tran et al., ICCV 2015, section 3.3: eight 3x3x3
    convs, five max pools, fc6 and fc7 of 4096, 487 Sports-1M classes;
    80.0 M parameters) built with the port's DSL (``c3d_net``) and
    trained through SGD with Momentum(0.9, lr 0.003) on 30 seeded clips
    of 3 x 16 x 112 x 112 fed on the card, in bf16 and in float32 (TF32
    off), cuDNN's autotuner on for bf16 (off for float32, where it
    tries algorithms for minutes): step_ms, clips/s, model
    TFLOP/s (77.1 GFLOP a clip forward), peak memory, one traced step
    each; losses finite and falling, the feed and the parameters on the
    card. Its one departure from the paper: no dropout after fc6 and
    fc7, so the card's values can be held against the CPU port's. Then
    the float32 model's test-mode probabilities of 2 clips from the
    init tar, on the card against the CPU port: max |diff| <= 1e-5."""
    import io

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import config
    log("c3d: torch.backends.cudnn.benchmark on for bf16 (the warm-up steps "
        "absorb cuDNN's autotuning), off for float32")
    batch = _clips(C3D_BATCH, 0)
    out = {}
    for dt in ("bfloat16", "float32"):
        # float32 3-D convs: cuDNN's autotuner spent 125 s of one run
        # of this phase trying algorithms; its heuristics pick instead
        torch.backends.cudnn.benchmark = dt == "bfloat16"
        trainer, topo, node, feed, init_tar, out[dt] = _c3d_train(dt, batch)
        _trace(lambda: trainer._step(feed, C3D_BATCH, fetch_evals=False),
               f"c3d {dt} train (feed on the card)", "1 step",
               "conv kernels", CONV_MARKS)
        del trainer, feed
        torch.cuda.empty_cache()
    samples = [(x,) for x, _ in batch[:C3D_CHECK_CLIPS]]
    probs = paddle.infer(output_layer=node, input=samples,
                         parameters=paddle.Parameters.from_tar(
                             io.BytesIO(init_tar)), feeding={"clip": 0})
    cpu_probs = paddle.infer(output_layer=node, input=samples,
                             parameters=paddle.Parameters.from_tar(
                                 io.BytesIO(init_tar), device="cpu"),
                             feeding={"clip": 0}, device="cpu")
    err = float(np.abs(probs - cpu_probs).max())
    if probs.shape != (C3D_CHECK_CLIPS, C3D["classes"]) or \
            not np.all(np.isfinite(probs)) or err > C3D_PROBS_ATOL:
        raise AssertionError(f"c3d infer: probs {probs.shape}, card against "
                             f"the CPU port's max |diff| {err}")
    log(f"c3d float32: test-mode probs of {C3D_CHECK_CLIPS} clips from the "
        f"init tar within {err:.3g} of the CPU port's (held at "
        f"{C3D_PROBS_ATOL}; the largest p {float(cpu_probs.max()):.5f})")
    torch.backends.cudnn.benchmark = False
    config.init(seed=0, compute_dtype="float32")
    return out


# ------------------------------------------------------------ phase 43
SLICE_GOLDENS = ("img_trans_layers", "conv3d_net", "deep_speech_row_conv",
                 "mdlstm_ocr", "ctc_net")
# a larger size of each type against the CPU port: max |card - cpu| of
# each output and gradient over the tensor's max |cpu|
SLICE_TOL = 1e-4
ANCHORED = " [float64 anchor]"
SLICE_TOL64 = 1e-9
SLICE_F32_ANCHOR = 2e-2
SLICE_MAP = dict(n=8, c=256, h=28, w=28)     # a C3D conv3 frame, 8 of them
SLICE_REPS = 3
MDLSTM = dict(b=16, H=32, W=100, h=64)
ROW_CONV = dict(b=16, T=500, d=2048, context=20)
CTC = dict(b=32, T=200, classes=29, U=50)
OCR_CARD = dict(height=32, width=100, hidden=32, classes=37)
SPEECH_CARD = dict(dim=161, hidden=512, context=20, classes=29)
CTC_BATCH, CTC_STEPS, CTC_CPU_STEPS = 16, 8, 2
CTC_CPU_RTOL = 1e-4
# F.ctc_loss computes its gradient by its own alpha-beta formula in
# float32: 2.1e-4 of the largest from autograd of the lattice on the card
CTC_LIBRARY_GRAD_TOL = 1e-3


def _map_samples(n, c, h, w, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c * h * w).astype(np.float32)
    return [(x[i],) for i in range(n)]


def _slice_type_cases():
    """(label, build(paddle) -> output node, samples) of each type at
    one larger size: the 2-D types on 8 maps of 256 x 28 x 28 (a C3D
    conv3 frame), the 3-D ones on 2 C3D conv4 maps, block_expand and
    mdlstm at b 16 over 32 x 100, row_conv at b 16, T 500, d 2048,
    context 20, ctc and warp_ctc at b 32, T 200, 29 classes."""
    m = SLICE_MAP

    def img(p, c=m["c"], h=m["h"], w=m["w"]):
        return p.layer.data("map", p.data_type.dense_vector(c * h * w),
                            height=h, width=w)

    maps = _map_samples(m["n"], m["c"], m["h"], m["w"], 43)
    vol = dict(c=256, d=4, h=14, w=14)

    def volume(p):
        return p.layer.data("vol", p.data_type.dense_vector(
            vol["c"] * vol["d"] * vol["h"] * vol["w"]))

    def v3(kind, p):
        kw = dict(input_depth=vol["d"], num_channels=vol["c"],
                  input_height=vol["h"], input_width=vol["w"])
        if kind == "deconv3d":
            return p.layer.img_conv3d(volume(p), filter_size=3,
                                      num_filters=128, stride=2, padding=1,
                                      trans=True, name="dc3", **kw)
        return p.layer.img_pool3d(volume(p), pool_size=3, stride=2,
                                  padding=1, name="p3",
                                  pool_type=p.pooling.Avg(), **kw)

    vols = _map_samples(2, vol["c"], vol["d"] * vol["h"], vol["w"], 44)
    md = MDLSTM
    rc = ROW_CONV
    rng = np.random.RandomState(45)
    rc_lens = rng.randint(rc["T"] // 2, rc["T"] + 1, rc["b"])
    rc_lens[0] = rc["T"]
    rc_rows = [(rng.randn(n, rc["d"]).astype(np.float32),) for n in rc_lens]
    ct = CTC
    ct_lens = rng.randint(ct["T"] // 2, ct["T"] + 1, ct["b"])
    ct_lens[0] = ct["T"]
    ct_rows = [(rng.randn(n, ct["classes"]).astype(np.float32),
                rng.randint(1, ct["classes"],
                            rng.randint(ct["U"] // 2, ct["U"] + 1))
                .astype(np.int32)) for n in ct_lens]

    def ctc_graph(kind, p):
        x = p.layer.data("frames", p.data_type.dense_vector_sequence(
            ct["classes"]))
        lbl = p.layer.data("lbl", p.data_type.integer_value_sequence(
            ct["classes"]))
        if kind == "ctc":
            x = p.layer.fc(x, size=ct["classes"],
                           act=p.activation.Softmax(), name="probs")
            return p.layer.ctc(x, lbl, size=ct["classes"], blank=0,
                               name="cost")
        x = p.layer.fc(x, size=ct["classes"], name="logits")
        return p.layer.warp_ctc(x, lbl, size=ct["classes"], name="cost")

    def gates(p):
        im = p.layer.data("im", p.data_type.dense_vector(md["H"] * md["W"]),
                          height=md["H"], width=md["W"])
        return p.layer.img_conv(im, filter_size=1, num_filters=5 * md["h"],
                                num_channels=1, name="gates")

    ims = _map_samples(md["b"], 1, md["H"], md["W"], 46)
    shape = f"{m['n']} x {m['c']} x {m['h']} x {m['w']}"
    crop = [m["c"] * 25 // 32, m["h"] - 8, m["w"] - 4]
    vshape = f"2 x {vol['c']} x {vol['d']} x {vol['h']} x {vol['w']}"
    return [
        (f"maxout {shape}, groups 2",
         lambda p: p.layer.maxout(img(p), groups=2), maps),
        (f"spp {shape}, pyramid 3",
         lambda p: p.layer.spp(img(p), pyramid_height=3), maps),
        (f"pad {shape}, c +1/+2, h +1/+1, w +2/+0",
         lambda p: p.layer.pad(img(p), pad_c=[1, 2], pad_h=[1, 1],
                               pad_w=[2, 0]), maps),
        (f"crop {shape} to {crop[0]} x {crop[1]} x {crop[2]}",
         lambda p: p.layer.crop(img(p), shape=crop,
                                offset=[m["c"] // 16, 4, 2]), maps),
        (f"rotate {shape}", lambda p: p.layer.rotate(img(p)), maps),
        (f"bilinear_interp {shape} to 56 x 56",
         lambda p: p.layer.bilinear_interp(img(p), out_size_x=56,
                                           out_size_y=56), maps),
        (f"bilinear_interp {shape} to 17 x 11 (shrink)",
         lambda p: p.layer.bilinear_interp(img(p), out_size_x=11,
                                           out_size_y=17), maps),
        (f"block_expand {shape}, 3 x 3 blocks, stride 2",
         lambda p: p.layer.block_expand(img(p), block_x=3, block_y=3,
                                        stride_x=2, stride_y=2), maps),
        (f"deconv3d {vshape} to 128 x 7 x 27 x 27, k 3, s 2, p 1",
         lambda p: v3("deconv3d", p), vols),
        (f"pool3d avg {vshape}, k 3, s 2, p 1",
         lambda p: v3("pool3d", p), vols),
        (f"mdlstm b {md['b']}, {md['H']} x {md['W']}, h {md['h']} "
         f"({md['H'] + md['W'] - 1} dependent steps, "
         f"{md['H'] * md['W']} cells){ANCHORED}",
         lambda p: p.layer.mdlstm(gates(p), name="md"), ims),
        (f"row_conv b {rc['b']}, T {rc['T']} (ragged), d {rc['d']}, "
         f"context {rc['context']}",
         lambda p: p.layer.row_conv(
             p.layer.data("s", p.data_type.dense_vector_sequence(rc["d"])),
             context_len=rc["context"], name="rc"), rc_rows),
        (f"ctc b {ct['b']}, T {ct['T']} (ragged), {ct['classes']} classes, "
         f"U {ct['U'] // 2}-{ct['U']}", lambda p: ctc_graph("ctc", p),
         ct_rows),
        (f"warp_ctc b {ct['b']}, T {ct['T']} (ragged), {ct['classes']} "
         f"classes, U {ct['U'] // 2}-{ct['U']}",
         lambda p: ctc_graph("warp_ctc", p), ct_rows),
    ]


def _fwd_bwd_ms(topo, tar, samples, reps=SLICE_REPS):
    """Wall ms of one train-mode forward and the backward of a seeded
    projection of the outputs on the card, synchronised (these types
    are eager PyTorch: the host's issue time is part of their cost)."""
    import io

    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.trainer import Parameters
    from paddle_tpu_torch.trainer.data_feeder import DataFeeder
    raw = Parameters.from_tar(io.BytesIO(tar), device="cuda").raw
    feed = DataFeeder(topo.data_type(), device="cuda")(samples)
    feed.pop("__batch_size__")
    state = topo.init_state(device="cuda")
    leaves = {k: v.detach().clone().requires_grad_() for k, v in raw.items()}
    if not leaves:
        leaves_or_feeds = {k: v.clone().requires_grad_()
                           for k, v in feed.items()
                           if isinstance(v, torch.Tensor)
                           and v.is_floating_point()}
        feed = dict(feed, **leaves_or_feeds)
    else:
        leaves_or_feeds = leaves
    names = [o.name for o in topo.outputs]

    def run():
        outs, _ = topo.forward(leaves, state, feed, mode="train",
                               output_names=names)
        loss = sum((o.data if isinstance(o, SequenceBatch) else o)
                   .float().sum() for o in outs.values())
        return torch.autograd.grad(loss, list(leaves_or_feeds.values()))

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _rel_max(got, want):
    """max |got - want| over max |want|."""
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max()) / \
        max(float(np.abs(want).max()), 1e-30)


def _slice_types_on_card():
    """Each case of ``_slice_type_cases`` from the CPU port's init tar:
    outputs and gradients on the card against the CPU port within
    SLICE_TOL of each tensor's max |cpu|, and the card's forward and
    backward timed. An ANCHORED case (mdlstm: its recurrence over the
    grid amplifies float32 rounding; at this size the CPU port's own
    float32 run lies 4e-4 of the output's max from its float64 run) is
    run in float64 on the card and held against the CPU port's float64
    run within SLICE_TOL64, and its float32 run on the card within
    SLICE_F32_ANCHOR of that float64 run."""
    import io

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.registry import reset_name_counters
    for label, build, samples in _slice_type_cases():
        reset_name_counters()
        topo = paddle.Topology(build(paddle))
        buf = io.BytesIO()
        paddle.create_parameters(topo, device="cpu").to_tar(buf)
        tar = buf.getvalue()
        card = _golden_run(topo, tar, samples, "cuda")
        cpu = _golden_run(topo, tar, samples, "cpu")
        checks = [("", card, cpu, SLICE_TOL)]
        if label.endswith(ANCHORED):
            ref = _golden_run(topo, tar, samples, "cpu", torch.float64)
            card64 = _golden_run(topo, tar, samples, "cuda", torch.float64)
            checks = [("float64 ", card64, ref, SLICE_TOL64),
                      ("float32 ", card, ref, SLICE_F32_ANCHOR),
                      ("the CPU port's float32 ", cpu, ref, None)]
        held = []
        for what, got, want, tol in checks:
            worst = 0.0
            for k in want:
                rel = _rel_max(got[k], want[k])
                if tol is not None and (not np.all(np.isfinite(got[k])) or
                                        rel > tol):
                    raise AssertionError(f"{label} {what}{k}: card against "
                                         f"the CPU port, max |diff| / max "
                                         f"|cpu| {rel}, held at {tol}")
                worst = max(worst, rel)
            ref_of = "the CPU port's" if not what else \
                "the CPU port's float64 run"
            held.append(f"{what}outputs and {len(want) - len(topo.outputs)} "
                        f"gradients within {worst:.3g} of {ref_of}"
                        + (f" (held at {tol})" if tol else ""))
        ms = _fwd_bwd_ms(topo, tar, samples)
        log(f"slice type {label}: {'; '.join(held)}, relative to each "
            f"tensor's max; forward + backward {ms:.3f} ms on the card "
            f"(wall, synchronised, {SLICE_REPS} reps)")


def _mdlstm_walks():
    """mdlstm_2d's anti-diagonal walk and its plain cell-by-cell version
    on the card at MDLSTM in float32, forward and backward timed, their
    outputs and gradients within SLICE_F32_ANCHOR of each other (the
    recurrence amplifies float32 rounding; the walk's exactness is held
    in float64 by ``_slice_types_on_card`` and on the CPU against JAX
    by tests/test_torch_ocr_speech.py)."""
    from paddle_tpu_torch.ops import recurrent as rnn
    md = MDLSTM
    g = torch.Generator(device="cuda").manual_seed(47)
    x = torch.randn(md["b"], md["H"], md["W"], 5 * md["h"], device="cuda",
                    generator=g)
    w = torch.randn(md["h"], 5 * md["h"], device="cuda", generator=g) * 0.1
    bias = torch.randn(9 * md["h"], device="cuda", generator=g) * 0.1
    dy = torch.randn(md["b"], md["H"], md["W"], md["h"], device="cuda",
                     generator=g)
    res, ms = {}, {}
    # warm-up: the first backward through the walk's ops loads their
    # kernels (4.4 s of one cold run against 0.3 s warm)
    args = [t.clone().requires_grad_() for t in (x, w, bias)]
    torch.autograd.grad(rnn.mdlstm_2d(*args, reverse_w=True), args, dy)
    for fn in (rnn.mdlstm_2d, rnn.mdlstm_2d_reference):
        args = [t.clone().requires_grad_() for t in (x, w, bias)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fn(*args, reverse_w=True)
        out = [y] + list(torch.autograd.grad(y, args, dy))
        torch.cuda.synchronize()
        ms[fn.__name__] = (time.perf_counter() - t0) * 1e3
        res[fn.__name__] = [t.detach() for t in out]
    err = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(res["mdlstm_2d"], res["mdlstm_2d_reference"]))
    if err > SLICE_F32_ANCHOR:
        raise AssertionError(f"mdlstm walks: {err} apart")
    log(f"mdlstm at b {md['b']}, {md['H']} x {md['W']}, h {md['h']} "
        f"(reverse_w), float32: the anti-diagonal walk "
        f"({md['H'] + md['W'] - 1} dependent steps) "
        f"{ms['mdlstm_2d']:.3f} ms forward + backward, the plain "
        f"cell-by-cell walk ({md['H'] * md['W']} steps) "
        f"{ms['mdlstm_2d_reference']:.3f} ms (wall, synchronised); outputs "
        f"and gradients within {err:.3g} of each other, relative to each "
        f"tensor's max (held at {SLICE_F32_ANCHOR})")


def _ctc_yardstick():
    """ops/ctc.ctc_loss at CTC on the card against F.ctc_loss, a
    yardstick on the same feasible batch (the port never calls it):
    costs within 1e-4 relative, gradients within CTC_LIBRARY_GRAD_TOL
    of the largest, and both timed, forward and backward."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.ctc import ctc_loss
    ct = CTC
    rng = np.random.RandomState(48)
    frames = rng.randint(ct["T"] // 2, ct["T"] + 1, ct["b"])
    ulen = rng.randint(ct["U"] // 2, ct["U"] + 1, ct["b"])
    x = torch.tensor(rng.randn(ct["b"], ct["T"], ct["classes"])
                     .astype(np.float32), device="cuda")
    lab = torch.tensor(rng.randint(1, ct["classes"], (ct["b"], ct["U"])),
                       device="cuda")
    tpos = torch.arange(ct["T"], device="cuda")[None]
    upos = torch.arange(ct["U"], device="cuda")[None]
    fl = torch.tensor(frames, device="cuda")
    ul = torch.tensor(ulen, device="cuda")
    lpad = (tpos >= fl[:, None]).float()
    upad = (upos >= ul[:, None]).float()

    def ours():
        xx = x.clone().requires_grad_()
        cost = ctc_loss(xx, lpad, lab, upad, blank_id=0)
        return cost.detach(), torch.autograd.grad(cost.sum(), xx)[0]

    def library():
        xx = x.clone().requires_grad_()
        cost = F.ctc_loss(torch.log_softmax(xx, -1).transpose(0, 1), lab, fl,
                          ul, blank=0, reduction="none")
        return cost.detach(), torch.autograd.grad(cost.sum(), xx)[0]

    out, ms = {}, {}
    for name, fn in (("ops/ctc.ctc_loss", ours), ("F.ctc_loss", library)):
        out[name] = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SLICE_REPS):
            fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / SLICE_REPS * 1e3
    (c1, g1), (c2, g2) = out["ops/ctc.ctc_loss"], out["F.ctc_loss"]
    rel = float(((c1 - c2).abs() / c2.abs()).max())
    grel = float((g1 - g2).abs().max() / g2.abs().max())
    if rel > 1e-4 or grel > CTC_LIBRARY_GRAD_TOL or \
            not bool(torch.isfinite(c1).all()):
        raise AssertionError(f"ctc against F.ctc_loss: costs {rel}, "
                             f"gradients {grel}")
    log(f"ctc at b {ct['b']}, T {ct['T']} (ragged), {ct['classes']} "
        f"classes, U {ct['U'] // 2}-{ct['U']}: ops/ctc.ctc_loss "
        f"{ms['ops/ctc.ctc_loss']:.3f} ms forward + backward (wall, "
        f"synchronised; a loop over T), F.ctc_loss {ms['F.ctc_loss']:.3f} "
        f"ms (yardstick, never on a path); costs within {rel:.3g} "
        f"relative, gradients within {grel:.3g} of the largest")


def _ocr_samples(n, seed):
    """One-channel images and label rows of 4-12 ids off the blank (the
    last class)."""
    o = OCR_CARD
    rng = np.random.RandomState(seed)
    return [(rng.randn(o["height"] * o["width"]).astype(np.float32),
             rng.randint(0, o["classes"] - 1, rng.randint(4, 13))
             .astype(np.int32)) for _ in range(n)]


def _speech_samples(n, seed):
    """Ragged utterances of 150-300 frames of 161 bins and label rows of
    20-50 ids off the blank (0)."""
    sp = SPEECH_CARD
    rng = np.random.RandomState(seed)
    return [(rng.randn(rng.randint(150, 301), sp["dim"]).astype(np.float32),
             rng.randint(1, sp["classes"], rng.randint(20, 51))
             .astype(np.int32)) for _ in range(n)]


def _ctc_graph_train(label, build, samples):
    """``build(paddle)``'s graph trained CTC_STEPS steps on the card with
    Adam(1e-3) on one repeated batch: costs finite and falling; then the
    first CTC_CPU_STEPS on the CPU port from the card run's init tar,
    within CTC_CPU_RTOL relative."""
    import io

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import config
    from paddle_tpu_torch.core.registry import reset_name_counters
    config.init(seed=0, compute_dtype="float32")
    costs, secs, tar = [], [], io.BytesIO()
    for device, steps in ((None, CTC_STEPS), ("cpu", CTC_CPU_STEPS)):
        reset_name_counters()
        cost = build(paddle)
        if device is None:
            params = paddle.create_parameters(paddle.Topology(cost))
            params.to_tar(tar)
        else:
            params = paddle.Parameters.from_tar(io.BytesIO(tar.getvalue()),
                                                device="cpu")
        trainer = paddle.SGD(cost=cost, parameters=params, device=device,
                             update_equation=paddle.optimizer.Adam(
                                 learning_rate=1e-3))
        if device is None and trainer.device.type != "cuda":
            raise AssertionError(f"{label} trained on {trainer.device}")
        run = []
        for _ in range(steps):
            t0 = time.perf_counter()
            run.append(trainer.train_batch(samples)[0])
            secs.append(time.perf_counter() - t0)
        costs.append(run)
    card, cpu = costs
    rel = _rel(card[:CTC_CPU_STEPS], cpu)
    if not np.all(np.isfinite(card)) or not card[-1] < card[0] or \
            rel > CTC_CPU_RTOL:
        raise AssertionError(f"{label}: card costs {card}, the CPU port's "
                             f"first {cpu}")
    step_ms = float(np.mean(secs[2:CTC_STEPS])) * 1e3
    log(f"{label} ({nvidia_smi_line()}): {CTC_STEPS} train_batch steps on "
        f"the card, costs {card[0]:.4f} -> {card[-1]:.4f}; step_ms "
        f"{step_ms:.3f} (the last {CTC_STEPS - 2}, feeder included), "
        f"{len(samples) / (step_ms / 1e3):.1f} samples/s; first "
        f"{CTC_CPU_STEPS} costs within {rel:.3g} relative of the CPU port's")


def phase_slice_types():
    """Phase 43: the slice's types on the card. The five goldens of the
    slice (img_trans_layers, conv3d_net, deep_speech_row_conv,
    mdlstm_ocr, ctc_net) from the CPU port's init tar: outputs and
    gradients within rtol 1e-4 / atol 1e-5 of the CPU port's. Each type
    at one larger size (``_slice_type_cases``), forward and backward
    against the CPU port (SLICE_TOL of each tensor's max), timed;
    mdlstm's anti-diagonal walk against its plain cell-by-cell version
    at b 16, 32 x 100, h 64, both timed; ctc against F.ctc_loss on a
    feasible batch (a yardstick). Then the OCR stack (ocr_ctc_net: 32 x
    100 images, mdlstm h 32, 37 classes) and the speech stack
    (speech_ctc_net: 161 bins, fc 512, row_conv context 20, 29 classes)
    each trained 8 steps on a batch of 16: costs falling, the first 2
    within 1e-4 relative of the CPU port's."""
    from paddle_tpu_torch import config
    card = nvidia_smi_line()
    config.init(seed=0, compute_dtype="float32")
    t0 = time.perf_counter()
    worst = _goldens_on_card(SLICE_GOLDENS)
    log(f"slice goldens ({card}): {len(worst)} goldens on the card against "
        f"the CPU port in {time.perf_counter() - t0:.3f} s, outputs and "
        f"gradients within {GOLDEN_TOL}; worst |diff| (and gradients held) "
        f"by golden: "
        f"{ {k: (float(f'{e:.3g}'), n) for k, (e, n) in worst.items()} }")
    _slice_types_on_card()
    _mdlstm_walks()
    _ctc_yardstick()
    _ctc_graph_train(
        f"ocr stack ({OCR_CARD['height']} x {OCR_CARD['width']}, mdlstm h "
        f"{OCR_CARD['hidden']}, "
        f"{OCR_CARD['classes']} classes, batch {CTC_BATCH})",
        lambda p: ocr_ctc_net(p, **OCR_CARD), _ocr_samples(CTC_BATCH, 49))
    _ctc_graph_train(
        f"speech stack ({SPEECH_CARD['dim']} bins, fc "
        f"{SPEECH_CARD['hidden']}, row_conv "
        f"{SPEECH_CARD['context']}, {SPEECH_CARD['classes']} classes, batch "
        f"{CTC_BATCH})",
        lambda p: speech_ctc_net(p, **SPEECH_CARD),
        _speech_samples(CTC_BATCH, 50))
    config.init(seed=0, compute_dtype="float32")


# ------------------------------------------------------------ phase 44
SSD = dict(size=300, width_div=1, classes=21)
SSD_BATCH, SSD_WARMUP, SSD_STEPS = 32, 2, 8
SSD_LR, SSD_MOMENTUM = 1e-3, 0.9
SSD_LOSS_RTOL = 1e-4          # the card's first float32 loss against the CPU
SSD_DET_IMAGES, SSD_DET_REPS = 8, 5
SSD_SCORE_TIE, SSD_DET_ATOL = 1e-6, 1e-5
# the multibox loss's parts, read as profiler ranges in a traced step
SSD_RANGES = ("multibox_loss", "multibox_loss.match",
              "multibox_loss.mine")


def _payload_device(v):
    return (v.data if hasattr(v, "lengths") else v).device.type


def _ssd_train(compute_dtype, batch):
    """SSD300 trained in ``compute_dtype`` on one repeated batch put on
    the card once, as phase 42 trains C3D: 2 warm-ups, then 8 timed
    steps of the trainer's step. Losses finite and falling, parameters
    finite, the feed and every parameter on the card, 8,732 priors.
    Returns the trainer, the topology, the detection_output node, the
    feed, the init tar and the step's numbers."""
    import io

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import config
    from paddle_tpu_torch.core.registry import reset_name_counters
    config.init(seed=0, compute_dtype=compute_dtype)
    reset_name_counters()
    cost, det = ssd300_net(paddle, **SSD)
    topo = paddle.Topology(cost)
    n_priors = sum(l.meta.size for l in topo.layers
                   if l.type == "priorbox") // 8
    if n_priors != SSD_PRIORS:
        raise AssertionError(f"ssd300: {n_priors} priors, not {SSD_PRIORS}")
    params = paddle.create_parameters(topo)
    init = io.BytesIO()
    params.to_tar(init)
    trainer = paddle.SGD(cost=cost, parameters=params,
                         update_equation=paddle.optimizer.Momentum(
                             learning_rate=SSD_LR, momentum=SSD_MOMENTUM))
    feed = trainer._feeder(None)(batch)
    n_real = int(feed.pop("__batch_size__"))
    off = [k for k, v in list(feed.items()) + list(params.raw.items())
           if _payload_device(v) != "cuda"]
    if off:
        raise AssertionError(f"ssd300 {compute_dtype}: {off} not on the "
                             "card")

    def step():
        return trainer._step(feed, n_real, fetch_evals=False)[0]

    losses = [step() for _ in range(SSD_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(SSD_STEPS):
        losses.append(step())
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / SSD_STEPS * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bad = [k for k, p in params.raw.items()
           if not bool(torch.isfinite(p).all())]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or bad:
        raise AssertionError(f"ssd300 {compute_dtype}: losses {losses}, "
                             f"non-finite parameters {bad}")
    flops = _model_flops(topo)
    tflops = 3 * flops * SSD_BATCH / (step_ms / 1e3) / 1e12
    n_params = sum(p.numel() for p in params.raw.values())
    log(f"ssd300 {compute_dtype} ({nvidia_smi_line()}): ssd300_bs32, "
        f"{n_params} parameters, {n_priors} priors, batch {SSD_BATCH} of 3 "
        f"x {SSD['size']} x {SSD['size']}, {SSD['classes']} classes, feed "
        f"on the card, {SSD_STEPS} timed steps after {SSD_WARMUP}: step_ms "
        f"{step_ms:.3f}, {SSD_BATCH / (step_ms / 1e3):.1f} images/s; model "
        f"FLOPs {flops / 1e9:.4f} G an image forward, "
        f"{3 * flops / 1e9:.4f} G trained (forward + 2 x forward; convs "
        f"only), {tflops:.1f} TFLOP/s at step_ms; peak {peak_gb:.3f} GB; "
        f"losses {[round(x, 5) for x in losses]}")
    return trainer, topo, det, feed, init.getvalue(), dict(
        step_ms=step_ms, peak_gb=peak_gb, losses=losses, tflops=tflops)


def _ssd_cpu_loss(topo, init_tar, batch):
    """The CPU port's first training loss (the masked mean of the per-
    image costs) from ``init_tar`` on ``batch``."""
    import io

    from paddle_tpu_torch.trainer import Parameters
    from paddle_tpu_torch.trainer.data_feeder import DataFeeder
    raw = Parameters.from_tar(io.BytesIO(init_tar), device="cpu").raw
    feed = DataFeeder(topo.data_type(), device="cpu")(batch)
    n_real = int(feed.pop("__batch_size__"))
    with torch.no_grad():
        outs, _ = topo.forward(raw, topo.init_state(device="cpu"), feed,
                               mode="train")
    return float(sum(v.sum() for v in outs.values())) / n_real


@contextlib.contextmanager
def _multibox_ranges():
    """Profiler ranges around the multibox loss's forward (SSD_RANGES:
    the whole layer, its prior matching and its hard-negative mining),
    put in for one traced step and taken out after."""
    from torch.profiler import record_function

    from paddle_tpu_torch.core.registry import _LAYER_REGISTRY
    from paddle_tpu_torch.layers import detection_layers as dl
    from paddle_tpu_torch.ops import detection as do
    impl = _LAYER_REGISTRY["multibox_loss"]
    saved = (impl["apply"], do.batched_match_priors, dl.hard_negatives)

    def ranged(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    impl["apply"] = ranged(SSD_RANGES[0], saved[0])
    do.batched_match_priors = ranged(SSD_RANGES[1], saved[1])
    dl.hard_negatives = ranged(SSD_RANGES[2], saved[2])
    try:
        yield
    finally:
        impl["apply"], do.batched_match_priors, dl.hard_negatives = saved


def _ssd_trace(run, label):
    """One step under torch.profiler: device busy time against the wall
    clock (the idle share), the top kernels, and the span on the device
    timeline of the multibox loss's forward, its matching and its
    mining (from its first kernel to its last, so the gaps where the
    device waits for the host's launches count) beside the busy
    time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with _multibox_ranges(), profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, ranges, n_kernels = {}, dict.fromkeys(SSD_RANGES, 0.0), 0
    for ev in prof.key_averages():
        if ev.key in ranges:
            ranges[ev.key] = max(ranges[ev.key], ev.device_time_total / 1e3)
        elif ev.device_type.name == "CUDA" and ev.self_device_time_total > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + \
                ev.self_device_time_total / 1e3
            n_kernels += ev.count
    busy_ms = sum(by_kernel.values())
    log(f"{label} trace: 1 step, wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.3f}) in "
        f"{n_kernels} device operations; the multibox loss's forward on "
        f"the device timeline, each range's span: "
        + ", ".join(f"{k} {v:.3f} ms ({v / busy_ms:.4f} of busy)"
                    for k, v in ranges.items())
        + " (a span counts the gaps where the device waits for the "
        "host's launches; the loss's backward is not in them)")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"{label} trace top kernel: {ms:.3f} ms ({ms / busy_ms:.3f} of "
            f"busy)  {name[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, **ranges)


def _ssd_detect(trainer, det, batch):
    """detection_output on SSD_DET_IMAGES images with the trained
    float32 table: one card forward gives the heads and the rows, held
    against the CPU port's detection_output on the card's own heads
    (labels and row order identical, scores and boxes within 1e-5; rows
    whose scores lie within 1e-6 may swap, counted); the layer timed
    alone on the card; then paddle.infer (the Inference path) timed, its
    rows fed with the gt rows to the detection_map evaluator."""
    import io

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.registry import ApplyContext, get_layer_impl
    from paddle_tpu_torch.trainer.data_feeder import DataFeeder
    imgs = batch[:SSD_DET_IMAGES]
    topo = paddle.Topology(det)
    node = topo.by_name[det.name]
    raw = {k: v.detach() for k, v in trainer.parameters.raw.items()
           if k in topo.param_specs}
    feed = DataFeeder(topo.data_type(), device="cuda")([(x,) for x, _ in
                                                        imgs])
    feed.pop("__batch_size__")
    names = [p.name for p in node.parents] + [det.name]
    with torch.no_grad():
        vals, _ = topo.forward(raw, topo.init_state(device="cuda"), feed,
                               mode="test", output_names=names)
    card = vals[det.name].cpu().numpy()
    apply = get_layer_impl("detection_output")["apply"]
    heads = [vals[p.name] for p in node.parents]
    if tuple(heads[0].shape) != (len(imgs), SSD_PRIORS * 8):
        raise AssertionError(f"ssd300 priors on the card: "
                             f"{tuple(heads[0].shape)}")
    cpu = apply(ApplyContext("test", {}), det.name, node.config, {},
                [h.cpu() for h in heads]).numpy()
    swaps = detection_rows_match(card, cpu, SSD_SCORE_TIE, SSD_DET_ATOL)
    times = []
    with torch.no_grad():
        for _ in range(SSD_DET_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            apply(ApplyContext("test", {}), det.name, node.config, {}, heads)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    det_ms = float(np.median(times[1:]))
    buf = io.BytesIO()
    trainer.parameters.to_tar(buf)
    params = paddle.Parameters.from_tar(io.BytesIO(buf.getvalue()))
    t0 = time.perf_counter()
    rows = paddle.infer(output_layer=det, parameters=params,
                        input=[(x,) for x, _ in imgs], feeding={"image": 0})
    infer_ms = (time.perf_counter() - t0) * 1e3
    if rows.shape != card.shape or not np.all(np.isfinite(rows)):
        raise AssertionError(f"ssd300 infer: rows {rows.shape}")
    gt_layer = trainer.topology.by_name["gt"]
    ev = paddle.evaluator.detection_map(det, gt_layer)
    ev.start()
    gt = DataFeeder([("gt", paddle.data_type.dense_vector_sequence(6))],
                    device="cpu")([(g,) for _, g in imgs])["gt"]
    ev.eval_batch([rows, gt], len(imgs))
    m_ap = ev.result()["detection_map"]
    k = min(node.config["nms_top_k"], SSD_PRIORS)
    kept = int((card.reshape(len(imgs), -1, 7)[..., 1] >= 0).sum())
    log(f"ssd300 detection_output ({nvidia_smi_line()}): {len(imgs)} images, "
        f"{SSD_PRIORS} priors, {SSD['classes'] - 1} classes: the NMS loop "
        f"{k} steps over {len(imgs) * (SSD['classes'] - 1)} (image, class) "
        f"rows at once, {det_ms:.3f} ms the layer alone (median of "
        f"{SSD_DET_REPS}, synchronised); paddle.infer (feed, forward, "
        f"host copy) {infer_ms:.3f} ms; {kept} rows kept; card against "
        f"the CPU port on the card's own heads: labels and order "
        f"identical, scores and boxes within {SSD_DET_ATOL}, {swaps} "
        f"near-tie runs (scores within {SSD_SCORE_TIE}) reordered; "
        f"detection_map (11-point, after 10 steps on random data) "
        f"{m_ap:.5f}")
    return dict(det_ms=det_ms, infer_ms=infer_ms, swaps=swaps, m_ap=m_ap,
                nms_steps=k)


def phase_ssd300():
    """Phase 44: SSD300 (Liu et al., ECCV 2016; ssd300_net) at
    ssd300_bs32, trained through SGD with Momentum(0.9, lr 1e-3) under
    multibox_loss on 32 seeded synthetic 300 x 300 images (ssd_samples)
    fed on the card, in bf16 and float32 (TF32 off): step_ms, images/s,
    model TFLOP/s (62.7 GFLOP an image forward), peak memory, one traced
    step each with the multibox loss's share. The first float32 loss
    within 1e-4 relative of the CPU port's from the init tar. Then
    detection_output on 8 images (_ssd_detect)."""
    from paddle_tpu_torch import config
    batch = ssd_samples(SSD_BATCH, SSD["size"], SSD["classes"], seed=0)
    log("ssd300: torch.backends.cudnn.benchmark on for bf16, off for "
        "float32 (as phase 42)")
    out = {}
    for dt in ("bfloat16", "float32"):
        torch.backends.cudnn.benchmark = dt == "bfloat16"
        trainer, topo, det, feed, init_tar, out[dt] = _ssd_train(dt, batch)
        out[dt]["trace"] = _ssd_trace(
            lambda: trainer._step(feed, SSD_BATCH, fetch_evals=False),
            f"ssd300 {dt} train (feed on the card)")
        if dt == "float32":
            t0 = time.perf_counter()
            cpu = _ssd_cpu_loss(topo, init_tar, batch)
            first = out[dt]["losses"][0]
            rel = abs(first - cpu) / abs(cpu)
            log(f"ssd300 float32: first loss {first:.6f} on the card, "
                f"{cpu:.6f} on the CPU port from the init tar (relative "
                f"{rel:.3g}, held at {SSD_LOSS_RTOL}; CPU forward "
                f"{time.perf_counter() - t0:.1f} s)")
            if not rel <= SSD_LOSS_RTOL:
                raise AssertionError(f"ssd300 first loss {first} against "
                                     f"the CPU port's {cpu}")
            out["detect"] = _ssd_detect(trainer, det, batch)
        del trainer, feed
        torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    config.init(seed=0, compute_dtype="float32")
    return out


# ------------------------------------------------------------ phase 45
DET_GOLDENS = ("detection_net", "multibox_net", "nce_hsigmoid")
NCE_CARD = dict(b=1024, d=256, classes=100000, k=20)
NCE_REPS = 10
NCE_TOL = 1e-5                # of each tensor's max |cpu|
GP_TOL = 1e-5
HOUSING_BATCH, HOUSING_LR = 16, 0.1


@contextlib.contextmanager
def _nce_draw(draws):
    """The port's nce layers sample ``draws`` ({layer name: [b, k] ids on
    the CPU}) on whatever device they run, for a card-vs-CPU check."""
    from paddle_tpu_torch.layers import cost_layers
    saved = cost_layers.nce_sample_ids

    def sample(ctx, name, batch, k, num_classes, device):
        return draws[name].to(device)

    cost_layers.nce_sample_ids = sample
    try:
        yield
    finally:
        cost_layers.nce_sample_ids = saved


def _nce_large():
    """nce_loss at NCE_CARD (forward and backward) on the card against
    the CPU port on the same draw, both timed; a full-softmax cross
    entropy over the same classes timed beside it as a yardstick (never
    called on a path)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import cost as cost_ops
    b, d, nc, k = (NCE_CARD[x] for x in ("b", "d", "classes", "k"))
    gen = torch.Generator().manual_seed(45)
    host = [torch.randn(b, d, generator=gen),
            torch.randn(nc, d, generator=gen) * d ** -0.5,
            torch.randn(nc, generator=gen) * 0.1]
    labels = torch.randint(0, nc, (b,), generator=gen)
    ids = torch.randint(0, nc, (b, k), generator=gen)

    def run(dev):
        on = [t.to(dev) for t in host]
        lab, draw = labels.to(dev), ids.to(dev)

        def fwd_bwd():
            leaves = [t.detach().requires_grad_() for t in on]
            loss = cost_ops.nce_loss(*leaves, lab, draw, nc)
            return [loss.detach()] + list(torch.autograd.grad(loss.sum(),
                                                              leaves))
        return fwd_bwd

    nce_card = run("cuda")
    card = [t.cpu() for t in nce_card()]
    cpu = run("cpu")()
    errs = [float((a - c).abs().max() / c.abs().max().clamp(min=1e-30))
            for a, c in zip(card, cpu)]
    if max(errs) > NCE_TOL:
        raise AssertionError(f"nce at {NCE_CARD}: card against the CPU "
                             f"port, relative errors {errs}")
    x, w, bias = [t.cuda() for t in host]
    lab = labels.cuda()

    def softmax_ce():
        leaves = [t.detach().requires_grad_() for t in (x, w, bias)]
        loss = F.cross_entropy(leaves[0] @ leaves[1].t() + leaves[2], lab,
                               reduction="sum")
        return torch.autograd.grad(loss, leaves)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NCE_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / NCE_REPS * 1e3

    nce_ms = timed(nce_card)
    ce_ms = timed(softmax_ce)
    log(f"nce ({nvidia_smi_line()}): b {b}, d {d}, {nc} classes, {k} "
        f"negatives, forward and backward on the card's tensors: "
        f"{nce_ms:.3f} ms (synchronised, mean of {NCE_REPS}), card against the CPU port on one "
        f"draw within {max(errs):.3g} of each tensor's max (held at "
        f"{NCE_TOL}); yardstick, a full-softmax cross entropy over the "
        f"{nc} classes forward and backward: {ce_ms:.3f} ms "
        f"({ce_ms / nce_ms:.2f} x nce)")
    return dict(nce_ms=nce_ms, softmax_ms=ce_ms, err=max(errs))


def gradient_printer_net(paddle):
    """A small fc net with a gradient printer on its hidden layer and
    one on its softmax. Returns (cost, the evaluators)."""
    L, dt, act = paddle.layer, paddle.data_type, paddle.activation
    x = L.data("x", dt.dense_vector(32))
    h = L.fc(x, size=64, act=act.Tanh(), name="h")
    out = L.fc(h, size=10, act=act.Softmax(), name="out")
    lbl = L.data("y", dt.integer_value(10))
    cost = L.classification_cost(out, lbl, name="cost")
    return cost, [paddle.evaluator.gradient_printer(h, stream=io.StringIO()),
                  paddle.evaluator.gradient_printer(out, name="gp_out",
                                                    stream=io.StringIO())]


def _gradient_printer_step(device, init_tar=None):
    """The values each gradient printer of gradient_printer_net receives
    in one SGD step on ``device`` (from ``init_tar`` where given), and
    the init tar."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import config
    from paddle_tpu_torch.core.registry import reset_name_counters
    config.init(seed=0, compute_dtype="float32")
    reset_name_counters()
    cost, evs = gradient_printer_net(paddle)
    params = paddle.create_parameters(paddle.Topology(cost), device="cpu")
    if init_tar is not None:
        params = paddle.Parameters.from_tar(io.BytesIO(init_tar),
                                            device="cpu")
    buf = io.BytesIO()
    params.to_tar(buf)
    seen = {}
    for ev in evs:
        def record(values, n_real, ev=ev, orig=ev.eval_batch):
            seen[ev.name] = np.asarray(values[0])
            orig(values, n_real)
        ev.eval_batch = record
    trainer = paddle.SGD(cost=cost, parameters=params, evaluators=evs,
                         update_equation=paddle.optimizer.Momentum(
                             learning_rate=0.1, momentum=0.9),
                         device=device)
    rng = np.random.RandomState(45)
    data = [(rng.randn(32).astype(np.float32), int(rng.randint(0, 10)))
            for _ in range(64)]
    trainer.train(lambda: iter([data]), num_passes=1,
                  event_handler=lambda e: None)
    return seen, buf.getvalue()


def _housing_fit():
    """dataset.uci_housing's reader feeding fit-a-line (fc(1) on 13
    features, square_error_cost) on the card for one pass: the cost of
    the last batches below the first's."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import config
    from paddle_tpu_torch.core.registry import reset_name_counters
    config.init(seed=0, compute_dtype="float32")
    reset_name_counters()
    L, dt = paddle.layer, paddle.data_type
    x = L.data("x", dt.dense_vector(13))
    y = L.data("y", dt.dense_vector(1))
    pred = L.fc(x, size=1, act=paddle.activation.Linear(), name="pred")
    cost = L.square_error_cost(pred, y, name="cost")
    params = paddle.create_parameters(paddle.Topology(cost))
    trainer = paddle.SGD(cost=cost, parameters=params,
                         update_equation=paddle.optimizer.Momentum(
                             learning_rate=HOUSING_LR, momentum=0.0))
    costs = []
    trainer.train(paddle.reader.batch(paddle.dataset.uci_housing.train(),
                                      HOUSING_BATCH), num_passes=1,
                  event_handler=lambda e: costs.append(e.cost) if isinstance(
                      e, paddle.event.EndIteration) else None)
    if not all(np.isfinite(costs)) or \
            not np.mean(costs[-3:]) < np.mean(costs[:3]):
        raise AssertionError(f"fit-a-line on uci_housing: costs {costs}")
    test = trainer.test(paddle.reader.batch(
        paddle.dataset.uci_housing.test(), HOUSING_BATCH))
    log(f"fit-a-line on dataset.uci_housing (card): {len(costs)} batches "
        f"of {HOUSING_BATCH}, cost {np.mean(costs[:3]):.4f} over the "
        f"first 3 -> {np.mean(costs[-3:]):.4f} over the last 3; test cost "
        f"{test.cost:.4f}")
    return costs


def phase_detection_types():
    """Phase 45: the slice's other parts on the card. The three goldens
    (detection_net, multibox_net, nce_hsigmoid, its nce on one draw
    made on the CPU and passed in) from the CPU port's init tar:
    outputs and gradients within rtol 1e-4 / atol 1e-5 of the CPU
    port's. nce at b 1024, d 256, 100,000 classes, 20 negatives,
    forward and backward against the CPU port, timed beside a
    full-softmax cross entropy. The gradient printer's values from one
    SGD step on the card within 1e-5 of the CPU port's. The uci_housing
    reader through fit-a-line for one pass, the cost falling."""
    from paddle_tpu_torch import config
    card = nvidia_smi_line()
    config.init(seed=0, compute_dtype="float32")
    gen = torch.Generator().manual_seed(23)
    draws = {"nce_cost": torch.randint(0, 32, (len(GOLDEN_LENGTHS), 5),
                                       generator=gen)}
    t0 = time.perf_counter()
    with _nce_draw(draws):
        worst = _goldens_on_card(DET_GOLDENS)
    log(f"detection goldens ({card}): {len(worst)} goldens on the card "
        f"against the CPU port in {time.perf_counter() - t0:.3f} s (nce on "
        f"one CPU draw), outputs and gradients within {GOLDEN_TOL}; worst "
        f"|diff| (and gradients held) by golden: "
        f"{ {k: (float(f'{e:.3g}'), n) for k, (e, n) in worst.items()} }")
    nce = _nce_large()
    card_seen, tar = _gradient_printer_step("cuda")
    cpu_seen, _ = _gradient_printer_step("cpu", tar)
    if sorted(card_seen) != ["gp_out", "gradient_printer"] or \
            sorted(cpu_seen) != sorted(card_seen):
        raise AssertionError(f"gradient printers: {sorted(card_seen)} on "
                             f"the card, {sorted(cpu_seen)} on the CPU")
    gp_err = max(float(np.abs(card_seen[k] - cpu_seen[k]).max())
                 for k in card_seen)
    if gp_err > GP_TOL or not all(np.abs(v).max() > 0
                                  for v in card_seen.values()):
        raise AssertionError(f"gradient printers: card against the CPU "
                             f"port, max |diff| {gp_err}")
    log(f"gradient_printer: one SGD step (batch 64) on the card, the "
        f"activation gradients of {sorted(card_seen)} within {gp_err:.3g} "
        f"of the CPU port's (held at {GP_TOL})")
    _housing_fit()
    config.init(seed=0, compute_dtype="float32")
    return dict(nce=nce, gp_err=gp_err, worst=worst)



def main():
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  (fails outside the checkout)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    log(f"card: {nvidia_smi_line()}")
    phase_build()
    max_err = phase_kernel_vs_plain()
    serve = phase_engine()
    eng, prompts, news = serve["eng"], serve["prompts"], serve["news"]
    launches = serve["launches"]
    timing = phase_timings(eng, prompts, news)
    phase_trace(eng)
    flash_err = phase_flash_vs_plain()
    trainer, batch, flash_launches = phase_train()
    phase_train_trace(trainer, batch)      # still in bfloat16
    phase_flash_grad_check(batch, "bfloat16")
    phase_flash_grad_check(batch, "float32")   # leaves float32 set
    phase_train_to_serve(trainer)
    del trainer
    # phase 24: the default dtype, then one of its steps traced
    trainer, batch, f32_launches = phase_train("float32", F32_TRAIN_STEPS)
    phase_train_trace(trainer, batch, "f32 train")
    del trainer, batch
    flash_timing = phase_flash_timings()
    rnn_err = phase_rnn_vs_plain()
    lstm_spec, lstm_trainer, lstm_batch, lstm_counts = phase_lstm_train()
    # phase 16, still in bfloat16
    phase_train_trace(lstm_trainer, lstm_batch, "lstm train", "LSTM kernels",
                      LSTM_MARKS)
    phase_lstm_grad_check(lstm_batch[:16])             # float32
    infer_counts = phase_lstm_infer(lstm_spec, lstm_trainer)
    del lstm_trainer
    # phase 25: the classifier at the default dtype, then one step traced
    _, f32_trainer, f32_batch, f32_lstm_counts = phase_lstm_train("float32")
    phase_train_trace(f32_trainer, f32_batch, "lstm f32 train",
                      "LSTM kernels", LSTM_MARKS)
    del f32_trainer, f32_batch
    gru_launches = phase_tagger()
    rnn_timing = phase_rnn_timings()
    dequant_err = phase_dequant_vs_plain()
    decode_err, decode_launches = phase_decode_vs_plain(serve)
    del serve["eng"], eng
    int8_eng, dequant_launches = phase_int8_engine(serve)
    phase_speculation(serve)
    two_tier = phase_two_tier(serve)
    tt_timing = phase_two_tier_timings(int8_eng, serve)
    phase_two_tier_trace(two_tier)
    del int8_eng, two_tier
    phase_full_context_timings([len(p) + n for p, n in
                                zip(prompts[:SLOTS], news[:SLOTS])])
    # the v2 scripts last: paddle.init resets the seed and compute dtype
    phase_mnist_v2()
    phase_tagging_v2()
    phase_convergence()
    phase_resnet50()
    nmt = phase_nmt()
    phase_seqtoseq_v2()
    phase_wide_deep()
    phase_recommendation_v2()
    # the transformer family (phases 34-39)
    moe_trainer = phase_moe_train()
    phase_moe_serve(moe_trainer)
    del moe_trainer
    phase_flash_prefill()
    phase_beam()
    phase_masked_lm()
    phase_ragged_and_encoder()
    # the layer families (phases 40-41)
    phase_googlenet()
    phase_layer_families()
    # the 3-D, image-transform and OCR/speech types (phases 42-43)
    phase_c3d()
    phase_slice_types()
    # the detection types, nce, the datasets and gradient_printer
    # (phases 44-45)
    phase_ssd300()
    phase_detection_types()
    kernels = [dict(
        name="paged_window_attention", route="cuda",
        source="paddle_tpu_torch/csrc/paged_window_attention.cu",
        replaces="paddle_tpu/ops/pallas_decode.py:257",
        launches=launches, max_abs_err=max_err, **timing)]
    for name, line, _, src in FLASH_KERNELS:
        kernels.append(dict(
            name=f"flash_attention_{name}", route="cuda",
            source=f"paddle_tpu_torch/csrc/{src}",
            replaces=f"paddle_tpu/ops/pallas_attention.py:{line}",
            launches=flash_launches[name],
            max_abs_err=flash_err[(name, torch.bfloat16)],
            **flash_timing[(name, torch.bfloat16)]))
    for name, line, _, _ in FLASH_KERNELS:
        # float32, the framework's default dtype (phase 24)
        kernels.append(dict(
            name=f"flash_attention_{name}_f32", route="cuda",
            source=f"paddle_tpu_torch/csrc/{FLASH_F32_SOURCES[name]}",
            replaces=f"paddle_tpu/ops/pallas_attention.py:{line}",
            launches=f32_launches[name],
            max_abs_err=flash_err[(name, torch.float32)],
            **flash_timing[(name, torch.float32)]))
    rnn_launches = {"lstm_fwd": lstm_counts["lstm_fwd"],
                    "lstm_bwd": lstm_counts["lstm_bwd"],
                    "gru_fwd": gru_launches + nmt["launches"]}
    for name, line, src in RNN_KERNELS:
        # the LSTM trains in bfloat16 on its main path, the tagger decodes
        # in float32
        dt = torch.float32 if name == "gru_fwd" else torch.bfloat16
        kernels.append(dict(
            name=name, route="cuda", source=f"paddle_tpu_torch/csrc/{src}",
            replaces=f"paddle_tpu/ops/pallas_rnn.py:{line}",
            launches=rnn_launches[name], max_abs_err=rnn_err[name],
            **rnn_timing[(name, dt)]))
    # the GRU's launches by route: the tagger's decode (phase 14) on
    # gru_fwd_sm90.cu, the nmt decode's (phase 30) on the cooperative
    # gru_fwd.cu, with that route's time at the nmt decode's shape
    kernels[-1].update(
        route_launches={"sm90": gru_launches, "coop": nmt["launches"]},
        coop_source="paddle_tpu_torch/csrc/gru_fwd.cu",
        coop_max_abs_err=nmt["err"],
        **{f"coop_{k}": v for k, v in nmt["timing"].items()})
    # the float32 forward, the classifier's infer dtype (phase 13)
    kernels.append(dict(
        name="lstm_fwd_f32", route="cuda",
        source="paddle_tpu_torch/csrc/lstm_fwd_bf16x3_sm90.cu",
        replaces="paddle_tpu/ops/pallas_rnn.py:62",
        launches=infer_counts["lstm_fwd_routes"]["bf16x3"],
        max_abs_err=rnn_err["lstm_fwd_f32"],
        **rnn_timing[("lstm_fwd", torch.float32)]))
    # the float32 backward, the classifier's default training dtype
    # (phase 25)
    kernels.append(dict(
        name="lstm_bwd_f32", route="cuda",
        source="paddle_tpu_torch/csrc/lstm_bwd_bf16x3_sm90.cu",
        replaces="paddle_tpu/ops/pallas_rnn.py:121",
        launches=f32_lstm_counts["lstm_bwd_routes"]["bf16x3"],
        max_abs_err=rnn_err["lstm_bwd_f32"],
        **rnn_timing[("lstm_bwd", torch.float32)]))
    kernels.append(dict(
        name="paged_window_attention_int8", route="cuda",
        source="paddle_tpu_torch/csrc/paged_window_attention.cu",
        replaces="paddle_tpu/ops/pallas_decode.py:322",
        launches=dequant_launches, max_abs_err=dequant_err,
        **tt_timing[("int8", 1, torch.float32)]))
    kernels.append(dict(
        name="decode_attention", route="cuda",
        source="paddle_tpu_torch/csrc/decode_attention.cu",
        replaces="paddle_tpu/ops/pallas_decode.py:112",
        launches=decode_launches, max_abs_err=decode_err,
        **tt_timing[("decode", None, torch.float32)]))
    bad = [k["name"] for k in kernels if k["launches"] < 1]
    if bad:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{bad}")
    log(f"chip_smoke: every phase passed, total wall "
        f"{time.perf_counter() - _T0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
