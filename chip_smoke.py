#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows an error):

1. Prints the card's name and power limit (nvidia-smi), builds every
   CUDA kernel from ``src/repro_torch/csrc`` with nvcc (one nvcc per
   source, all started together) and prints the build time. Then the
   bf16 tensor-core kernels (the prefill forward at head dims 64, 80,
   128 and 192, the backward's dq and dk/dv passes at 64, 80, 128 and
   192, the
   CE forward for both head layouts, the MLA decode's split kernel for
   the paged and the contiguous cache, the SSD and mLSTM scans'
   chunk-state and chunk-scan kernels, and their helpers: the CE and MLA
   merges, the SSD and mLSTM state passings): ptxas's
   registers and spills, the dynamic shared memory of each launch, and
   the count of ``wgmma.mma_async`` and ``cp.async`` in their PTX
   (``nvcc -ptx``) and of HGMMA in their SASS (cuobjdump, where the
   toolkit has it); every product kernel must have both instructions
   and no spill. The tiles the library reports (forward kv tiles, the
   backward's four tiles, the CE tiles, the decode's split length, the
   MLA decode's split, tile and partial length, the SSD scan's row
   tile, the mLSTM scan's row tile and dv slice) must be those the CPU
   models of the tests follow.
2. Serving kernel phase: the prefill and paged-decode kernels against
   their plain PyTorch versions on the card, in fp32 (tolerance 1e-4)
   and bf16 (tolerance 2e-2), at tinyllama-1.1b widths (H=32, Hkv=4,
   D=64). Prefill at buckets 16, 128 and 512 with B=2, plus Sq=Skv=200
   (not a tile multiple); paged decode with B=8, bs=16, ragged kv_lens
   up to 512, NULL holes, one all-NULL inactive slot and one sequence at
   exactly MB*bs; and a longer window (B=8, MB=128, kv_lens up to
   2048). TF32 is off for every fp32 comparison. Each prefill and
   decode case runs twice and must give bitwise-equal outputs. Times
   are CUDA-event medians of 20 runs after warm-up (the decode at both
   windows), and for the decode also the device time of a call (its
   kernels' time under torch.profiler over 20 calls: the call is
   host-bound), SDPA's likewise; ``library_ms`` is
   ``torch.nn.functional.scaled_dot_product_attention`` on the same
   dense inputs, a yardstick the port never calls.
3. Training kernel phase: the prefill forward with its lse and the
   attention backward at olmo-1b heads (H=Hkv=16, D=128) and tinyllama's
   (H=32, Hkv=4, D=64), B=2, S in {512, 1024, 200}, and at head dim 192
   (MLA training: H=8, Hkv=2, S=200, and deepseek-v2's B=5, S=1024,
   H=Hkv=128, the shape phase 18 gives it, timed in bf16); the fused
   cross-entropy forward at T=4096, D=2048, V=50304 with zero weights,
   eps in {0, 0.1}, the head as a (D, V) matrix and as a tied (V, D)
   table; the dlogits pass on a (4096, 50304) tile. Each output is
   held against the plain version's by its relative L2 error, with the
   limits of ``repro_torch.kernels.parity.RTOL`` (per kernel and dtype,
   about 10x the errors read on an H100); every case is printed before
   any is checked. The attention forward and backward and the CE
   forward each run twice and must give bitwise-equal outputs. Each
   kernel is timed at the shape the train phase gives it (B=5 rows of
   1024 tokens a microbatch, T=5120, a 4096-row dlogits chunk); the
   backward and its yardstick also by device time under torch.profiler
   (the kernels' time over 20 calls). Yardsticks: the
   autograd backward of SDPA(is_causal=True);
   ``F.linear`` then ``F.cross_entropy(reduction="none")``, two calls
   (no single PyTorch call fuses the head with the loss); none for the
   dlogits pass (no PyTorch call computes it).
4. Serve path phase: ``repro_torch.launch.serve`` serves tinyllama-1.1b
   at full width (random weights from seed 0, bf16 compute,
   attention_impl="kernel"): 8 slots, prefill batch 2, 16 requests,
   prompts 64-448, generations 16-64, pod speeds 1,0.5. The launch
   counters are zeroed just before and read just after; the run must
   finish every request, launch the prefill kernel once per layer per
   prefill group and the decode kernel once per layer per decode step.
   On the first prefill group and the first decode step the kernel
   path's logits are held against the "reference" path's on the same
   inputs and a copy of the same cache (bf16 tolerance below).
5. Train path phase: ``repro_torch.launch.train`` trains olmo-1b at full
   width (16 layers, d 2048, head dim 128, vocab 50304; random init from
   seed 0, bf16 compute, remat full, attention and cross entropy through
   the kernels) for 6 steps of 8 rows x 1024 tokens, accum 2, on the
   synthetic corpus; the capacity plan's headroom adds 2 weight-0 dummy
   rows to every batch. The counters are zeroed just before and read
   just after. Checks: every loss finite and the last below the first;
   per step, the forward kernel launched twice per layer per microbatch
   (once more under remat), the backward once, the CE forward once per
   microbatch and the dlogits pass once per 4096-token chunk; on the
   first batch, the loss, the grad norm and every gradient leaf (by its
   relative L2 error) agree with the reference path's; the
   HetSeq invariant on the card (the first batch's real rows packed for
   capacities 2,1,1,0 give the single-batch gradient, fp32); a repeated
   step from one state and batch gives bit-identical parameters. One
   more step runs under torch.profiler (device time by kernel), after
   the counters are read.
6. Exchange kernel phase (``csrc/quantize.cu``). Kernels 4 and 5 with
   the TPU kernels' contract (int8 quantize, dequant-accumulate)
   against their plain versions, bitwise (codes, scales, sums): 1, 7,
   1001 and 4099 rows (a partial last block of eight rows), all-zero
   blocks, stochastic rounding with noise from a seeded generator, 1 to
   8 ranks, and the whole olmo-1b gradient stack at bucket_mb 25 over 2
   ranks (4.6 M rows; 2 x 2.3 M for the accumulate). Then the
   exchange's three fused legs (send, receive, decode) against their
   plain legs (``ref.exchange_send``/``_receive``/``_decode``), every
   rank of a chunk run on the card with the collectives done by hand,
   bitwise (wire bytes, gather payloads, both error stages, the decoded
   chunk): ragged messages (a ``d_rows`` inside the last bucket, an
   empty message, 9 ranks), 4099 data rows with noise, the one-bucket
   and chunk shapes and the whole stack (180 buckets, its tail
   padding). Timed at the multi-rank path's shapes, one exchange chunk
   of 40 buckets (kernel 4 at 1,024,000 and 512,000 rows, kernel 5 at
   R=2 x 512,000; each leg on rank 0's chunk) and the overlap
   pipelines' one bucket (phase 15): CUDA-event medians and device time
   under torch.profiler (the one-bucket calls are host-bound), the
   plain version's events, bound by bytes at 3.35 TB/s. No single
   PyTorch call computes any of them (library: none); ``q.float()`` +
   ``einsum`` is timed for information. Last, rank 0's int8 legs of one
   chunk and of one bucket as ``core/buckets.py`` runs them (the
   collectives replaced by a local stand-in): device time and launches
   by kernel.
7. Multi-rank train path phase: ``repro_torch.launch.train --devices
   2,1,1 --grad-reduction hierarchical --compression int8 --bucket-mb
   25 --capacities 2,1`` trains full-width olmo-1b (bf16 compute) on two
   ranks that share the card (gloo), 3 steps of 8 rows x 1024 tokens,
   accum 2. The ranks start from fresh counters and report them back.
   Checks: every loss finite; both ranks end with bitwise-identical
   parameters (a checksum gathered over the group); per rank, launches
   of every kernel as expected (the send leg, the receive leg and the
   decode once per exchange chunk per step, kernels 4 and 5's own entry
   points never); the wire bytes per step per rank
   equal ``modeled_link_bytes``. Then the HetSeq invariant across two
   ranks at full width, depth cut to 2 layers, fp32: the two-rank
   reduced gradient (fp32 and int8 exchange) against one process's on
   the union of the real rows, and one int8 and one fp32 exchange of
   the whole stack timed. Prints ms per step, real tokens/s, the
   peak memory of each rank, the backend and the transport.
8. MLA kernel phase: the absorbed-MLA decode kernels
   (``csrc/mla_decode.cu``) against their plain versions
   (``ref.mla_decode_online_plain`` and its paged twin, which follow the
   Pallas kernels step by step, p cast to the cache dtype) at
   deepseek-v2 widths (H=128, r=512, Dr=64), fp32 (tolerance 1e-4, TF32
   off) and bf16 (2e-2): the paged kernel with phase 2's tables (B=8,
   bs=16, ragged kv_lens up to 512, NULL holes, an all-NULL inactive
   slot whose output must be 0, one sequence at exactly MB*bs) and over
   the longer window (MB=128, kv_lens up to 2048), each run twice and
   bitwise equal; the contiguous kernel at B=8, S in {200, 512, 2048}
   and at the generate shape (B=4, S=1088, every kv_len at 1088, and a
   ragged set), each run twice and bitwise equal, the last sequence
   alone (over its own rows) bitwise equal to itself inside a batch of
   8, and in bf16 also within 2e-3 of its split model
   (``mla_decode_split_plain``); the prefill forward at head dim 192
   (B=2, S in {16, 512, 200}, H=Hkv=128, v zero-padded from 128; each
   run twice, bitwise equal). Timed in bf16 at the MLA paths' shapes
   (the paged decode at B=8, also at the longer window; the contiguous
   decode at the generate shape and at B=8, S=512; each with the device
   time of a call (the contiguous one by launch: split and merge) and of
   SDPA's under torch.profiler; the prefill at the 512 bucket).
   Yardsticks: SDPA as MQA over the (gathered) dense window (q = [q_abs
   | q_r], k = [ckv | kr], v = ckv, a boolean length mask) and SDPA
   causal at head dim 192.
9. MLA serve and generate path phase: ``launch.serve.serve_config``
   serves deepseek-v2-236b at full width (d 5120, 128 heads, 160 routed
   top-6 experts and 2 shared, vocab 102400), depth cut to 8 of 60 layers
   (65.6 GB of bf16 weights), random weights from seed 0, bf16 compute,
   attention_impl="kernel", with phase 4's settings. The counters are
   zeroed just before and read just after; every request must finish,
   every step's logits be finite, the D=192 prefill launch once per
   layer per prefill group and the paged MLA kernel once per layer per
   decode step (the GQA kernels never). On the first prefill group and
   the first decode step the reference path runs on the same inputs and
   a copy of the cache; in bf16 the logit difference and the number of
   tokens whose top-6 experts differ are printed for the record (the
   routing flips on near-ties). Three decode steps run under
   torch.profiler (device time by kernel). The engine and its pool are
   freed, and the same weights generate through
   ``launch.serve.static_generate`` (the contiguous MLA cache): 4
   sequences, a 1024-token prompt, 64 greedy tokens. Every counter (all
   eleven kernels) is zeroed just before and read just after: the
   contiguous MLA decode must launch exactly 8 x 63 = 504 times and the
   D=192 prefill 8 times, every other kernel 0; every step's logits
   finite; prints the prefill ms, the median decode-step ms (host clock
   between two syncs), tokens/s of wall and the peak memory; three
   decode steps and a second prefill run under torch.profiler (device
   time by kernel). Then the gate: the same serve at fp32 (TF32 off) on
   2 layers, where the kernel path's logits must be within 1e-3 of the
   reference path's (relative to the largest reference logit); and on
   its weights ``static_generate`` (B=4, prompt 300, 8 tokens) through
   the kernel path and the reference path gives identical greedy tokens
   with every step's logits within 1e-3 of the largest reference logit,
   and one sequence through the paged engine gives the static path's
   tokens. Each model is freed before the next is built.
10. Zamba2 kernel phase: the Mamba2 SSD chunked-scan kernel
   (``csrc/ssd_scan.cu``) against its plain version (``ref.ssd_chunked``)
   in fp32 (TF32 off) and bf16, by the relative L2 error of y and of the
   final state (``parity.RTOL``): zamba2's prefill shape (B=4, S=1024,
   H=80, P=64, N=64, one group, chunk 256, with D), a ragged tail
   (S=1000), S shorter than the chunk (S=100), two group layouts (G=2,
   H=8; G=3, H=6 at chunk 128) and no D; the prefill kernel at head dim
   80 (zamba2's shared attention block: B=4, S=1024, H=Hkv=32; and two
   small cases) likewise; every case of both runs twice and must be
   bitwise equal. Both timed in bf16 at the generate phase's shapes,
   with the bound, the plain version's time and the library's (SDPA
   causal for the attention; none for the scan, which no PyTorch call
   computes), beside the card's name and power limit; the scan also by
   the device time of each of its three launches (chunk states, state
   passing, chunk scan) under torch.profiler.
11. Zamba2 generate path phase: ``launch.serve.static_generate`` on
   zamba2-2.7b at full width and depth (54 Mamba2 layers, d 2560, 80
   SSM heads of 64, state 64, the shared attention and MLP block after
   every 6 layers; random bf16 weights from seed 0,
   attention_impl="kernel"): 4 sequences, a 1024-token prompt, 64
   generated tokens, after every earlier model is freed. Every counter
   is zeroed just before and read just after: the SSD kernel must
   launch exactly 54 times and the D=80 prefill 9 times (one prefill;
   decode runs neither, as in the JAX package), every other kernel 0.
   Every step's logits finite; prints the prefill ms and the median
   decode-step ms (host clock between two syncs), tokens/s of wall and
   the peak memory; three decode steps and a second prefill run under
   torch.profiler (device time by kernel). Then the fp32 gate (TF32
   off) on 6 layers (one group), prompt 300 (a full chunk and a ragged
   tail), 8 tokens: the kernel path and the reference path give
   identical greedy tokens and every step's logits agree within 1e-3
   of the largest reference logit.
12. xLSTM kernel phase: the mLSTM chunked-scan kernel
   (``csrc/mlstm_scan.cu``) against its plain version
   (``ref.mlstm_chunked``) in fp32 (TF32 off) and bf16, by the relative
   L2 error of h, C, n and m, the largest of the four held to
   ``parity.RTOL``; every case is printed before any is checked:
   xlstm-125m's prefill shape (B=4, S=1024, H=4, dk=dv=384, chunk 256),
   a ragged tail (S=1000), S shorter than the chunk (S=100), the Pallas
   wrapper's chunk of 128, and the smoke widths (dk=dv=64); every case
   of both runs twice and must be bitwise equal. Timed in bf16 at the
   path's shape, with the bound, the plain version's time and library
   none (no PyTorch call computes the scan), beside the card's name and
   power limit; also by the device time of each of its three launches
   (chunk states, state passing, chunk scan) under torch.profiler.
13. xLSTM generate path phase: ``launch.serve.static_generate`` on
   xlstm-125m at full width and depth (12 layers: 6 mLSTM blocks with 4
   heads of 384 and 6 sLSTM blocks, d 768, vocab 50304; random bf16
   weights from seed 0, attention_impl="kernel"): 4 sequences, a
   1024-token prompt (four chunks), 64 generated tokens, after every
   earlier model is freed. Every counter (all eleven kernels) is zeroed
   just before and read just after: the mLSTM kernel must launch
   exactly 6 times (one prefill; decode is the plain recurrence, as in
   the JAX package), every other kernel 0. Every step's logits finite;
   prints the prefill ms and the median decode-step ms (host clock
   between two syncs), tokens/s of wall and the peak memory; three
   decode steps and a second prefill run under torch.profiler (device
   time by kernel), the prefill with its mLSTM and sLSTM blocks timed
   between syncs. Then the fp32 gate (TF32 off) at full depth, prompt
   300 (a full chunk and a ragged tail), 8 tokens: the kernel path and
   the reference path give identical greedy tokens and every step's
   logits agree within 1e-3 of the largest reference logit.
14. Checkpoint and re-mesh path phase: ``repro_torch.launch.train``,
   each run a fresh process under a temporary ``--ckpt-dir`` removed
   after. First the disk: the free bytes there must hold the phase's
   checkpoints (two of olmo-1b at 1 layer, ~2.0 GB each: fp32
   parameters, m and v), or the phase fails. Then phase 5's settings
   (olmo-1b at full width, the depth cut to 1 layer, which keeps the
   script inside its time limit; 8 rows of 1024, accum 2): 24
   steps with a checkpoint every 12 (steps
   2-12 run with no write in flight, steps 13-24 while step 12's write
   is), then ``--resume`` to step 26, then 26 uninterrupted steps; the
   resumed run restores step 24 (its manifest verified), its losses of
   steps 25-26 and its parameter checksum are bitwise the uninterrupted
   run's, and each run's kernel
   counters are phase 5's per step. Then phase 7's settings with
   capacities 1,1, ``--ckpt-every 4 --kill-pod 1@3``, 6 steps, at full
   width with the depth cut to 1 layer (a two-pod checkpoint holds the
   residual of both pods, about twice the bytes; run through the
   driver's ``main`` with the cut registered, as the CLI has no depth
   flag): both ranks raise ``RemeshRequired`` at step 5 with the same
   replans, the run prints ``remesh:``, ``re-meshed to`` and ``accum_steps
   scaled x2``, restarts on one pod from step 4 and finishes step 6 with
   finite losses; the exchange's legs launch as phase 7 expects per step
   on the two-pod mesh, none on the one-pod restart; the saved two-pod residual's sum over the ranks is
   conserved bitwise through the restore's repack into 1 and 3 ranks.
   Prints the bytes of a checkpoint, the loop's wait for the host
   snapshot and for the previous write, the writer thread's seconds
   (write and fsync, sha256), the restore's (manifest check, loading,
   repack), and the median step while a save is in flight against the
   same run's steps with no write in flight, the uninterrupted run's and
   phase 5's, each with the card's name and power limit.
15. Overlap and canonical path phase: phase 7's command three more
   times, the depth cut to 2 layers, with ``--overlap buckets``,
   ``--overlap backward --no-scan-layers`` and that with ``--optimizer
   lamb``: every loss
   finite, both ranks end bitwise equal, per rank the send leg and the
   decode once a bucket a step (25-MiB buckets), the receive leg once a
   bucket whose shard holds data, and kernels 1, 1b, 3, 3b as phase 7,
   the wire bytes of each step the buckets'
   ``modeled_bucket_link_bytes`` summed; ms per step, real tokens/s and
   peak memory printed beside phase 7's (for information). Then the
   exactness probe: two ranks at full width, depth cut to 2 layers,
   fp32 (TF32 off), ``grad_clip=0``, accum 2, 2 steps: with
   ``bucketed_allreduce`` and with hierarchical int8 and error
   feedback, ``buckets`` and ``backward`` must give losses, parameters
   and (int8) the error state bitwise those of ``none``, and the error
   state must be non-zero (the loss and leaf differences are printed
   only). Then
   ``--weighting canonical`` at full width on one rank (phase 5's
   settings, accum 1, 4 steps): finite losses, and per row of every
   step the attention forward twice a layer, its backward once, the CE
   forward and one dlogits chunk; and two ranks at depth 2, fp32, on
   the canonical batches of a 6-row plan under plans (2,1) x3 and
   (1,1) then (3,1) x2: bitwise-equal losses and parameter
   checksums.
16. Pipeline path phase: ``repro_torch.launch.train --pipeline-stages
   2 --no-scan-layers`` with phase 5's settings but the depth cut to 4
   layers, 3 steps and accum 4 (the plan's 12 buffer rows in 4
   microbatches of 3, so 1F1B has a steady state), on one rank, so the
   uniform cut [2, 2]: every loss
   finite, and per step kernel 1 twice a layer a microbatch (remat),
   1b once, 3 once a microbatch, 3b once a 4096-token chunk, kernels 4
   and 5 never. Then the same run with ``--pipe-axis``, two stage ranks
   sharing the card over gloo, to step 2 with its checkpoint there
   (~4.5 GB: fp32 parameters, m and v; the free disk under the temporary
   ``--ckpt-dir`` checked first): losses bitwise the one-process run's,
   each stage rank's launches those of its own layers and (the last) its
   head, and each rank's pipe bytes a step the driver's
   ``modeled_pipe_bytes`` of that step's batch. From the checkpoint, a
   ``--pipe-axis --resume`` run and a ``--resume`` run without the axis
   each take step 3 with the loss and model checksum bitwise the
   one-process run's, their launches those of one step; each stage
   rank's restore holds no more than its stage's part on the card
   (parameters and owned moments, 5% and 256 MiB of slack). Prints the
   checkpoint's bytes, the gather over the pipe group (rank 0's host
   snapshot) and the writer's seconds, each restore's seconds and each
   rank's host and device peak by the end of its restore. Each run
   prints the stage plan, ms per step (median of steps 2..N), real
   tokens/s and peak memory by rank, beside phase 5's. Then the fp32
   exactness probe (TF32 off, ``grad_clip=0``, olmo-1b at full width
   cut to 4 layers, 2 rows of 1024 in 2 microbatches, 3 steps):
   ``pipeline_stages=2`` against ``1`` for allreduce and
   bucketed_allreduce, AdamW and LAMB, 1F1B on the uniform cut [2, 2]
   and GPipe on capacities 3,1's [3, 1]: losses and every parameter
   bitwise equal.
17. The last five archs' phase. (a) Kernel 2 at head dim 128 against
   its plain version with phase 2's tables and lengths at glm4-9b's
   heads (B=8, H=32, Hkv=2), phi4-mini-3.8b's (24, 8) and arctic-480b's
   (56, 8): fp32 (TF32 off) within 1e-5, bf16 within 2e-2, each run
   twice and bitwise equal, the inactive slot exactly 0; timed in bf16
   (ms, device time, plain, SDPA on the gathered window, the bound);
   one sequence alone bitwise itself inside the batch; the library's
   split length ``DECODE_SPLIT``; kernel 1 at D=128 and groups 16 and 7
   against its plain version (phase 2's tolerances, bitwise repeat).
   Phase 1 also prints ptxas's registers and spills of kernel 2's
   instantiations; the D=128 ones must not spill. (b), (c)
   ``serve_config`` serves glm4-9b and phi4-mini-3.8b at full size
   (bf16, seed 0, attention_impl="kernel") with phase 4's trace: every
   request finishes with finite logits, the first prefill group and
   decode step within phase 4's limit of the reference path, kernel 1
   once a layer a prefill group and kernel 2 once a layer a decode step
   (counters zeroed just before, read just after); tokens/s of wall,
   decode steps, median decode-step ms, peak memory. glm4 then runs
   ``static_generate`` on the same weights (4 x 1024-token prompts, 64
   greedy tokens: kernel 1 40 times, nothing else). Each arch's fp32
   gate on 3 layers: ``static_generate`` through the kernel and the
   reference path gives the same tokens, and one sequence through the
   paged engine the static path's. (d) arctic-480b at full width, 2 of
   35 layers, bf16, the same trace and checks (its kernel-vs-reference
   logits printed only: bf16 routing flips on near-ties), then the fp32
   gate on 1 layer (fp32 parameters), one sequence at a time, within
   1e-3 of the largest reference logit. (e) chameleon-34b at full width,
   2 of 48 layers, and (f) musicgen-large at full size, each through
   ``build_train_step`` with phase 5's settings (8 rows of 1024
   embeddings, labels and weights from a seed, 2 dummy rows, accum 2,
   bf16, remat full, 3 steps): finite losses, kernels 1, 1b, 3 and 3b
   launched as phase 5 counts them; ms/step (median of steps 2..3), real
   tokens/s, the model-FLOPs share of 989 TFLOP/s and peak memory; then
   the fp32 probe at 2 layers (kernel path vs plain path, loss, grad
   norm and worst leaf within phase 5's fp32 limits).
18. MoE and MLA training phase: deepseek-v2 at full width, 1 of 60
   layers (5.02 B parameters: 160 experts top-6, two shared experts,
   MLA at head dim 192, vocab 102400 with an untied head), bf16, remat
   full, ``configs.base.optimizer_for``'s bf16 moments, through
   ``build_train_step`` with phase 5's settings (8 rows of 1024 tokens
   of the synthetic corpus, 2 dummy rows, accum 2, 3 steps): finite
   losses, the aux term of ``loss_fn``'s metrics finite and positive,
   kernels 1 and 1b (head dim 192), 3 and 3b launched as phase 5 counts
   them (counters zeroed just before, read just after); ms/step (median
   of steps 2..3), real tokens/s, the model-FLOPs share of 989 TFLOP/s
   with active parameters only (6 of 160 experts), peak memory; one
   more step under torch.profiler (device time by kernel). Then the
   fp32 probe at the same width, fp32 parameters, on 3 rows (2 real, 1
   dummy): kernel path vs plain path, loss, grad norm and worst leaf
   within phase 5's fp32 limits.
19. Mamba2-hybrid training phase. (a) The SSD backward
   (``csrc/ssd_scan_bwd.cu``, no TPU kernel: the JAX package
   differentiates ``ref.ssd_chunked``; fp32 on six CUDA-core kernels,
   bf16 on four tensor-core ones: the chunk states on ``wgmma`` with the
   weighted B and C as bf16 hi/lo pairs, the state passing forward and in
   reverse, one pass over the causal pairs of 64-row tiles a (batch
   row, chunk, group, head slice) that walks its heads in order, and
   the group sums of dB and dC over the head slices) against
   ``ssd_scan_bwd_plain`` in
   fp32 (TF32 off) and bf16, by the relative L2 error of each of its six
   gradients (dx, ddt, dA, dB, dC, dD; the largest held to
   ``parity.RTOL``): zamba2's training microbatch (B=5, S=1024, H=80,
   P=64, N=64, one group, chunk 256, with D), a ragged tail (S=1000), S
   shorter than the chunk (S=100), two groups (G=2, H=8) and no D; (b)
   kernel 1b at head dim 80 against its plain version at the shared
   block's training shape (B=5, S=1024, H=Hkv=32) and a small ragged
   GQA case (S=200, H=8, Hkv=2), fp32 and bf16. Every case is printed
   before any is checked, and runs twice with bitwise-equal outputs.
   Timed in bf16 at the training shapes: ms, device time (the SSD
   backward by each of its four launches), the SSD backward's scratch
   bytes, the bound, the plain
   version's time, the library's (SDPA's autograd backward with
   ``is_causal=True`` for 1b, also by device time; none for the SSD
   backward, which no PyTorch call computes). (c) zamba2-2.7b at full
   width and depth (54 Mamba2 layers, the shared block after every 6:
   2.42 B parameters, fp32, ``optimizer_for``'s fp32 moments), bf16
   compute, remat full (one checkpoint a group), through
   ``build_train_step`` with phase 5's settings (8 rows of 1024 tokens of
   the synthetic corpus, 2 dummy rows, accum 2, 3 steps), after every
   earlier model is freed: finite losses; counters zeroed just before and
   read just after, a step launching the SSD forward 216 times (each
   layer's forward and its group's recompute, 2 microbatches), the SSD
   backward 108, kernel 1 at head dim 80 36 (9 applications, twice a
   microbatch), 1b 18, 3 twice, 3b 4 times (two 4096-token chunks of a
   5,120-token microbatch), every other kernel never; ms/step (median of
   steps 2..3), real tokens/s, the model-FLOPs share of 989 TFLOP/s (6 x
   parameters x tokens, the shared block counted once an application,
   plus the attention's and the scan's own products, forward and
   backward), peak memory; one more step under torch.profiler (device
   time by kernel). (d) The fp32 probe (TF32 off) at full width cut to
   6 layers (one group), fp32 parameters, 3 rows (2 real, 1 dummy): the
   kernel path against the plain path, whose SSD scan runs in fp64
   (``ref.ssd_chunked(acc_dtype=torch.float64)``: the plain path in fp32
   is itself ~8e-5 off that on A_log's gradient, above the leaf limit),
   loss, grad norm and worst leaf within phase 5's fp32 limits; the
   reading against the plain path in fp32 is printed for the record.
20. xLSTM training phase. (a) The mLSTM backward
   (``csrc/mlstm_scan_bwd.cu``, no TPU kernel: the JAX package
   differentiates ``ref.mlstm_chunked``; bf16 on the tensor cores in
   nine launches, fp32 on six CUDA-core kernels) against
   ``mlstm_scan_bwd_plain`` in fp32 (TF32 off)
   and bf16, by the relative L2 error of each of its five gradients (dq,
   dk, dv, di~, df~; the largest held to ``parity.RTOL``): xlstm-125m's
   training microbatch (B=5, S=1024, H=4, dk=dv=384, chunk 256), a
   ragged tail (S=300), S shorter than the chunk (S=100), dk != dv (128,
   256) at chunk 128, and large gates (i~ ~ U(-30, 30), f~ ~ U(-10, 6),
   S=512), the last also against autograd through the reference scan in
   fp64, with the plain version and the reference's own fp32 autograd,
   on phase 20's draw and four more a dtype (every fp32 evaluation
   reads ~1e-4 to ~3e-2 there, by draw): the kernel's median over the
   five draws no further from it than 3x the plain version's (one draw
   can put any two fp32 evaluations far apart). Every case is printed
   before any is checked, and runs twice with bitwise-equal outputs.
   Timed in bf16 at the training shape: ms, device time by each of its
   nine launches, scratch bytes, the bound, the plain version's time,
   library none (no PyTorch call computes it). (b) xlstm-125m at full
   width and depth (6 mLSTM and 6 sLSTM blocks, 173 M parameters, fp32
   moments), bf16 compute, remat full (one checkpoint a pair), through
   ``build_train_step`` with phase 5's settings (8 rows of 1024 tokens of
   the synthetic corpus, 2 dummy rows, accum 2), a warm-up step and one
   timed one (the sLSTM loop holds a step at 34–50 s): finite losses;
   counters zeroed just before and read just after, a step launching
   the mLSTM forward 24 times (each mLSTM block's forward and its pair's
   recompute, 2 microbatches), its backward 12, kernel 3 twice, 3b 4
   times, every other kernel never; ms/step (step 2), real tokens/s,
   the model-FLOPs share of 989 TFLOP/s (6 x parameters x tokens plus
   the scan's own products, forward and backward), peak memory. No profiled step: the sLSTM loop
   is ~hundreds of thousands of launches a step. (c) The fp32 probe
   (TF32 off) at full width cut to one pair (2 layers), fp32 parameters,
   3 rows (2 real, 1 dummy): the kernel path against the plain path,
   whose mLSTM scan runs in fp64
   (``ref.mlstm_chunked(acc_dtype=torch.float64)``), loss, grad norm and
   worst leaf within phase 5's fp32 limits.
21. Prints the seconds of each phase, then one ``{"kernels": [...]}``
   line (seventeen entries: the twelve kernels (kernels 4 and 5 as the
   exchange's three legs, ``exchange_send_cuda``,
   ``exchange_receive_cuda`` and ``exchange_decode_cuda``; kernels 4 and
   5's own entry points, which no path launches, ride in the send and
   receive legs' entries as ``standalone``), kernel 2 at head dim
   128 as ``paged_decode_d128``, with its three head layouts as
   ``cases``, kernel 1b at head dim 192 as
   ``flash_attention_bwd_d192``, its launches phase 18's, the SSD
   backward as ``ssd_scan_bwd`` and kernel 1b at head dim 80 as
   ``flash_attention_bwd_d80``, their launches phase 19's, and the
   mLSTM backward as ``mlstm_scan_bwd``, its launches phase 20's; each with
   its launches on its path, which must
   be above 0; the prefill kernel's D=64 (phase 2's S=512 bucket), D=192
   and D=80 cases ride in its entry as ``at_d64``, ``at_d192`` and
   ``at_d80``, the GQA and MLA paged decodes' longer windows as
   ``at_long_window``, the contiguous MLA decode's B=8, S=512 case as
   ``at_b8_s512``, the exchange legs' one-bucket launches (phase 6,
   the shapes of phase 15's pipelines, with phase 15's launches) as
   ``at_one_bucket``, rank 0's legs of one chunk and one bucket as
   ``exchange_legs``), then, last, ``{"ok": true, "device": {...}}``.
   Details go to ``chiprun_out/chip_smoke.json``.

``python3 chip_smoke.py --cards 4`` (a machine with four cards) runs
only the multi-rank path with one card per rank over NCCL: the phase-7
command on ``--devices 2,1,1`` and on ``--devices 2,2,1`` with
capacities 2,1,1,0 (a dead rank), each with phase 7's checks; on
``--devices 2,2,1`` also with ``--overlap buckets`` and ``--overlap
backward --no-scan-layers``, each with phase 15's per-bucket checks
(launches and wire bytes a bucket, both ranks' parameters equal); then
the invariant and exchange probe on two cards; then phase 16's pipeline
run on ``--devices 2,1 --capacities 3,1`` (two data-parallel ranks,
whose capacities also cut the stages: [12, 4]) and the same with
``--pipe-axis`` on four ranks: the cut, each stage's two ranks equal,
the model's checksum and losses bitwise the two-rank run's, each rank's
launches and pipe bytes as phase 16 checks them, NCCL throughout; then
the re-mesh on stage ranks with phase 16's settings (4 layers) on
``--devices 2,1,1 --capacities 2,1 --global-batch 16 --accum 2
--ckpt-every 2 --kill-pod 1@3 --steps 6``, with ``--pipe-axis`` (four
ranks, the cut [3, 1]) and without (two ranks): every rank meets
``RemeshRequired`` at step 5, the run restarts from the step-4
checkpoint on one pod (two stage ranks on the uniform cut [2, 2],
the change logged; one rank without the axis), and the losses and
model checksum are bitwise those of the run without the axis. The ranks
of every run meet through ``launch/mesh.py::spawn``'s file store.
Details go to ``chiprun_out/chip_smoke_cards.json``; the last line is
the same.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"

FP32_TOL = 1e-4
BF16_TOL = 2e-2
# the bf16 contiguous MLA decode against its split model, which follows
# the kernel's tiles, splits and rounding: about 4x the largest gap read
# on the card (5.4e-4)
SPLIT_MODEL_TOL = 2e-3
# Kernel path vs reference path logits of the whole 22-layer model in
# bf16: the two paths round attention at different points, and the
# difference compounds through the layers. Relative to the largest
# reference logit (at least 1).
LOGIT_TOL = 5e-2
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA data sheet (SXM)
H100_BF16_FLOPS = 989e12            # dense tensor-core bf16
REPS = 20
# rows x tokens of one train-phase microbatch: 8 rows + 2 dummy rows of
# headroom, accum 2
TRAIN_MICROBATCH = (5, 1024)
# the attention of one phase-18 microbatch (deepseek-v2's MLA): B, S, H,
# Hkv, D
DEEPSEEK_MICROBATCH = (5, 1024, 128, 128, 192)

SERVE_ARGV = ["--arch", "tinyllama-1.1b", "--device", "cuda",
              "--attention-impl", "kernel", "--seed", "0",
              "--slots", "8", "--prefill-batch", "2", "--requests", "16",
              "--min-prompt", "64", "--max-prompt", "448",
              "--min-gen", "16", "--max-gen", "64",
              "--pod-speeds", "1,0.5"]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int = REPS):
    """Median ms of ``reps`` calls, each between two CUDA events, after
    three warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = REPS):
    """Device time of one call: the kernels torch.profiler sees over
    ``reps`` calls after three warm-up calls, summed, over ``reps``. Where
    a call is host-bound, :func:`cuda_ms` reads the host's time and this
    the card's. The profiler's trace can come back without kernels: then
    it is taken once more, and a second empty trace gives None (not
    measured)."""
    by_kernel = device_ms_by_kernel(fn, reps)
    return by_kernel and sum(by_kernel.values())


def device_ms_by_kernel(fn, reps: int = REPS):
    """:func:`device_ms` by kernel name."""
    by_name = device_profile(fn, reps)
    return by_name and {n: ms for n, (_, ms) in by_name.items()}


def device_profile(fn, reps: int = REPS):
    """Launches and device ms of one call, by kernel name: (count, ms)
    over ``reps`` calls under torch.profiler after three warm-up calls,
    each over ``reps``; None when two traces come back without
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = _kernel_times(prof)
        if by_name:
            return {n: (c / reps, us / reps / 1e3)
                    for n, (c, us) in by_name.items()}
    return None


def _ms_or_not(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


# --------------------------------------------------------------------------
# the bf16 tensor-core kernels: what the compiler made of them
# --------------------------------------------------------------------------

SM90_SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu",
                "cross_entropy.cu", "mla_decode.cu", "ssd_scan.cu",
                "mlstm_scan.cu", "ssd_scan_bwd.cu", "mlstm_scan_bwd.cu")
# the bf16 kernels' entry points that run no product: merges, the SSD
# and mLSTM state passings, the SSD backward's state passing and group
# sums, the mLSTM backward's two state passings
SM90_HELPERS = ("ce_merge", "mla_merge", "ssd_state_pass",
                "mlstm_state_pass", "ssd_bwd_pass_sm90",
                "ssd_bwd_group_sm90", "mlstm_bwd_fpass_sm90",
                "mlstm_bwd_rpass_sm90")
# the mLSTM backward's product kernels in bf16, each with its index in
# mlstm_scan_bwd_sm90_smem
MLSTM_BWD_PRODUCTS = {"mlstm_bwd_cstate_sm90": 0, "mlstm_bwd_x_sm90": 3,
                      "mlstm_bwd_rows_sm90": 1, "mlstm_bwd_lstate_sm90": 0,
                      "mlstm_bwd_cols_sm90": 2}
# the SSD backward's bf16 kernels, by their order in one call
SSD_BWD_LAUNCHES = ("ssd_bwd_states_sm90", "ssd_bwd_pass_sm90",
                    "ssd_bwd_pairs_sm90", "ssd_bwd_group_sm90")
# the mLSTM scan's bf16 kernels, by their order in one call
MLSTM_LAUNCHES = ("mlstm_chunk_state_sm90", "mlstm_state_pass",
                  "mlstm_chunk_scan_sm90")


def _sm90_name(mangled: str):
    """A short name for the bf16 tensor-core kernels' entry points (the
    product kernels and their helpers: the CE and MLA merges, the SSD
    and mLSTM state passings), None for any other."""
    import re
    for name in ("ssd_chunk_state_sm90", "ssd_chunk_scan_sm90",
                 "mlstm_chunk_state_sm90", "mlstm_chunk_scan_sm90",
                 "ssd_bwd_states_sm90") + tuple(MLSTM_BWD_PRODUCTS) \
            + SM90_HELPERS[1:]:
        if name in mangled:
            return name
    m = re.search(r"ssd_bwd_pairs_sm90ILi(\d+)E", mangled)
    if m:
        return f"ssd_bwd_pairs_sm90<P={m.group(1)}>"
    m = re.search(r"mla_split_sm90ILb([01])E", mangled)
    if m:
        return "mla_split_sm90<" + ("paged" if m.group(1) == "1"
                                    else "contiguous") + ">"
    m = re.search(r"flash_fwd_sm90ILi(\d+)E", mangled)
    if m:
        return f"flash_fwd_sm90<D={m.group(1)}>"
    m = re.search(r"flash_bwd_(dq|dkv)_sm90ILi(\d+)E", mangled)
    if m:
        return f"flash_bwd_{m.group(1)}_sm90<D={m.group(2)}>"
    m = re.search(r"ce_fwd_sm90ILi(\d)E", mangled)
    if m:
        return "ce_fwd_sm90<" + ("(D, V) head" if m.group(1) == "1"
                                 else "tied (V, D) head") + ">"
    return "ce_merge" if "ce_merge" in mangled else None


def _by_entry(text: str, start_re: str):
    """Split compiler output into {short name: body} at each entry point
    that ``start_re`` (one group: the mangled name) finds."""
    import re
    marks = [(m.start(), m.group(1)) for m in re.finditer(start_re, text)]
    out = {}
    for i, (pos, mangled) in enumerate(marks):
        name = _sm90_name(mangled)
        if name:
            end = marks[i + 1][0] if i + 1 < len(marks) else len(text)
            out[name] = out.get(name, "") + text[pos:end]
    return out


def decode_ptxas_report(build):
    """ptxas's registers and spills of the GQA paged decode's split and
    merge kernels at each head dim and dtype built; the D=128 ones
    (phase 17's) must not spill."""
    import re
    log = build.ptxas_log()
    marks = [(m.start(), m.group(1)) for m in re.finditer(
        r"Compiling entry function '(\S+)'", log)]
    rows = {}
    for i, (pos, mangled) in enumerate(marks):
        m = re.search(r"paged_decode_(split|merge)I(f|13__nv_bfloat16)Li"
                      r"(\d+)E", mangled)
        if not m:
            continue
        body = log[pos:marks[i + 1][0] if i + 1 < len(marks) else len(log)]
        name = (f"paged_decode_{m.group(1)}<"
                f"{'fp32' if m.group(2) == 'f' else 'bf16'}, "
                f"D={m.group(3)}>")
        regs = re.findall(r"Used (\d+) registers", body)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", body)
        rows[name] = {"registers": int(regs[0]),
                      "spill_bytes": sum(int(a) + int(b)
                                         for a, b in spills)}
        print(f"[decode] {name}: {rows[name]['registers']} registers, "
              f"{rows[name]['spill_bytes']} bytes spilled", flush=True)
    check(len(rows) == 8, f"paged decode instantiations found: "
          f"{sorted(rows)}")
    for name, r in rows.items():
        check("D=128" not in name or r["spill_bytes"] == 0,
              f"{name}: ptxas spilled {r['spill_bytes']} bytes")
    return rows


def sm90_report(build, lib, fa, ce, md, sk, mk):
    """ptxas's registers and spills of the bf16 tensor-core kernels, the
    dynamic shared memory each launch asks for, the tiles each takes
    (held equal to those the CPU models of the tests follow: ``KV_TILES``,
    ``BWD_TILES``, ``TOKEN_TILE``, ``VOCAB_TILE``, the decode's
    ``DECODE_SPLIT``, the MLA decode's ``SPLIT``, ``TILE`` and ``PART``,
    the SSD scan's ``ROW_TILE``, the mLSTM scan's ``ROW_TILE`` and
    ``DV_SLICE``, the mLSTM backward's ``BWD_ROW_TILE`` and
    ``BWD_PASS``), and the instructions
    their PTX (``nvcc -ptx``) and, where the toolkit has cuobjdump, their
    SASS hold: every product kernel must issue ``wgmma.mma_async``
    (HGMMA) on operands that ``cp.async`` brought to shared memory."""
    import re
    import shutil
    rows = {}
    for name, body in _by_entry(build.ptxas_log(),
                                r"Compiling entry function '(\S+)'").items():
        regs = re.findall(r"Used (\d+) registers", body)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", body)
        rows[name] = {"registers": int(regs[0]),
                      "spill_bytes": sum(int(a) + int(b) for a, b in spills)}
    for d in (64, 80, 128, 192):
        rows[f"flash_fwd_sm90<D={d}>"]["dynamic_smem"] = \
            lib.flash_attention_fwd_sm90_smem(d)
        kv_tile = lib.flash_attention_fwd_sm90_kv_tile(d)
        check(kv_tile == fa.KV_TILES[d], f"D={d}: the kernel's kv tile is "
              f"{kv_tile}, KV_TILES says {fa.KV_TILES[d]}")
    for d in fa.BWD_HEAD_DIMS:
        tiles = tuple(lib.flash_attention_bwd_sm90_tile(d, a)
                      for a in range(4))
        check(tiles == fa.BWD_TILES[d], f"backward D={d}: the kernels' "
              f"tiles are {tiles}, BWD_TILES says {fa.BWD_TILES[d]}")
        for pass_, part in ((0, "dq"), (1, "dkv")):
            rows[f"flash_bwd_{part}_sm90<D={d}>"]["dynamic_smem"] = \
                lib.flash_attention_bwd_sm90_smem(d, pass_)
    split = lib.paged_decode_split_len()
    check(split == fa.DECODE_SPLIT, f"the decode kernel splits by {split} "
          f"positions, DECODE_SPLIT says {fa.DECODE_SPLIT}")
    ce_tiles = (lib.ce_fwd_sm90_tile(0), lib.ce_fwd_sm90_tile(1))
    check(ce_tiles == (ce.TOKEN_TILE, ce.VOCAB_TILE),
          f"ce_fwd's tiles are {ce_tiles}, the wrapper says "
          f"{(ce.TOKEN_TILE, ce.VOCAB_TILE)}")
    mla = (lib.mla_decode_paged_split_len(), lib.mla_decode_paged_tile(),
           lib.mla_decode_paged_part_len())
    check(mla == (md.SPLIT, md.TILE, md.PART), f"the MLA decode's split, "
          f"tile and partial are {mla}, the wrapper says "
          f"{(md.SPLIT, md.TILE, md.PART)}")
    ssd = lib.ssd_scan_sm90_tile()
    check(ssd == sk.ROW_TILE, f"the SSD scan's row tile is {ssd}, the "
          f"wrapper says {sk.ROW_TILE}")
    ssd_bwd = lib.ssd_scan_bwd_sm90_tile()
    check(ssd_bwd == sk.BWD_ROW_TILE, f"the SSD backward's row tile is "
          f"{ssd_bwd}, the wrapper says {sk.BWD_ROW_TILE}")
    mlstm = (lib.mlstm_scan_sm90_tile(0), lib.mlstm_scan_sm90_tile(1))
    check(mlstm == (mk.ROW_TILE, mk.DV_SLICE), f"the mLSTM scan's row tile "
          f"and dv slice are {mlstm}, the wrapper says "
          f"{(mk.ROW_TILE, mk.DV_SLICE)}")
    mlstm_bwd = (lib.mlstm_scan_bwd_sm90_tile(0),
                 lib.mlstm_scan_bwd_sm90_tile(1))
    check(mlstm_bwd == (mk.BWD_ROW_TILE, mk.BWD_PASS), f"the mLSTM "
          f"backward's pair tile and column pass are {mlstm_bwd}, the "
          f"wrapper says {(mk.BWD_ROW_TILE, mk.BWD_PASS)}")
    print(f"[sm90] tiles as the CPU models take them: kv {fa.KV_TILES}, "
          f"backward (dq rows, kv, dk/dv keys, q) {fa.BWD_TILES}, "
          f"CE {ce_tiles[0]} tokens x {ce_tiles[1]} vocab columns, "
          f"decode split {split} positions, MLA decode split {mla[0]} "
          f"positions in tiles of {mla[1]} (partials of {mla[2]} floats), "
          f"SSD chunk scan tiles of {ssd} rows, SSD backward pair tiles of "
          f"{ssd_bwd} rows, mLSTM chunk scan tiles of "
          f"{mlstm[0]} rows x {mlstm[1]} dv columns, mLSTM backward pair "
          f"tiles of {mlstm_bwd[0]} rows, accumulator passes of "
          f"{mlstm_bwd[1]} columns", flush=True)
    for name in rows:
        if name.startswith("ce_fwd_sm90"):
            rows[name]["dynamic_smem"] = lib.ce_fwd_sm90_smem()
    for cache in ("paged", "contiguous"):
        rows[f"mla_split_sm90<{cache}>"]["dynamic_smem"] = \
            lib.mla_decode_paged_sm90_smem()
    rows["ssd_chunk_state_sm90"]["dynamic_smem"] = lib.ssd_scan_sm90_smem(0)
    rows["ssd_chunk_scan_sm90"]["dynamic_smem"] = lib.ssd_scan_sm90_smem(1)
    rows["ssd_bwd_states_sm90"]["dynamic_smem"] = \
        lib.ssd_scan_bwd_sm90_smem(0, ZAMBA_P)
    for p in (32, 64, 96, 128):
        rows[f"ssd_bwd_pairs_sm90<P={p}>"]["dynamic_smem"] = \
            lib.ssd_scan_bwd_sm90_smem(1, p)
    for kernel, name in enumerate(("mlstm_chunk_state_sm90",
                                   "mlstm_chunk_scan_sm90")):
        rows[name]["dynamic_smem"] = lib.mlstm_scan_sm90_smem(
            kernel, MLSTM_CASES[0][3])
    for name, kernel in MLSTM_BWD_PRODUCTS.items():
        rows[name]["dynamic_smem"] = lib.mlstm_scan_bwd_sm90_smem(kernel)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    have_sass = Path(cuobjdump).exists()
    objs = {o.stem.rsplit("_", 1)[0]: o for o in build.objects()}
    # every source's PTX made at once (one nvcc a source, all started
    # together)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(SM90_SOURCES)) as pool:
        ptxs = dict(zip(SM90_SOURCES, pool.map(
            lambda src: build.ptx(build.CSRC / src), SM90_SOURCES)))
    for src in SM90_SOURCES:
        path = build.CSRC / src
        for name, body in _by_entry(ptxs[src],
                                    r"\.entry\s+(\w+)\(").items():
            rows[name]["ptx_wgmma"] = body.count("wgmma.mma_async")
            rows[name]["ptx_cp_async"] = body.count("cp.async.cg")
        if have_sass:
            sass = subprocess.run([cuobjdump, "-sass", str(
                objs[path.stem])], capture_output=True,
                text=True, check=True, timeout=300).stdout
            for name, body in _by_entry(sass, r"Function : (\S+)").items():
                rows[name]["sass_hgmma"] = body.count("HGMMA")
    for name, r in rows.items():
        print(f"[sm90] {name}: {r['registers']} registers, "
              f"{r['spill_bytes']} bytes spilled, "
              f"{r.get('dynamic_smem', 0)} B dynamic shared memory; PTX "
              f"{r.get('ptx_wgmma', 0)} wgmma.mma_async, "
              f"{r.get('ptx_cp_async', 0)} cp.async"
              + (f"; SASS {r.get('sass_hgmma', 0)} HGMMA" if have_sass
                 else "; no cuobjdump: SASS not read"), flush=True)
    products = [n for n in rows if n not in SM90_HELPERS]
    check(len(products) == 30, f"bf16 tensor-core kernels found: {products}")
    for n in products:
        r = rows[n]
        check(r["spill_bytes"] == 0, f"{n}: ptxas spilled")
        check(r.get("ptx_wgmma", 0) > 0 and r.get("ptx_cp_async", 0) > 0,
              f"{n}: no wgmma.mma_async or cp.async in its PTX")
        check(not have_sass or r.get("sass_hgmma", 0) > 0,
              f"{n}: no HGMMA in its SASS")
    return rows


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------

def _sdpa(q, k, v, causal, mask=None):
    """SDPA on (B, H, S, D) inputs with grouped kv heads. Where SDPA has
    no ``enable_gqa`` (torch < 2.5) the caller repeats the kv heads
    before timing."""
    import torch.nn.functional as F
    if q.shape[1] == k.shape[1]:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              is_causal=causal)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          is_causal=causal, enable_gqa=True)


def _sdpa_layout(q, k, v):
    """(B, S, H, D) -> SDPA's (B, H, S, D), made before timing."""
    import torch
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    if (major, minor) < (2, 5):
        g = qt.shape[1] // kt.shape[1]
        kt, vt = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
    return qt, kt, vt


def prefill_case(fa, b, s, dtype, gen, dev, heads=(32, 4, 64), timed=True):
    import torch
    h, hkv, d = heads
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(torch.equal(fa.flash_attention_cuda(q, k, v, causal=True), got),
          f"prefill {dtype} D={d} group {h // hkv} at S={s}: two runs "
          f"differ")
    rec = {"kernel": "flash_attention_cuda", "dtype": str(dtype),
           "B": b, "Sq": s, "Skv": s, "H": h, "Hkv": hkv, "D": d,
           "max_abs_err": err, "bitwise_repeat": True}
    if dtype == torch.bfloat16 and timed:
        qt, kt, vt = _sdpa_layout(q, k, v)
        rec["ms"] = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v))
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(q, k, v))
        rec["library_ms"] = cuda_ms(lambda: _sdpa(qt, kt, vt, True))
        flops = 2.0 * b * h * s * s * d        # causal: half of 4*B*H*S*S*D
        nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        rec["bound_ms"] = max(t_ops, t_bytes)
        rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return rec


# kv_lens of the serve shape (MB=32: up to 512, one exactly 512) and of
# the longer window (MB=128: up to 2048, one exactly 2048); slot 1 is
# inactive in both
SERVE_LENS = [512, 1, 37, 200, 16, 301, 455, 129]
LONG_LENS = [2048, 1, 150, 800, 64, 1203, 1820, 517]


def paged_tables(dev, b=8, bs=16, mb=32, lens=SERVE_LENS):
    """Block tables of B=8 sequences over a pool of B*MB blocks of 16
    tokens: ragged kv_lens up to MB*bs (one exactly MB*bs), NULL holes
    inside live windows and one all-NULL inactive slot with kv_len 1."""
    import torch
    n = b * mb
    tables = torch.full((b, mb), n, dtype=torch.int32)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    used = 0
    for i, ln in enumerate(lens):
        if i == 1:
            continue
        nb = -(-ln // bs)
        tables[i, :nb] = perm[used:used + nb].to(torch.int32)
        used += nb
        if nb > 2 and i % 2 == 0:
            tables[i, nb // 2] = n                # NULL hole
    kv_lens = torch.tensor(lens, dtype=torch.int32)
    return tables.to(dev), kv_lens.to(dev)


def paged_inputs(gen, dev, dtype, mb=32, lens=SERVE_LENS,
                 heads=(32, 4, 64)):
    """GQA decode inputs at tinyllama widths (``heads``: H, Hkv, D) over
    :func:`paged_tables`."""
    import torch
    (h, hkv, d), b, bs = heads, 8, 16
    n = b * mb
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n, bs, hkv, d), generator=gen, device=dev).to(dtype)
    vp = torch.randn((n, bs, hkv, d), generator=gen, device=dev).to(dtype)
    return (q, kp, vp) + paged_tables(dev, b, bs, mb, lens)


def decode_case(fa, gen, dev, dtype, mb=32, lens=SERVE_LENS,
                heads=(32, 4, 64)):
    import torch
    q, kp, vp, tables, kv_lens = paged_inputs(gen, dev, dtype, mb, lens,
                                              heads)
    got = fa.flash_decode_paged_cuda(q, kp, vp, tables, kv_lens)
    want = fa.flash_decode_paged_plain(q, kp, vp, tables, kv_lens)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(not got[1].any().item(), "decode: inactive slot output is not 0")
    check(torch.equal(fa.flash_decode_paged_cuda(q, kp, vp, tables,
                                                 kv_lens), got),
          f"decode {dtype} at MB={mb}: two runs differ")
    b, _, h, d = q.shape
    n, bs, hkv, _ = kp.shape
    rec = {"kernel": "flash_decode_paged_cuda", "dtype": str(dtype),
           "B": b, "H": h, "Hkv": hkv, "D": d, "bs": bs, "N": n,
           "MB": tables.shape[1], "kv_lens": kv_lens.tolist(),
           "max_abs_err": err, "bitwise_repeat": True,
           "window": "serve" if lens is SERVE_LENS else "long"}
    if dtype == torch.bfloat16:
        rec["ms"] = cuda_ms(lambda: fa.flash_decode_paged_cuda(
            q, kp, vp, tables, kv_lens))
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_decode_paged_plain(
            q, kp, vp, tables, kv_lens))
        # SDPA on the same window, gathered densely before timing
        idx = torch.where(tables < n, tables, 0).long()
        keep = (tables < n)[:, :, None, None, None]
        win_k = torch.where(keep, kp[idx], 0).reshape(b, -1, hkv, d)
        win_v = torch.where(keep, vp[idx], 0).reshape(b, -1, hkv, d)
        pos = torch.arange(win_k.shape[1], device=dev)
        mask = (pos[None, :] < kv_lens[:, None].long())[:, None, None, :]
        qt, kt, vt = _sdpa_layout(q, win_k, win_v)
        rec["library_ms"] = cuda_ms(lambda: _sdpa(qt, kt, vt, False, mask))
        rec["device_ms"] = device_ms(lambda: fa.flash_decode_paged_cuda(
            q, kp, vp, tables, kv_lens))
        rec["library_device_ms"] = device_ms(
            lambda: _sdpa(qt, kt, vt, False, mask))
        # bytes this data needs: the K/V rows below kv_len in mapped
        # blocks, each read once, plus q, tables, lens and the output
        pos_ok = (torch.arange(tables.shape[1] * bs, device=dev)[None, :]
                  < kv_lens[:, None].long())
        mapped = (tables < n).repeat_interleave(bs, dim=1)
        rows = int((pos_ok & mapped).sum().item())
        nbytes = (rows * hkv * d * 2 * 2 + 2 * q.numel() * 2
                  + tables.numel() * 4 + kv_lens.numel() * 4)
        flops = 4.0 * int(kv_lens.sum().item()) * h * d
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        rec["bound_ms"] = max(t_ops, t_bytes)
        rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return rec


def kernel_phase(fa, dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    recs = []
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for s in (16, 128, 200, 512):
            recs.append(prefill_case(fa, 2, s, dtype, gen, dev))
        recs.append(decode_case(fa, gen, dev, dtype, 128, LONG_LENS))
        recs.append(decode_case(fa, gen, dev, dtype))
        for r in recs[-6:]:
            shape = r.get("Sq", r.get("kv_lens"))
            print(f"[kernels] {r['kernel']} {r['dtype']} at {shape}: max "
                  f"abs err {r['max_abs_err']:.3e} (tol {tol:g})"
                  + (f", {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                     f"SDPA {r['library_ms']:.4f} ms, bound "
                     f"{r['bound_ms']:.6f} ms ({r['bound_by']})"
                     if "ms" in r else "")
                  + (f"; device time {_ms_or_not(r['device_ms'])}, SDPA's "
                     f"{_ms_or_not(r['library_device_ms'])}"
                     if "device_ms" in r else ""), flush=True)
            check(r["max_abs_err"] <= tol,
                  f"{r['kernel']} {r['dtype']} at {shape}: error "
                  f"{r['max_abs_err']} > {tol}")
    return recs


# --------------------------------------------------------------------------
# path phase
# --------------------------------------------------------------------------

def reference_checked_build(orig_build, compare, check_s, router_log=None,
                            all_finite=False):
    """A ``build_engine`` that, on the first prefill group and the first
    decode step, first runs the model's "reference" path on the same
    inputs and a copy of the cache, then the engine's own step, and hands
    both logits to ``compare(what, got, want)``; the reference's time
    goes to ``check_s[0]``. ``router_log["target"]`` names the path that
    is running (for a caller recording MoE routing); ``all_finite``
    checks the logits of every step."""
    import torch
    from repro_torch.models.model import build_model

    def build_checked(model, params, layout, *a, **k):
        eng = orig_build(model, params, layout, *a, **k)
        ref = build_model(dataclasses.replace(model.cfg,
                                              attention_impl="reference"),
                          model.device)
        first = {"prefill": True, "decode": True}
        labels = {"prefill": "first prefill group",
                  "decode": "first decode step"}

        def checked(kind, fn, ref_fn, cache_at):
            def run(*args):
                if not first[kind]:
                    got, cache = fn(*args)
                else:
                    first[kind] = False
                    t0 = time.monotonic()
                    ref_args = list(args)
                    ref_args[cache_at] = {n: c.clone() for n, c in
                                          args[cache_at].items()}
                    if router_log is not None:
                        router_log["target"] = "reference"
                    want, _ = ref_fn(params, *ref_args)
                    del ref_args
                    torch.cuda.synchronize()
                    check_s[0] += time.monotonic() - t0
                    if router_log is not None:
                        router_log["target"] = "kernel"
                    got, cache = fn(*args)
                    if router_log is not None:
                        router_log["target"] = None
                    compare(labels[kind], got, want)
                if all_finite:
                    check(bool(torch.isfinite(got).all()),
                          f"non-finite logits in a {kind} step")
                return got, cache
            return run

        eng.prefill_fns = {b: checked("prefill", f, ref.prefill_paged, 2)
                           for b, f in eng.prefill_fns.items()}
        eng.decode_fn = checked("decode", eng.decode_fn, ref.decode_paged,
                                1)
        return eng
    return build_checked


def path_phase(fa, md, dev):
    import torch
    from repro_torch.configs.base import resolve
    from repro_torch.launch import serve as tserve

    full = resolve("tinyllama-1.1b")

    checks = {}
    check_s = [0.0]
    orig_build = tserve.build_engine

    def compare(what, got, want):
        g, w = got.float(), want.float()
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite logits")
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        checks[what] = {"max_abs_err": err, "ref_max_abs": scale,
                        "tol": LOGIT_TOL * scale,
                        "argmax_agree": float(
                            (g.argmax(-1) == w.argmax(-1)).float().mean())}
        print(f"[path] {what}: kernel vs reference logits max abs err "
              f"{err:.4e} (tol {LOGIT_TOL * scale:.4e})", flush=True)
        check(err <= LOGIT_TOL * scale, f"{what}: logits differ by {err}")

    tserve.build_engine = reference_checked_build(orig_build, compare,
                                                  check_s)
    try:
        fa.flash_attention_cuda.launches = 0
        fa.flash_decode_paged_cuda.launches = 0
        md.mla_decode_paged_cuda.launches = 0
        result = tserve.main(SERVE_ARGV)
        launches = {"flash_attention_cuda": fa.flash_attention_cuda.launches,
                    "flash_decode_paged_cuda":
                        fa.flash_decode_paged_cuda.launches,
                    "mla_decode_paged_cuda":
                        md.mla_decode_paged_cuda.launches}
    finally:
        tserve.build_engine = orig_build

    st = result.stats
    args = tserve.parser().parse_args(SERVE_ARGV)
    reqs = tserve.synthetic_requests(
        args.requests, full.vocab_size, args.rate, (args.min_prompt, args.max_prompt),
        (args.min_gen, args.max_gen), args.seed)
    for r in reqs:
        toks = result.tokens[r.rid]
        check(len(toks) == r.max_new_tokens,
              f"request {r.rid}: {len(toks)} of {r.max_new_tokens} tokens")
        check(all(0 <= t < full.vocab_size for t in toks),
              f"request {r.rid}: token id out of vocab")
    check(len(checks) == 2, f"reference checks ran: {sorted(checks)}")
    layers = full.num_layers
    check(launches["flash_attention_cuda"] > 0
          and launches["flash_decode_paged_cuda"] > 0,
          f"a kernel of the path never launched: {launches}")
    check(launches["flash_attention_cuda"] == layers * st["prefill_groups"],
          f"prefill launches {launches} != {layers} x "
          f"{st['prefill_groups']} groups")
    check(launches["flash_decode_paged_cuda"] == layers * st["decode_steps"],
          f"decode launches {launches} != {layers} x "
          f"{st['decode_steps']} steps")
    check(launches["mla_decode_paged_cuda"] == 0,
          f"the MLA decode kernel launched on a GQA model: {launches}")
    check(st["kernel_launches"] == launches,
          f"engine stats {st['kernel_launches']} != counters {launches}")
    wall = st["wall_seconds"] - check_s[0]
    path = {"stats": st, "launches": launches, "logit_checks": checks,
            "check_seconds": check_s[0],
            "tokens_per_s_wall": st["total_tokens"] / wall,
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    print(f"[path] {st['total_tokens']} tokens in {wall:.3f} s of wall "
          f"(reference checks excluded): {path['tokens_per_s_wall']:.1f} "
          f"tok/s, peak memory {path['peak_memory_gib']:.3f} GiB, "
          f"launches {launches}", flush=True)
    return path


# --------------------------------------------------------------------------
# training kernel phase
# --------------------------------------------------------------------------

def _errs(got, want):
    """(max abs error, relative L2 error) of one output, or the largest
    of each over matching tuples of outputs."""
    import torch
    from repro_torch.kernels.parity import rel_l2
    if isinstance(got, (tuple, list)):
        pairs = [_errs(g, w) for g, w in zip(got, want)]
        return max(a for a, _ in pairs), max(r for _, r in pairs)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    return err, rel_l2(got, want)


def _attn_bound(b, s, h, hkv, d, factor, tensors_in, tensors_out):
    """Least time of causal attention work: ``factor`` x 2*B*H*S*S*D
    operations (the causal forward's), or the bytes of the inputs read
    once and the outputs written once."""
    flops = factor * 2.0 * b * h * s * s * d
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*tensors_in, *tensors_out))
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def attention_train_case(fa, b, s, h, hkv, d, dtype, gen, dev, timed):
    import torch
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    dout = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
    e_fwd, r_fwd = _errs((out, lse), fa.flash_attention_plain(
        q, k, v, return_lse=True))
    again = fa.flash_attention_cuda(q, k, v, return_lse=True)
    check(torch.equal(again[0], out) and torch.equal(again[1], lse),
          "attention forward differs between two runs")
    grads = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    e_bwd, r_bwd = _errs(grads, fa.flash_attention_bwd_plain(
        q, k, v, out, lse, dout))
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    check(all(torch.equal(a, g) for a, g in zip(again, grads)),
          "attention backward differs between two runs")
    shape = {"dtype": str(dtype), "B": b, "S": s, "H": h, "Hkv": hkv,
             "D": d}
    fwd = {"kernel": "flash_attention_cuda", **shape, "with_lse": True,
           "max_abs_err": e_fwd, "rel_l2": r_fwd, "bitwise_repeat": True}
    bwd = {"kernel": "flash_attention_bwd_cuda", **shape,
           "max_abs_err": e_bwd, "rel_l2": r_bwd, "bitwise_repeat": True}
    if timed:
        fwd["ms"] = cuda_ms(lambda: fa.flash_attention_cuda(
            q, k, v, return_lse=True))
        fwd["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, return_lse=True))
        qt, kt, vt = _sdpa_layout(q, k, v)
        fwd["library_ms"] = cuda_ms(lambda: _sdpa(qt, kt, vt, True))
        fwd["bound_ms"], fwd["bound_by"] = _attn_bound(
            b, s, h, hkv, d, 1.0, (q, k, v), (out, lse))
        bwd["ms"] = cuda_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, out, lse, dout))
        bwd["plain_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, lse, dout))
        qt, kt, vt = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        o_t = _sdpa(qt, kt, vt, True)
        do_t = dout.transpose(1, 2).contiguous()
        bwd["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            o_t, (qt, kt, vt), do_t, retain_graph=True))
        bwd["device_ms"] = device_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, out, lse, dout))
        bwd["library_device_ms"] = device_ms(lambda: torch.autograd.grad(
            o_t, (qt, kt, vt), do_t, retain_graph=True))
        # five products of the forward's size (2.5x its operations)
        bwd["bound_ms"], bwd["bound_by"] = _attn_bound(
            b, s, h, hkv, d, 2.5, (q, k, v, out, lse, dout), grads)
    return [fwd, bwd]


def ce_case(ce, ce_ref, t, d, v, eps, tied, dtype, gen, dev, timed):
    import torch
    import torch.nn.functional as F
    hid = torch.randn((t, d), generator=gen, device=dev).to(dtype)
    table = (torch.randn((v, d), generator=gen, device=dev)
             * d ** -0.5).to(dtype)
    head = table.t() if tied else table.t().contiguous()
    labels = torch.randint(0, v, (t,), generator=gen, device=dev)
    weights = (torch.rand((t,), generator=gen, device=dev) > 0.2).float()
    got = ce.cross_entropy_cuda(hid, head, labels, weights,
                                label_smoothing=eps, return_lse=True)
    want = ce.cross_entropy_plain(hid, head, labels, weights,
                                  label_smoothing=eps, return_lse=True)
    e, r = _errs(got, want)
    again = ce.cross_entropy_cuda(hid, head, labels, weights,
                                  label_smoothing=eps, return_lse=True)
    check(all(torch.equal(a, g) for a, g in zip(again, got)),
          "cross entropy forward differs between two runs")
    rec = {"kernel": "cross_entropy_cuda", "dtype": str(dtype), "T": t,
           "D": d, "V": v, "eps": eps, "tied_rows": tied,
           "zero_weights": int((weights == 0).sum().item()),
           "max_abs_err": e, "rel_l2": r, "bitwise_repeat": True}
    if timed:
        rec["ms"] = cuda_ms(lambda: ce.cross_entropy_cuda(
            hid, head, labels, weights, label_smoothing=eps), reps=5)
        rec["plain_ms"] = cuda_ms(lambda: ce.cross_entropy_plain(
            hid, head, labels, weights, label_smoothing=eps), reps=5)
        # two calls: no single PyTorch call fuses the head with the loss
        rec["library_ms"] = cuda_ms(lambda: F.cross_entropy(
            F.linear(hid, table).float(), labels, reduction="none",
            label_smoothing=eps), reps=5)
        flops = 2.0 * t * d * v
        nbytes = (hid.numel() + table.numel()) * hid.element_size() + \
            t * (8 + 4) + 2 * t * 4
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        rec["bound_ms"] = max(t_ops, t_bytes)
        rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return rec, (hid, head, labels, weights, want[2])


def dlogits_case(ce, ce_ref, inputs, eps, dtype, timed):
    import torch
    hid, head, labels, weights, lse = inputs
    logits = ce_ref.mm_f32(hid, head)
    dloss = torch.tensor(0.7, device=hid.device)
    got = ce.ce_dlogits_cuda(logits, lse, labels, weights, dloss,
                             label_smoothing=eps, dtype=dtype)
    want = ce_ref.ce_dlogits(logits, lse, labels, weights, dloss,
                             label_smoothing=eps, dtype=dtype)
    e, r = _errs(got, want)
    check(got.dtype == dtype and not got[weights == 0].any().item(),
          "dlogits: dummy rows are not exactly 0")
    rec = {"kernel": "ce_dlogits_cuda", "dtype": str(dtype),
           "R": logits.shape[0], "V": logits.shape[1], "eps": eps,
           "max_abs_err": e, "rel_l2": r, "library_ms": None}
    if timed:
        rec["ms"] = cuda_ms(lambda: ce.ce_dlogits_cuda(
            logits, lse, labels, weights, dloss, label_smoothing=eps,
            dtype=dtype))
        rec["plain_ms"] = cuda_ms(lambda: ce_ref.ce_dlogits(
            logits, lse, labels, weights, dloss, label_smoothing=eps,
            dtype=dtype))
        nbytes = logits.numel() * (4 + got.element_size()) + \
            logits.shape[0] * (4 + 8 + 4) + 4
        rec["bound_ms"] = nbytes / H100_BYTES_PER_S * 1e3
        rec["bound_by"] = "bytes"
    return rec


def train_kernel_phase(fa, ce, ce_ref, dev, main_rows, main_seq):
    import torch
    from repro_torch.kernels.parity import RTOL
    gen = torch.Generator(device=dev).manual_seed(1)
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        new = []
        for h, hkv, d in ((16, 16, 128), (32, 4, 64)):
            for s in (512, 1024, 200):
                new += attention_train_case(fa, 2, s, h, hkv, d, dtype, gen,
                                            dev, timed=False)
        # head dim 192 (MLA training): GQA on ragged tiles, then the
        # shape phase 18 gives it, timed in bf16
        new += attention_train_case(fa, 2, 200, 8, 2, MLA_DQK, dtype, gen,
                                    dev, timed=False)
        new += attention_train_case(fa, *DEEPSEEK_MICROBATCH, dtype, gen,
                                    dev, timed=dtype == torch.bfloat16)
        for eps, tied in ((0.0, False), (0.1, True)):
            rec, inputs = ce_case(ce, ce_ref, 4096, 2048, 50304, eps, tied,
                                  dtype, gen, dev, timed=False)
            new += [rec, dlogits_case(ce, ce_ref, inputs, eps, dtype,
                                      timed=False)]
            del inputs
        if dtype == torch.bfloat16:     # the train phase's shapes, timed
            new += attention_train_case(fa, main_rows, main_seq, 16, 16,
                                        128, dtype, gen, dev, timed=True)
            rec, inputs = ce_case(ce, ce_ref, main_rows * main_seq, 2048,
                                  50304, 0.0, True, dtype, gen, dev,
                                  timed=True)
            hid, head, lab, wts, lse = inputs     # one backward chunk
            chunk = (hid[:4096], head, lab[:4096], wts[:4096], lse[:4096])
            new += [rec, dlogits_case(ce, ce_ref, chunk, 0.0, dtype,
                                      timed=True)]
            del inputs, chunk, hid, head, lab, wts, lse
        bad = []
        for r in new:
            shape = {k: r[k] for k in ("B", "S", "H", "D", "T", "V", "eps",
                                       "R") if k in r}
            r["tol"] = RTOL[(r["kernel"], dtype)]
            print(f"[train-kernels] {r['kernel']} {r['dtype']} {shape}: "
                  f"relative L2 error {r['rel_l2']:.3e} (tol {r['tol']:g}),"
                  f" max abs err {r['max_abs_err']:.3e}"
                  + (f", {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                     f"library {r['library_ms']} ms, bound "
                     f"{r['bound_ms']:.6f} ms ({r['bound_by']})"
                     if "ms" in r else "")
                  + (f"; device time {_ms_or_not(r['device_ms'])}, the "
                     f"library's {_ms_or_not(r['library_device_ms'])}"
                     if "device_ms" in r else ""), flush=True)
            if not r["rel_l2"] <= r["tol"]:
                bad.append(f"{r['kernel']} {r['dtype']} {shape}: "
                           f"{r['rel_l2']} > {r['tol']}")
        check(not bad, "kernel vs plain: " + "; ".join(bad))
        recs += new
    return recs


# --------------------------------------------------------------------------
# train path phase
# --------------------------------------------------------------------------

TRAIN_ARGV = ["--arch", "olmo-1b", "--device", "cuda", "--seed", "0",
              "--steps", "6", "--global-batch", "8", "--seq-len", "1024",
              "--accum", "2", "--lr", "3e-4", "--warmup", "2",
              "--schedule", "constant", "--log-every", "1"]
# kernel path vs reference path on the first batch through 16 layers,
# in the run's bf16 and again in fp32 (TF32 off), where the two paths
# differ only in summation order: loss and grad norm relative to the
# reference value, and the relative L2 error of the worst gradient leaf.
# About 10x the readings on an H100 (bf16: 3.0e-5, 1.6e-4, 2.5e-2;
# fp32: 0, 0, 6.8e-6). The bf16 paths round at different points, so
# their worst leaf only catches gross faults; the fp32 one is tight.
TRAIN_RTOL = {"bfloat16": {"loss": 3e-4, "grad_norm": 2e-3, "leaf": 0.25},
              "float32": {"loss": 1e-6, "grad_norm": 1e-6, "leaf": 7e-5}}
# capacity-split vs single-batch gradient, fp32 (TF32 off): relative L2
# of the whole gradient; the two runs differ only in batch shapes, so
# in the order of a few sums (5.3e-6 on an H100)
INVARIANT_RTOL = 5e-5
INVARIANT_CAPS = (2.0, 1.0, 1.0, 0.0)


def _counters(fa, ce):
    fns = {"flash_attention_cuda": fa.flash_attention_cuda,
           "flash_attention_bwd_cuda": fa.flash_attention_bwd_cuda,
           "cross_entropy_cuda": ce.cross_entropy_cuda,
           "ce_dlogits_cuda": ce.ce_dlogits_cuda,
           "flash_decode_paged_cuda": fa.flash_decode_paged_cuda}
    return fns


def _tree_rel_l2(got, want):
    import torch
    from repro_torch.models.transformer import tree_leaves
    num = sum(torch.sum((a.float() - b.float()) ** 2)
              for a, b in zip(tree_leaves(got), tree_leaves(want)))
    den = sum(torch.sum(b.float() ** 2) for b in tree_leaves(want))
    return float(torch.sqrt(num / den))


def _leaf_names(tree, prefix=""):
    """Dotted names of a parameter tree's leaves, in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def train_phase(fa, ce, dev, argv=None):
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import capacity as cap
    from repro_torch.core import dummy, weighting
    from repro_torch.core.accumulate import value_and_grad
    from repro_torch.kernels.cross_entropy.cross_entropy import BWD_CHUNK
    from repro_torch.kernels.parity import rel_l2
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.optim import adam

    argv = list(argv or TRAIN_ARGV)
    fns = _counters(fa, ce)
    checks = {}
    check_s = [0.0]
    seen = {"first": None, "last": None}
    orig_build = tsteps.build_train_step

    def first_batch_checks(model, tcfg, state, batch):
        params = state.params
        # kernel vs reference path, same params and batch, leaf by leaf:
        # in the run's compute dtype and in fp32
        for dt in TRAIN_RTOL:
            cfg = dataclasses.replace(model.cfg, compute_dtype=dt)
            kern = build_model(cfg, model.device)
            ref = build_model(dataclasses.replace(
                cfg, attention_impl="reference"), model.device)
            k_loss, _, k_grads = tsteps.loss_and_grads(kern, tcfg, params,
                                                       batch)
            loss, w, grads = tsteps.loss_and_grads(ref, tcfg, params, batch,
                                                   ce_impl="reference")
            leaves = {n: rel_l2(a, b) for n, a, b in zip(
                _leaf_names(params), tree_leaves(k_grads),
                tree_leaves(grads))}
            attn = {n: e for n, e in leaves.items() if ".attn." in n}
            checks[f"reference_{dt}"] = {
                "loss": float(loss),
                "grad_norm": float(adam.global_norm(grads)),
                "weight": float(w), "kernel_loss": float(k_loss),
                "kernel_grad_norm": float(adam.global_norm(k_grads)),
                "leaf_rel_l2": leaves,
                "worst_leaf": max(leaves, key=leaves.get),
                "worst_attention_leaf": max(attn, key=attn.get)}
            del grads, k_grads
        # the HetSeq invariant, fp32: the batch's real rows as one batch
        # vs packed for capacities 2,1,1,0 (a dummy-only worker included)
        f32 = build_model(dataclasses.replace(
            model.cfg, compute_dtype="float32"), model.device)
        rows = batch["weights"].shape[0]
        real = batch["weights"].sum(dim=1) > 0
        samples = {k: batch[k][real].cpu().numpy()
                   for k in ("inputs", "labels")}
        tok_w = batch["weights"][real].cpu().numpy()
        (o, w1), g = value_and_grad(f32.loss_fn, params, {
            k: batch[k][real] for k in ("inputs", "labels", "weights")})
        want = weighting.scale_grads(g, w1)
        del g
        plan = cap.plan_capacities(int(real.sum()), INVARIANT_CAPS,
                                   headroom=1.25)
        packed = dummy.pack_global_batch(samples, plan, tok_w)
        b = plan.buffer_rows
        workers = [{k: torch.from_numpy(v[r * b:(r + 1) * b]).to(dev)
                    for k, v in packed.items()}
                   for r in range(plan.num_ranks)]
        loss_w, got = weighting.simulate_workers(f32.loss_fn, params,
                                                 workers)
        checks["invariant"] = {
            "capacities": list(INVARIANT_CAPS),
            "rows_per_rank": plan.rows_per_rank.tolist(),
            "buffer_rows": b, "batch_rows": rows,
            "loss_single": float(weighting.finalize(o, w1)),
            "loss_workers": float(loss_w),
            "grad_rel_l2": _tree_rel_l2(got, want), "tol": INVARIANT_RTOL}
        del got, want

    def build_checked(model, tcfg, mesh=None):
        step = orig_build(model, tcfg, mesh)

        def run(state, batch):
            if seen["first"] is None:
                t0 = time.monotonic()
                saved = {n: f.launches for n, f in fns.items()}
                first_batch_checks(model, tcfg, state, batch)
                for n, f in fns.items():         # checks do not count
                    f.launches = saved[n]
                torch.cuda.synchronize()
                check_s[0] += time.monotonic() - t0
                seen["first"] = True
            seen["last"] = (step, batch)
            return step(state, batch)
        return run

    tsteps.build_train_step = build_checked
    try:
        for f in fns.values():
            f.launches = 0
        result = ttrain.main(argv)
        launches = {n: f.launches for n, f in fns.items()}
    finally:
        tsteps.build_train_step = orig_build

    args = ttrain.parser().parse_args(argv)
    cfg = (cfgbase.smoke_config(args.arch) if args.smoke
           else cfgbase.resolve(args.arch))
    losses = result["losses"]
    n = result["steps"]
    check(n == args.steps and all(map(_finite, losses)),
          f"train: losses {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    plan = result["plan"]
    rows_mb = plan["buffer_rows"] // args.accum
    chunks = -(-rows_mb * args.seq_len // BWD_CHUNK)
    L = cfg.num_layers
    fwd_per_layer = 2 if cfg.remat == "full" else 1   # remat: once more
    expect = {"flash_attention_cuda": fwd_per_layer * L * args.accum * n,
              "flash_attention_bwd_cuda": L * args.accum * n,
              "cross_entropy_cuda": args.accum * n,
              "ce_dlogits_cuda": chunks * args.accum * n,
              "flash_decode_paged_cuda": 0}
    check(launches == expect, f"train launches {launches} != {expect}")

    first = result["metrics"][0]
    for dt, tol in TRAIN_RTOL.items():
        ref = checks[f"reference_{dt}"]
        ref["loss_rel"] = abs(ref["kernel_loss"] - ref["loss"]) / abs(
            ref["loss"])
        ref["grad_norm_rel"] = abs(ref["kernel_grad_norm"]
                                   - ref["grad_norm"]) / ref["grad_norm"]
        leaves = ref["leaf_rel_l2"]
        worst, worst_attn = ref["worst_leaf"], ref["worst_attention_leaf"]
        print(f"[train] first batch, kernel vs reference path, {dt}: loss "
              f"{ref['kernel_loss']:.6f} vs {ref['loss']:.6f} (rel "
              f"{ref['loss_rel']:.2e}, tol {tol['loss']:g}), grad norm "
              f"{ref['kernel_grad_norm']:.6f} vs {ref['grad_norm']:.6f} (rel "
              f"{ref['grad_norm_rel']:.2e}, tol {tol['grad_norm']:g}); "
              f"gradient leaves, relative L2: worst {worst} "
              f"{leaves[worst]:.3e}, worst attention {worst_attn} "
              f"{leaves[worst_attn]:.3e}, embed {leaves['embed']:.3e} (tol "
              f"{tol['leaf']:g})", flush=True)
        check(first["weight"] == ref["weight"], "train: weights differ")
        check(ref["loss_rel"] <= tol["loss"]
              and ref["grad_norm_rel"] <= tol["grad_norm"]
              and leaves[worst] <= tol["leaf"],
              f"train: kernel and reference paths disagree on the first "
              f"batch in {dt}")
    check(first["loss"] == checks["reference_bfloat16"]["kernel_loss"],
          "train: the step's first loss differs from the same batch's "
          "kernel-path loss in the check")
    inv = checks["invariant"]
    print(f"[train] HetSeq invariant (fp32), capacities "
          f"{inv['capacities']} -> rows {inv['rows_per_rank']} buffer "
          f"{inv['buffer_rows']}: loss {inv['loss_workers']:.6f} vs "
          f"{inv['loss_single']:.6f}, gradient relative L2 "
          f"{inv['grad_rel_l2']:.3e} (tol {INVARIANT_RTOL:g})", flush=True)
    check(inv["grad_rel_l2"] <= INVARIANT_RTOL,
          "train: capacity-split gradient differs from single-batch")

    # determinism: one more step from one state and one batch, twice
    t0 = time.monotonic()
    step, batch = seen["last"]
    state = result["state"]
    twin = tsteps.TrainState(
        params=tree_map(torch.clone, state.params),
        opt=adam.AdamState(step=state.opt.step.clone(),
                           m=tree_map(torch.clone, state.opt.m),
                           v=tree_map(torch.clone, state.opt.v)),
        err=state.err)
    a, _ = step(state, batch)
    b, _ = step(twin, batch)
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                 tree_leaves(b.params)))
    repeat_s = time.monotonic() - t0
    print(f"[train] repeated step bitwise identical: {same}", flush=True)
    check(same, "train: a repeated step gave different parameters")
    del b, twin, state, result["state"]

    # one more step under torch.profiler: device time by kernel
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        c, _ = step(a, batch)
        torch.cuda.synchronize()
    step_profile = _profile_rec(prof, (time.monotonic() - t0) * 1e6)
    del a, c, prof
    busy, win = step_profile["device_busy_us"], step_profile["window_us"]
    print(f"[train] torch.profiler over 1 step: kernels {busy / 1e3:.3f} ms "
          f"of device time in {win / 1e3:.3f} ms of wall; by kernel: "
          + "; ".join(f"{k['name'][:60]} x{k['count']} {k['us'] / 1e3:.3f} "
                      f"ms" for k in step_profile["kernels"][:12]),
          flush=True)

    step_s = result["step_s"][1:]
    ms = statistics.median(step_s) * 1e3
    tokens = args.global_batch * args.seq_len
    processed = plan["buffer_rows"] * args.seq_len
    n_params = cfg.param_count()
    attn = 3 * 2.0 * plan["buffer_rows"] * L * cfg.num_heads * \
        args.seq_len ** 2 * cfg.head_dim
    flops = 6.0 * n_params * processed + attn
    train = {
        "losses": losses, "metrics": result["metrics"], "plan": plan,
        "launches": launches, "expected_launches": expect,
        "checks": checks, "check_seconds": check_s[0],
        "repeat_step_seconds": repeat_s, "step_profile": step_profile,
        "ms_per_step_median_2_to_n": ms,
        "tokens_per_s": tokens / (ms / 1e3),
        "processed_tokens_per_s": processed / (ms / 1e3),
        "model_flops_per_step": flops,
        "mfu_vs_989_tflops": flops / (ms / 1e3) / H100_BF16_FLOPS,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "wall_s": result["wall_s"] - check_s[0]}
    print(f"[train] {cfg.name}: {ms:.1f} ms/step (median of steps 2..{n}),"
          f" {train['tokens_per_s']:.0f} real tokens/s "
          f"({processed} processed a step, {tokens} real), model FLOPs "
          f"{flops:.3e}/step = {100 * train['mfu_vs_989_tflops']:.2f}% of "
          f"989 TFLOP/s, peak memory {train['peak_memory_gib']:.2f} GiB, "
          f"launches {launches}", flush=True)
    return train


# --------------------------------------------------------------------------
# exchange kernel phase
# --------------------------------------------------------------------------

# the multi-rank phase's layout: olmo-1b's gradient stream in buckets of
# 25 MiB over 2 ranks (multiple of 2 x 256)
EXCHANGE_BUCKET_MB = 25.0
EXCHANGE_RANKS = 2


def exchange_layout(cfg):
    """The bucket grid of ``cfg``'s gradient stream at the multi-rank
    phase's settings (it depends only on the element count)."""
    import torch
    from repro_torch.core import buckets as bkt
    return bkt.build_layout(
        {"stream": torch.empty(cfg.param_count(), device="meta")},
        bucket_mb=EXCHANGE_BUCKET_MB, multiple_of=EXCHANGE_RANKS * 256)


def exchange_shapes(cfg):
    """The multi-rank path's exchange shapes: rows (blocks of 256) of
    kernels 4 and 5 as the first chunk's send side, receive side and
    re-quantize would give them (the chunk's rows, one shard's) and the
    same of one bucket (the overlap pipelines' launches) and of the whole
    stack; the legs' chunk (``chunk_buckets`` buckets) and the stack's
    buckets and data rows."""
    from repro_torch.core import buckets as bkt
    lo = exchange_layout(cfg)
    rows = bkt.chunk_buckets(lo) * lo.bucket_elems // 256
    total_rows = -(-lo.total // 256)
    return {"chunk_send": rows, "chunk_shard": rows // EXCHANGE_RANKS,
            "bucket_send": lo.bucket_elems // 256,
            "bucket_shard": lo.bucket_elems // 256 // EXCHANGE_RANKS,
            "stack_send": total_rows,
            "stack_shard": lo.num_buckets * lo.bucket_elems // 256
            // EXCHANGE_RANKS,
            "chunk_buckets": bkt.chunk_buckets(lo),
            "num_buckets": lo.num_buckets,
            "ns": lo.bucket_elems // EXCHANGE_RANKS // 256,
            "stack_data_rows": total_rows}


def _bits_equal(a, b) -> bool:
    """Bit for bit (``torch.equal`` on floats takes -0.0 for 0.0)."""
    import torch
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.int8), b.view(torch.int8)))


def _timed_exchange(rec, fn, plain, nbytes, plain_reps=REPS):
    """A kernel's times: CUDA events around a call (``ms``), its device
    time under torch.profiler (``device_ms``: the call is host-bound at
    one bucket), the plain version's events; the bound by bytes."""
    rec.update(ms=cuda_ms(fn), device_ms=device_ms(fn),
               plain_ms=cuda_ms(plain, reps=plain_reps), library_ms=None,
               bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes")
    return rec


def quantize_case(qz, q_ref, rows, gen, dev, *, noise, timed):
    import torch
    x = torch.randn((rows, 256), generator=gen, device=dev)
    x *= torch.rand((rows, 1), generator=gen, device=dev) * 10
    x[:2] = 0.0                                  # all-zero blocks
    nz = (torch.rand((rows, 256), generator=gen, device=dev)
          if noise else None)
    q, s = qz.quantize_int8_cuda(x, nz)
    qr, sr = q_ref.quantize_blocks(x, nz)
    torch.cuda.synchronize()
    same = _bits_equal(q, qr) and _bits_equal(s, sr)
    err = max((q.int() - qr.int()).abs().max().item(),
              (s - sr).abs().max().item())
    rec = {"kernel": "quantize_int8_cuda", "dtype": "float32", "rows": rows,
           "noise": noise, "bitwise_equal": same, "max_abs_err": err,
           "rel_l2": 0.0 if same else float("inf")}
    if timed:
        _timed_exchange(rec, lambda: qz.quantize_int8_cuda(x, nz),
                        lambda: q_ref.quantize_blocks(x, nz),
                        rows * 256 * (4 + 1 + (4 if noise else 0))
                        + rows * 4)
    del x, nz, q, s, qr, sr
    return rec


def dequant_case(qz, q_ref, ranks, rows, gen, dev, *, timed):
    import torch
    q = torch.randint(-127, 128, (ranks, rows, 256), generator=gen,
                      device=dev, dtype=torch.int8)
    s = torch.rand((ranks, rows), generator=gen, device=dev) * 0.1
    got = qz.dequant_accum_cuda(q, s)
    want = q_ref.dequant_accum(q, s)
    torch.cuda.synchronize()
    same = _bits_equal(got, want)
    rec = {"kernel": "dequant_accum_cuda", "dtype": "float32", "R": ranks,
           "rows": rows, "bitwise_equal": same,
           "max_abs_err": (got - want).abs().max().item(),
           "rel_l2": 0.0 if same else float("inf")}
    if timed:
        _timed_exchange(rec, lambda: qz.dequant_accum_cuda(q, s),
                        lambda: q_ref.dequant_accum(q, s),
                        ranks * rows * (256 + 4) + rows * 256 * 4)
        rec["two_call_ms"] = cuda_ms(lambda: torch.einsum(
            "rbk,rb->bk", q.float(), s))
    del q, s, got, want
    return rec


LEG_NAMES = ("exchange_send_cuda", "exchange_receive_cuda",
             "exchange_decode_cuda")


def legs_case(qz, q_ref, nbc, p, ns, d_rows, gen, dev, *, noise=False,
              timed=False):
    """The exchange's three fused legs against their plain legs, bit for
    bit, on every rank of one chunk of ``nbc`` buckets over ``p`` ranks
    (``ns`` blocks a shard, the first ``d_rows`` rows data), the
    collectives done by hand: each rank's wire, its error state after
    each stage, the gather leg's payloads and the decoded chunk. Leg by
    leg, each rank's kernel and plain outputs compared and the plain
    ones freed (the whole olmo-1b stack holds 4.7 GB a rank and tensor).
    ``timed``: each leg's times on rank 0's inputs. One record a leg."""
    import torch
    shape = (nbc, p, ns * 256)
    xs, es, noises = [], [], []
    for r in range(p):
        x = torch.randn((nbc, p, ns, 256), generator=gen, device=dev)
        x *= torch.rand((nbc, p, ns, 1), generator=gen, device=dev) * 10
        if r == 0:
            x.view(-1, 256)[:2] = 0.0            # all-zero blocks
        xs.append(x.view(shape))
        es.append(torch.randn(shape, generator=gen, device=dev) * 0.01)
        noises.append(torch.rand(shape, generator=gen, device=dev)
                      if noise else None)
    at = {"R": p, "nbc": nbc, "ns": ns, "rows": nbc * p * ns,
          "d_rows": d_rows, "noise": noise}
    recs = {n: {"kernel": n, "dtype": "float32", **at, "bitwise_equal": True,
                "max_abs_err": 0.0} for n in LEG_NAMES}

    def agree(name, pairs):
        for a, b in pairs:
            if not _bits_equal(a, b):
                recs[name]["bitwise_equal"] = False
                recs[name]["max_abs_err"] = max(
                    recs[name]["max_abs_err"],
                    (a.float() - b.float()).abs().max().item())

    wires = []
    for r in range(p):
        ek, ep = es[r].clone(), es[r].clone()
        wk, lens = qz.exchange_send_cuda(xs[r], ek, d_rows, noises[r])
        wp, lens_p = q_ref.exchange_send(xs[r], ep, d_rows, noises[r])
        recs[LEG_NAMES[0]]["bitwise_equal"] &= lens == lens_p
        agree(LEG_NAMES[0], [(wk, wp), (ek, ep)])
        del wp, ep
        wires.append(wk)
        es[r] = ek
    pre = [sum(lens[:j]) for j in range(p + 1)]
    rxs = [torch.stack([w[pre[me]:pre[me + 1]] for w in wires])
           for me in range(p)]
    del wires
    outs = []
    for me in range(p):
        ek, ep = es[me].clone(), es[me].clone()
        ok = qz.exchange_receive_cuda(rxs[me], ek, me)
        agree(LEG_NAMES[1], [(ok, q_ref.exchange_receive(rxs[me], ep, me)),
                             (ek, ep)])
        del ep
        es[me] = ek
        outs.append(ok)
    gs = [torch.cat([out[me * lens[j]:(me + 1) * lens[j]]
                     for j, out in enumerate(outs)]) for me in range(p)]
    del outs
    for me in range(p):
        xk, xp = torch.empty_like(xs[me]), torch.empty_like(xs[me])
        qz.exchange_decode_cuda(gs[me], lens, xk)
        q_ref.exchange_decode(gs[me], lens, xp)
        agree(LEG_NAMES[2], [(xk, xp)])
        recs[LEG_NAMES[2]]["bitwise_equal"] &= bool(xk.abs().max() > 0)
        del xk, xp
    torch.cuda.synchronize()
    if timed:
        x, e, rx, g = xs[0], es[0], rxs[0], gs[0]
        n_rows, mine = nbc * p * ns, lens[0]
        plain_reps = 5 if n_rows > 100_000 else REPS
        _timed_exchange(
            recs[LEG_NAMES[0]],
            lambda: qz.exchange_send_cuda(x, e, d_rows, noises[0]),
            lambda: q_ref.exchange_send(x, e, d_rows, noises[0]),
            n_rows * 256 * (12 + (4 if noise else 0)) + d_rows * 260,
            plain_reps)
        _timed_exchange(
            recs[LEG_NAMES[1]], lambda: qz.exchange_receive_cuda(rx, e, 0),
            lambda: q_ref.exchange_receive(rx, e, 0),
            2 * p * mine * 260 + mine * 256 * 8, plain_reps)
        _timed_exchange(
            recs[LEG_NAMES[2]],
            lambda: qz.exchange_decode_cuda(g, lens, x),
            lambda: q_ref.exchange_decode(g, lens, x),
            g.shape[0] * 260 + n_rows * 256 * 4, plain_reps)
    del xs, es, noises, rxs, gs
    return list(recs.values())


class LocalComm:
    """A stand-in for rank ``index`` of a ``Comm`` of ``p`` ranks that
    moves nothing: each ``all_to_all`` returns a buffer of the rows the
    call receives, made once from the rows it sends (real payload rows,
    repeated) and reused, so that an exchange's legs run alone on the
    card."""

    def __init__(self, p, index=0):
        self.size, self.index, self._bufs = p, index, {}

    def all_to_all(self, x, send_rows, recv_rows, async_op=False):
        import torch
        key = (tuple(recv_rows), tuple(x.shape[1:]))
        if key not in self._bufs:
            idx = torch.arange(sum(recv_rows), device=x.device) % max(
                1, x.shape[0])
            self._bufs[key] = x[idx] if x.shape[0] else x.new_zeros(
                (sum(recv_rows), *x.shape[1:]))
        return self._bufs[key]


def exchange_chunk_case(nbc, gen, dev, reps=REPS):
    """Rank 0's int8 legs of one exchange chunk of ``nbc`` of the
    multi-rank path's buckets (``core/buckets.py``'s ``_send_int8`` and
    ``_finish_int8``, the collectives replaced by :class:`LocalComm`):
    the device time and the launches (kernels, copies and fills) of one
    chunk under torch.profiler, by kernel. Runs on any checkout of the
    port, so it times a parent's legs too."""
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import buckets as bkt
    lo = exchange_layout(cfgbase.resolve("olmo-1b"))
    p, shard = EXCHANGE_RANKS, lo.bucket_elems // EXCHANGE_RANKS
    x = torch.randn((nbc, p, shard), generator=gen, device=dev)
    e = torch.randn((nbc, p, shard), generator=gen, device=dev) * 0.01
    comm = LocalComm(p)
    d_rows = nbc * lo.bucket_elems // 256

    def run():
        sent = bkt._send_int8(x, e, comm, d_rows, 256, "kernel", False)
        bkt._finish_int8(x, e, comm, sent, 256, "kernel")
    prof = device_profile(run, reps)
    rec = {"case": "exchange_chunk", "nbc": nbc, "R": p, "shard": shard,
           "elements": nbc * lo.bucket_elems,
           "device_ms": prof and sum(ms for _, ms in prof.values()),
           "launches": prof and sum(n for n, _ in prof.values()),
           "by_kernel": prof and {k[:80]: {"launches": n, "ms": ms}
                                  for k, (n, ms) in prof.items()},
           "ms": cuda_ms(run, reps=5)}
    del x, e, comm
    torch.cuda.empty_cache()
    return rec


def exchange_kernel_phase(dev):
    """Phase 6: kernels 4 and 5 and the exchange's three fused legs
    bitwise against their plain versions (odd row counts, all-zero
    blocks, stochastic rounding, ragged messages, the path's shapes, the
    whole olmo-1b stack), timed at the path's shapes (one chunk, one
    bucket), and rank 0's legs of one chunk and of one bucket as
    ``core/buckets.py`` runs them, by device time and launches."""
    import gc
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.kernels.quantize import quantize as qz
    from repro_torch.kernels.quantize import ref as q_ref
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(6)
    shapes = exchange_shapes(cfgbase.resolve("olmo-1b"))
    recs = []
    for rows, noise in ((1, False), (7, False), (1001, False),
                        (4099, True), (shapes["stack_send"], False)):
        recs.append(quantize_case(qz, q_ref, rows, gen, dev, noise=noise,
                                  timed=False))
    for ranks, rows in ((1, 9), (3, 1001), (8, 4099),
                        (EXCHANGE_RANKS, shapes["stack_shard"])):
        recs.append(dequant_case(qz, q_ref, ranks, rows, gen, dev,
                                 timed=False))
    # the legs: ragged messages (a d_rows inside the last bucket, an
    # empty message, more ranks than the receive kernel stages at once),
    # 4099 data rows with noise, the whole stack (its last bucket's tail
    # is padding)
    p, ns = EXCHANGE_RANKS, shapes["ns"]
    for nbc, pc, nsc, cut, noise in ((1, 1, 3, 1, False),
                                     (3, 3, 3, 5, False),
                                     (2, 9, 3, 10, True),
                                     (1, 2, 2050, 1, True)):
        recs += legs_case(qz, q_ref, nbc, pc, nsc, nbc * pc * nsc - cut,
                          gen, dev, noise=noise)
    recs += legs_case(qz, q_ref, shapes["num_buckets"], p, ns,
                      shapes["stack_data_rows"], gen, dev)
    # timed at the path's shapes: one chunk (phase 7), one bucket (the
    # overlap pipelines, phase 15); kernels 4 and 5 as the parent's path
    # launched them
    recs.append(quantize_case(qz, q_ref, shapes["chunk_shard"], gen, dev,
                              noise=False, timed=True))
    recs.append(quantize_case(qz, q_ref, shapes["chunk_send"], gen, dev,
                              noise=False, timed=True))
    recs.append(dequant_case(qz, q_ref, p, shapes["chunk_shard"], gen, dev,
                             timed=True))
    cb = shapes["chunk_buckets"]
    recs += legs_case(qz, q_ref, cb, p, ns, cb * p * ns, gen, dev,
                      timed=True)
    for rec in (quantize_case(qz, q_ref, shapes["bucket_shard"], gen, dev,
                              noise=False, timed=True),
                quantize_case(qz, q_ref, shapes["bucket_send"], gen, dev,
                              noise=False, timed=True),
                dequant_case(qz, q_ref, p, shapes["bucket_shard"], gen, dev,
                             timed=True),
                *legs_case(qz, q_ref, 1, p, ns, p * ns, gen, dev,
                           timed=True)):
        recs.append({**rec, "bucket": True})
    for r in recs:
        shape = {k: r[k] for k in ("R", "nbc", "ns", "rows", "d_rows",
                                   "noise") if k in r}
        print(f"[exchange-kernels] {r['kernel']} {shape}"
              + (" (one bucket)" if r.get("bucket") else "")
              + f": bitwise equal "
              f"{r['bitwise_equal']}, max abs err {r['max_abs_err']:.3e}"
              + (f", {r['ms']:.4f} ms, device {_ms_or_not(r['device_ms'])}"
                 f", plain {r['plain_ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.6f} ms ({r['bound_by']})"
                 + (f", q.float() + einsum {r['two_call_ms']:.4f} ms"
                    if "two_call_ms" in r else "")
                 if "ms" in r else ""), flush=True)
    bad = [f"{r['kernel']} {r.get('R')} ranks, rows {r['rows']}"
           for r in recs if not r["bitwise_equal"]]
    check(not bad, "exchange kernels differ from their plain versions: "
          + "; ".join(bad))
    chunks = {"chunk": exchange_chunk_case(cb, gen, dev),
              "bucket": exchange_chunk_case(1, gen, dev)}
    for k, c in chunks.items():
        print(f"[exchange-kernels] rank 0's int8 legs of one {k} ({c['nbc']}"
              f" buckets, {c['elements']} elements, 2 ranks, collectives "
              f"left out): device {_ms_or_not(c['device_ms'])} in "
              f"{c['launches']} launches, {c['ms']:.4f} ms by events",
              flush=True)
    return recs, chunks


# --------------------------------------------------------------------------
# multi-rank train path phase
# --------------------------------------------------------------------------

MULTI_ARGV = ["--arch", "olmo-1b", "--device", "cuda", "--seed", "0",
              "--devices", "2,1,1", "--grad-reduction", "hierarchical",
              "--compression", "int8", "--bucket-mb", "25",
              "--capacities", "2,1", "--global-batch", "8", "--seq-len",
              "1024", "--accum", "2", "--steps", "3", "--lr", "3e-4",
              "--warmup", "2", "--schedule", "constant", "--log-every", "1"]
# the HetSeq invariant across two ranks at full width, depth cut to 2
# layers, fp32 (TF32 off): the reduced gradient against one process on
# the union of the real rows, by relative L2 of the whole gradient. fp32
# exchange: the limit of the single-process invariant (4.9e-6 on an
# H100). int8: each element off by up to half a quantization step of its
# block, twice (9.7e-3 on an H100); the limit is about 10x that reading.
MULTI_INVARIANT_RTOL = {"none": 5e-5, "int8": 0.1}
MULTI_INVARIANT_LAYERS = 2


def probe_rank(rank, world, init_method, seq_len):
    """One rank of the multi-rank probe. (1) The invariant: the reduced
    gradient of a 2-layer full-width olmo-1b at fp32 over ``world`` ranks
    of capacities 2,1, with the fp32 and with the int8 exchange; rank 0
    also computes one process's gradient over the union of the real
    rows and returns both relative L2 errors. (2) The exchange alone: a
    random stack of full olmo-1b size exchanged three times each way
    (int8, fp32), host clock around a synchronized call; rank 0 returns
    the medians."""
    import numpy as np
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import capacity as cap
    from repro_torch.core import dummy
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_mod.init((world, 1, 1), ("pod", "data", "model"), rank,
                         init_method, "cuda")
    try:
        cfg = dataclasses.replace(
            cfgbase.resolve("olmo-1b"), num_layers=MULTI_INVARIANT_LAYERS,
            compute_dtype="float32", attention_impl="kernel")
        model = build_model(cfg, mesh.device)
        plan = cap.plan_capacities(8, (2.0, 1.0), headroom=1.25)
        rng = np.random.default_rng(3)
        samples = {k: rng.integers(0, cfg.vocab_size, (8, seq_len)).astype(
            np.int32) for k in ("inputs", "labels")}
        packed = dummy.pack_global_batch(samples, plan)
        b = plan.buffer_rows
        mine = {k: torch.from_numpy(v[rank * b:(rank + 1) * b]).to(
            mesh.device) for k, v in packed.items()}
        out = {}
        for comp in ("none", "int8"):
            tcfg = cfgbase.TrainConfig(
                model=cfg, het=cfgbase.HetConfig(
                    grad_reduction="hierarchical", compression=comp,
                    bucket_mb=EXCHANGE_BUCKET_MB, quantize_impl="pallas"))
            state = tsteps.init_train_state(model, tcfg, mesh=mesh)
            layout = tsteps.bucket_layout(tcfg, mesh, state.params)
            loss_r, w, g, _ = tsteps.reduce_grads(model, tcfg, mesh,
                                                  layout, state, mine)
            if rank == 0:
                real = packed["weights"].sum(axis=1) > 0
                union = {k: torch.from_numpy(v[real]).to(mesh.device)
                         for k, v in packed.items()}
                loss, w1, want = tsteps.loss_and_grads(
                    model, tcfg, state.params, union)
                out[comp] = {"grad_rel_l2": _tree_rel_l2(g, want),
                             "loss": float(loss_r), "loss_single":
                             float(loss), "weight": float(w),
                             "weight_single": float(w1)}
                del want
            del g, state
        del model
        from repro_torch.core import buckets as bkt
        lo = exchange_layout(cfgbase.resolve("olmo-1b"))
        gen = torch.Generator(device=mesh.device).manual_seed(rank)
        stack = torch.randn((lo.num_buckets, lo.bucket_elems),
                            generator=gen, device=mesh.device)
        err = torch.zeros_like(stack)
        # one exchange each (the median of 3 before phase 20 was added:
        # the fp32 one takes ~10 s over gloo), after the probe's own
        out["exchange_ms"] = {}
        for comp in ("int8", "none"):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            bkt.exchange_buckets(stack, err, comm=mesh.pod,
                                 compress=comp == "int8",
                                 total=lo.total, impl="kernel")
            torch.cuda.synchronize()
            out["exchange_ms"][comp] = (time.monotonic() - t0) * 1e3
    finally:
        mesh_mod.destroy(mesh)
    return out


def shard_buckets(lo, p, index, block_size=256):
    """Buckets of layout ``lo`` whose shard ``index`` of ``p`` holds data
    rows in the int8 per-bucket exchange: the stream's data blocks fill
    the buckets in order (``core/buckets.py::bucket_legs``), each
    bucket's blocks split into ``p`` shards of ``ns``."""
    rpb = lo.bucket_elems // block_size
    ns = rpb // p
    data = max(1, min(lo.num_buckets * rpb, -(-lo.total // block_size)))
    return sum(1 for k in range(lo.num_buckets)
               if min(rpb, max(0, data - k * rpb)) > index * ns)


def multi_rank_train(dev, argv, smi, per_bucket=False, tag="multi"):
    """The driver's multi-rank run with its checks: finite losses, equal
    parameters on every rank, each rank's launches and wire bytes (of
    the monolithic exchange's chunks, or with ``per_bucket`` of the
    overlap pipelines' buckets: the send leg and the decode once a
    bucket, the receive leg once a bucket whose shard holds data,
    ``modeled_bucket_link_bytes`` summed)."""
    import gc
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import buckets as bkt
    from repro_torch.launch import train as ttrain
    gc.collect()
    torch.cuda.empty_cache()
    args = ttrain.parser().parse_args(argv)
    cfg = cfgbase.resolve(args.arch)
    print(f"[{tag}] parent holds "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB on the card "
          f"before the ranks start", flush=True)
    result = ttrain.main(argv)
    ranks = result["ranks"]
    n = result["steps"]
    losses = result["losses"]
    check(n == args.steps and all(map(_finite, losses)),
          f"{tag}: losses {losses}")
    sums = result["end_checksums"]
    check(len(sums) == len(ranks) > 1 and len(set(sums)) == 1,
          f"{tag}: parameters differ across ranks: {sums}")
    lo = exchange_layout(cfg)
    chunks = bkt.exchange_chunks(lo)
    units = lo.num_buckets if per_bucket else chunks
    plan = result["plan"]
    expect = train_launches(cfg, plan["buffer_rows"], args.accum,
                            args.seq_len, n, units)
    modeled = (sum(bkt.modeled_bucket_link_bytes(lo, 2, k, compress=True)
                   for k in range(lo.num_buckets)) if per_bucket
               else bkt.modeled_link_bytes(lo, 2, compress=True))
    pods, data = (list(map(int, args.devices.split(","))) + [1])[:2]
    for r in ranks:
        want = dict(expect)
        if per_bucket and data == 1:
            # the cross-pod exchange's rank r is pod r: it re-quantizes
            # and accumulates its shard of a bucket only where the shard
            # holds data rows (the last bucket's shards past the stream's
            # data are empty at some depths)
            want["exchange_receive_cuda"] = shard_buckets(
                lo, pods, r["rank"]) * n
        check(r["launches"] == want,
              f"{tag}: rank {r['rank']} launches {r['launches']} != "
              f"{want}")
        check(r["link_bytes"] == [modeled] * n,
              f"{tag}: rank {r['rank']} wire bytes {r['link_bytes']} "
              f"!= modeled {modeled} a step")
    ms = statistics.median(result["step_s"][1:]) * 1e3
    tokens = args.global_batch * args.seq_len
    peaks = [r["peak_memory_bytes"] / 2**30 for r in ranks]
    trust = [m["trust_ratio"] for m in result["metrics"]
             if "trust_ratio" in m]
    print(f"[{tag}] {cfg.name}, {len(ranks)} ranks (--devices "
          f"{args.devices}, capacities {args.capacities}, overlap "
          f"{args.overlap}, optimizer {args.optimizer}) on "
          f"{torch.cuda.device_count()} card(s), backend "
          f"{result['backend']}, transport {result['transport']}: "
          f"{ms:.1f} ms/step (median of steps 2..{n}), "
          f"{tokens / (ms / 1e3):.0f} real tokens/s, peak memory per rank "
          f"{', '.join(f'{p:.2f}' for p in peaks)} GiB, "
          + (f"{lo.num_buckets} buckets" if per_bucket
             else f"{chunks} exchange chunks")
          + f", {modeled} wire bytes a step per rank (modeled {modeled}), "
          f"launches per rank {ranks[0]['launches']}"
          + (f", trust ratio {trust}" if trust else "") + f" [{smi}]",
          flush=True)
    return {"devices": args.devices, "overlap": args.overlap,
            "optimizer": args.optimizer, "losses": losses,
            "metrics": result["metrics"], "plan": plan,
            "launches": ranks[0]["launches"], "expected_launches": expect,
            "launches_by_rank": [r["launches"] for r in ranks],
            "exchange_chunks": chunks, "buckets": lo.num_buckets,
            "link_bytes_per_step": modeled,
            "ms_per_step_median_2_to_n": ms,
            "step_s": result["step_s"],
            "tokens_per_s": tokens / (ms / 1e3),
            "peak_memory_gib_by_rank": peaks,
            "backend": result["backend"], "transport": result["transport"],
            "end_checksums": sums, "wall_s": result["wall_s"]}


def multi_rank_probe(seq_len, smi):
    """:func:`probe_rank` on two ranks, with its checks."""
    from repro_torch.core import buckets as bkt
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import mesh as mesh_mod
    chunks = bkt.exchange_chunks(exchange_layout(cfgbase.resolve("olmo-1b")))
    t0 = time.monotonic()
    inv = mesh_mod.spawn(probe_rank, 2, (seq_len,), timeout_s=600)[0]
    inv_s = time.monotonic() - t0
    exchange_ms = inv.pop("exchange_ms")
    print(f"[multi] one exchange of the full olmo-1b stack between the 2 "
          f"ranks ({chunks} chunks): int8 {exchange_ms['int8']:.1f} ms, "
          f"fp32 {exchange_ms['none']:.1f} ms (one each) [{smi}]",
          flush=True)
    for comp, rec in inv.items():
        rec["tol"] = MULTI_INVARIANT_RTOL[comp]
        print(f"[multi] HetSeq invariant across 2 ranks ({comp} exchange, "
              f"{MULTI_INVARIANT_LAYERS} layers, fp32): loss "
              f"{rec['loss']:.6f} vs {rec['loss_single']:.6f}, gradient "
              f"relative L2 {rec['grad_rel_l2']:.3e} (tol {rec['tol']:g})",
              flush=True)
        check(rec["weight"] == rec["weight_single"],
              f"multi-rank invariant ({comp}): weights differ")
        check(rec["grad_rel_l2"] <= rec["tol"],
              f"multi-rank invariant ({comp}): reduced gradient differs "
              f"from the single process's")
    return {"invariant": inv, "exchange_ms": exchange_ms,
            "seconds": inv_s}


def multi_rank_phase(dev, smi):
    train = multi_rank_train(dev, MULTI_ARGV, smi)
    return {**train, "probe": multi_rank_probe(1024, smi)}


# the multi-card run (``--cards 4``): the same path with one card per
# rank (NCCL), on two ranks and on four with a dead rank
CARDS_DEVICES = (("2,1,1", "2,1"), ("2,2,1", "2,1,1,0"))
CARDS_OVERLAP = "2,2,1"


def cards_main(dev, smi, cards):
    import torch
    from repro_torch.kernels import _build
    check(torch.cuda.device_count() >= cards,
          f"--cards {cards}: {torch.cuda.device_count()} card(s) here")
    t0 = time.monotonic()
    _build.build()
    phases = {"build": time.monotonic() - t0}
    runs = {}
    for devices, caps in CARDS_DEVICES:
        argv = [a for a in MULTI_ARGV]
        argv[argv.index("--devices") + 1] = devices
        argv[argv.index("--capacities") + 1] = caps
        # the overlap pipelines over NCCL (async collectives, and in
        # "backward" collectives issued from autograd's hooks) on the
        # mesh with an in-pod leg
        overlaps = [(None, [])] + (list(OVERLAP_RUNS[:2])
                                   if devices == CARDS_OVERLAP else [])
        for name, flags in overlaps:
            key = devices if name is None else f"{devices}/{name}"
            t0 = time.monotonic()
            runs[key] = multi_rank_train(
                dev, argv + flags, smi, per_bucket=name is not None,
                tag="cards" if name is None else f"cards-{name}")
            check(runs[key]["backend"] == "nccl",
                  f"{key}: backend {runs[key]['backend']}, not nccl")
            phases[key] = time.monotonic() - t0
    t0 = time.monotonic()
    probe = multi_rank_probe(1024, smi)
    phases["probe"] = time.monotonic() - t0
    t0 = time.monotonic()
    pipeline = pipeline_cards(smi)
    phases["pipeline"] = time.monotonic() - t0
    print("[phases] seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.items()), flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_cards.json").write_text(json.dumps(
        {"nvidia_smi": smi, "phase_seconds": phases, "runs": runs,
         "probe": probe, "pipeline": pipeline}, indent=1, default=str))



# --------------------------------------------------------------------------
# MLA serving: kernel phase and path phase (deepseek-v2)
# --------------------------------------------------------------------------

MLA_H, MLA_R, MLA_DR, MLA_DQK = 128, 512, 64, 192
MLA_SCALE = MLA_DQK ** -0.5
MLA_LAYERS = 8            # depth cut: 8 of 60 layers fit one 80 GB card
MLA_GATE_LAYERS = 2       # the fp32 kernel-vs-reference gate's depth
# kernel path vs reference path logits of the fp32 gate (TF32 off):
# the two differ in attention's summation order only. Relative to the
# largest reference logit (at least 1).
MLA_GATE_TOL = 1e-3
MLA_SERVE_ARGV = [a if a != "tinyllama-1.1b" else "deepseek-v2-236b"
                  for a in SERVE_ARGV]


def _bound(nbytes, flops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _mla_sdpa(qa, qr, ckv_win, kr_win, lens):
    """The yardstick: SDPA as MQA over the dense window, q = [q_abs |
    q_r] (B, H, 1, 576), k = [ckv | kr] (B, 1, S, 576), v = ckv (B, 1, S,
    512), a boolean length mask (made before timing)."""
    import torch
    import torch.nn.functional as F
    q = torch.cat([qa, qr], dim=-1)[:, :, None, :].contiguous()
    k = torch.cat([ckv_win, kr_win], dim=-1)[:, None].contiguous()
    v = ckv_win[:, None].contiguous()
    pos = torch.arange(k.shape[2], device=k.device)
    mask = (pos[None, :] < lens[:, None].long())[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=MLA_SCALE, enable_gqa=True)


def mla_paged_case(md, mla_ref, gen, dev, dtype, timed, mb=32,
                   lens=SERVE_LENS):
    """The serve phase's decode shape: B=8 slots, bs=16, MB=32, ragged
    lengths (one at MB*bs, an inactive all-NULL slot), NULL holes; or
    the longer window (MB=128, lengths up to 2048). Two runs must give
    equal bits; timed, it also reads the device time of a call and of
    the yardstick's (the call is host-bound)."""
    import torch
    tables, kv_lens = paged_tables(dev, mb=mb, lens=lens)
    b, mb = tables.shape
    n, bs = b * mb, 16
    qa = torch.randn((b, MLA_H, MLA_R), generator=gen, device=dev).to(dtype)
    qr = torch.randn((b, MLA_H, MLA_DR), generator=gen, device=dev).to(dtype)
    cp = torch.randn((n, bs, MLA_R), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n, bs, MLA_DR), generator=gen, device=dev).to(dtype)
    args = (qa, qr, cp, kp, tables, kv_lens, MLA_SCALE)
    got = md.mla_decode_paged_cuda(*args)
    want = mla_ref.mla_decode_paged_online_plain(*args)
    torch.cuda.synchronize()
    check(not got[1].any().item(), "MLA decode: inactive slot is not 0")
    check(torch.equal(md.mla_decode_paged_cuda(*args), got),
          f"MLA decode {dtype} at MB={mb}: two runs differ")
    rec = {"kernel": "mla_decode_paged_cuda", "dtype": str(dtype), "B": b,
           "H": MLA_H, "r": MLA_R, "Dr": MLA_DR, "bs": bs, "N": n, "MB": mb,
           "kv_lens": kv_lens.tolist(),
           "max_abs_err": (got - want).abs().max().item(),
           "bitwise_repeat": True,
           "window": "serve" if lens is SERVE_LENS else "long"}
    if timed:
        rec["ms"] = cuda_ms(lambda: md.mla_decode_paged_cuda(*args))
        rec["plain_ms"] = cuda_ms(
            lambda: mla_ref.mla_decode_paged_online_plain(*args))
        win = (mla_ref.gather_blocks(cp, tables),
               mla_ref.gather_blocks(kp, tables))
        sdpa = _mla_sdpa(qa, qr, *win, kv_lens)
        rec["library_ms"] = cuda_ms(sdpa)
        rec["device_ms"] = device_ms(lambda: md.mla_decode_paged_cuda(*args))
        rec["library_device_ms"] = device_ms(sdpa)
        # the latent rows below kv_len in mapped blocks, read once; q, the
        # tables and lengths; the fp32 output
        pos_ok = (torch.arange(mb * bs, device=dev)[None, :]
                  < kv_lens[:, None].long())
        mapped = ((tables >= 0) & (tables < n)).repeat_interleave(bs, dim=1)
        rows = int((pos_ok & mapped).sum().item())
        el = qa.element_size()
        nbytes = (rows * (MLA_R + MLA_DR) * el + b * MLA_H * (MLA_R + MLA_DR)
                  * el + tables.numel() * 4 + b * 4 + got.numel() * 4)
        flops = (2.0 * (MLA_R + MLA_DR) + 2.0 * MLA_R) * MLA_H * int(
            kv_lens.sum().item())
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops)
    return rec


# the MLA generate phase's decode shape: B=4 sequences over a contiguous
# cache of S = 1024 + 64 positions; the last step's lengths (all at S)
# and a ragged set
MLA_GEN_B, MLA_GEN_S = 4, 1088
MLA_GEN_LENS = {"full": [MLA_GEN_S] * 4, "ragged": [MLA_GEN_S, 1, 513, 700]}
# the contiguous kernel's continuity row (PERF.md's B=8, S=512)
MLA_CONT_AT = (8, 512)


def _mla_contiguous_inputs(gen, dev, dtype, b, s, lens):
    """(q_abs, q_r, ckv, kr, kv_len, scale) of B sequences at S
    positions, lengths ``lens`` or drawn in [1, S] with one at S."""
    import torch
    qa = torch.randn((b, MLA_H, MLA_R), generator=gen, device=dev).to(dtype)
    qr = torch.randn((b, MLA_H, MLA_DR), generator=gen, device=dev).to(dtype)
    ckv = torch.randn((b, s, MLA_R), generator=gen, device=dev).to(dtype)
    kr = torch.randn((b, s, MLA_DR), generator=gen, device=dev).to(dtype)
    if lens is None:
        kv = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                           dtype=torch.int32)
        kv[0] = s
    else:
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
    return qa, qr, ckv, kr, kv, MLA_SCALE


def mla_contiguous_case(md, mla_ref, s, gen, dev, dtype, timed, b=8,
                        lens=None):
    """:func:`_mla_contiguous_inputs`' case. Two runs must give equal
    bits, and the last sequence alone (over its own rows: fewer splits)
    the bits it gets inside a batch of 8; bf16 is also held to the split
    model. Timed, it also reads the device time of a call by launch
    (bf16: split and merge) and of the yardstick's (the call is
    host-bound)."""
    import torch
    args = _mla_contiguous_inputs(gen, dev, dtype, b, s, lens)
    qa, qr, ckv, kr, kv, _ = args
    got = md.mla_decode_cuda(*args)
    want = mla_ref.mla_decode_online_plain(*args)
    torch.cuda.synchronize()
    what = f"MLA contiguous decode {dtype} at B={b}, S={s}"
    check(torch.equal(md.mla_decode_cuda(*args), got),
          f"{what}: two runs differ")
    wide = [t.repeat((8 // b,) + (1,) * (t.ndim - 1)) for t in args[:5]]
    batched = md.mla_decode_cuda(*wide, MLA_SCALE)
    seq, n = b - 1, int(kv[b - 1].item())
    alone = md.mla_decode_cuda(
        qa[seq:seq + 1].contiguous(), qr[seq:seq + 1].contiguous(),
        ckv[seq:seq + 1, :n].contiguous(), kr[seq:seq + 1, :n].contiguous(),
        kv[seq:seq + 1].contiguous(), MLA_SCALE)
    check(torch.equal(batched[:b], got) and torch.equal(alone[0], got[seq]),
          f"{what}: a sequence's bits depend on the batch")
    rec = {"kernel": "mla_decode_cuda", "dtype": str(dtype), "B": b,
           "H": MLA_H, "r": MLA_R, "Dr": MLA_DR, "S": s,
           "kv_lens": kv.tolist(),
           "max_abs_err": (got - want).abs().max().item(),
           "bitwise_repeat": True, "batch_invariant": True}
    if dtype == torch.bfloat16:
        rec["max_abs_err_split_model"] = (
            got - md.mla_decode_split_plain(*args)).abs().max().item()
    if (b, s) == MLA_CONT_AT:
        rec["continuity"] = "at_b8_s512"
    if timed:
        run = lambda: md.mla_decode_cuda(*args)
        rec["ms"] = cuda_ms(run)
        rec["plain_ms"] = cuda_ms(lambda: mla_ref.mla_decode_online_plain(
            *args))
        sdpa = _mla_sdpa(qa, qr, ckv, kr, kv)
        rec["library_ms"] = cuda_ms(sdpa)
        by_kernel = device_ms_by_kernel(run)
        rec["device_ms_by_launch"] = by_kernel and {
            next((k for k in ("mla_split_sm90", "mla_merge",
                              "mla_decode_kernel") if k in n), n[:60]): ms
            for n, ms in by_kernel.items()}
        rec["device_ms"] = by_kernel and sum(by_kernel.values())
        rec["library_device_ms"] = device_ms(sdpa)
        el = qa.element_size()
        live = int(kv.sum().item())
        nbytes = (live * (MLA_R + MLA_DR) * el + b * MLA_H * (MLA_R + MLA_DR)
                  * el + b * 4 + got.numel() * 4)
        flops = (2.0 * (MLA_R + MLA_DR) + 2.0 * MLA_R) * MLA_H * live
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops)
    return rec


def prefill192_case(fa, b, s, dtype, gen, dev, timed):
    """The MLA prefill's attention: H = Hkv = 128, head dim 192 (v
    zero-padded from 128 as the model pads it)."""
    import torch
    shape = (b, s, MLA_H, MLA_DQK)
    q = torch.randn(shape, generator=gen, device=dev).to(dtype)
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v[..., 128:] = 0
    run = lambda: fa.flash_attention_cuda(q, k, v, causal=True,
                                          softmax_scale=MLA_SCALE)
    got = run()
    want = fa.flash_attention_plain(q, k, v, causal=True,
                                    softmax_scale=MLA_SCALE)
    torch.cuda.synchronize()
    check(torch.equal(run(), got), f"D=192 prefill {dtype} at S={s}: two "
          f"runs differ")
    rec = {"kernel": "flash_attention_cuda", "dtype": str(dtype), "B": b,
           "S": s, "H": MLA_H, "Hkv": MLA_H, "D": MLA_DQK,
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "bitwise_repeat": True}
    if timed:
        rec["ms"] = cuda_ms(run)
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=True, softmax_scale=MLA_SCALE))
        qt, kt, vt = _sdpa_layout(q, k, v)
        rec["library_ms"] = cuda_ms(lambda: _sdpa(qt, kt, vt, True))
        rec["bound_ms"], rec["bound_by"] = _attn_bound(
            b, s, MLA_H, MLA_H, MLA_DQK, 1.0, (q, k, v), (got,))
    return rec


def mla_kernel_phase(fa, md, mla_ref, dev):
    """Both MLA decode kernels and the D=192 prefill against their plain
    versions at deepseek-v2 widths, fp32 (TF32 off) and bf16; timed in
    bf16 at the serve phase's shapes (decode: B=8 over the paged pool;
    prefill: B=2 at the 512 bucket) and the contiguous kernel at the
    generate phase's (B=4, S=1088, every length at S) and at B=8,
    S=512."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(8)
    recs = []
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        bf16 = dtype == torch.bfloat16
        new = [mla_paged_case(md, mla_ref, gen, dev, dtype, timed=bf16),
               mla_paged_case(md, mla_ref, gen, dev, dtype, timed=bf16,
                              mb=128, lens=LONG_LENS)]
        new += [mla_contiguous_case(md, mla_ref, s, gen, dev, dtype,
                                    timed=bf16 and s == 512)
                for s in (200, 512, 2048)]
        new += [mla_contiguous_case(md, mla_ref, MLA_GEN_S, gen, dev, dtype,
                                    timed=bf16 and kind == "full",
                                    b=MLA_GEN_B, lens=lens)
                for kind, lens in MLA_GEN_LENS.items()]
        new += [prefill192_case(fa, 2, s, dtype, gen, dev,
                                timed=bf16 and s == 512)
                for s in (16, 512, 200)]
        for r in new:
            shape = {k: r[k] for k in ("B", "S", "H", "D", "MB") if k in r}
            print(f"[mla-kernels] {r['kernel']} {r['dtype']} {shape}: max "
                  f"abs err {r['max_abs_err']:.3e} (tol {tol:g})"
                  + (f", {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                     f"SDPA {r['library_ms']:.4f} ms, bound "
                     f"{r['bound_ms']:.6f} ms ({r['bound_by']})"
                     if "ms" in r else "")
                  + (f"; device time {_ms_or_not(r['device_ms'])}, SDPA's "
                     f"{_ms_or_not(r['library_device_ms'])}"
                     if "device_ms" in r else "")
                  + (f" (by launch {r['device_ms_by_launch']})"
                     if r.get("device_ms_by_launch") else "")
                  + (f"; split model {r['max_abs_err_split_model']:.3e} "
                     f"(tol {SPLIT_MODEL_TOL:g})"
                     if "max_abs_err_split_model" in r else ""), flush=True)
            r["tol"] = tol
            if "max_abs_err_split_model" in r:
                r["tol_split_model"] = SPLIT_MODEL_TOL
        bad = [f"{r['kernel']} {r['dtype']}: {r['max_abs_err']}"
               for r in new if not r["max_abs_err"] <= tol]
        bad += [f"{r['kernel']} {r['dtype']} vs the split model: "
                f"{r['max_abs_err_split_model']}" for r in new
                if not r.get("max_abs_err_split_model", 0.0)
                <= SPLIT_MODEL_TOL]
        check(not bad, "MLA kernels vs plain: " + "; ".join(bad))
        recs += new
    return recs


# steps of the 8-layer run traced with torch.profiler, [first, last):
# decode steps 10..12 and prefill group 2 (step and group 0 hold the
# reference check and the first allocations)
MLA_PROFILE = {"decode": (10, 13), "prefill": (2, 3)}


def _kernel_times(prof):
    """Device time of each kernel a profiler saw, summed by name."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return by_name


def _profile_rec(prof, wall_us, steps=1):
    """A profiler window's record: its wall time, the device time of its
    kernels and the top 20 kernels by device time."""
    by_name = _kernel_times(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"steps": steps, "window_us": wall_us,
            "device_busy_us": sum(us for _, us in by_name.values()),
            "kernels": [{"name": n[:160], "count": c, "us": us}
                        for n, (c, us) in top[:20]]}


def step_timed_build(build, times, profiles):
    """Wrap ``build``'s prefill and decode steps: host clock between two
    device synchronisations into ``times[kind]`` (and each prefill
    group's bucket into ``times["prefill_bucket"]``); the steps in
    ``MLA_PROFILE`` run under torch.profiler, and ``profiles[kind]`` gets
    the window's wall time, the device time of its kernels and the top
    kernels by device time. Starting and reading the profiler costs host
    seconds outside the steps; they go to ``times["profiler_s"]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    def timed(kind, fns):
        lo, hi = MLA_PROFILE[kind]
        prof = {}

        def wrap(fn):
            def run(*args):
                step = len(times[kind])
                if step == lo:
                    t0 = time.monotonic()
                    prof["p"] = tprofile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA])
                    prof["p"].__enter__()
                    prof["t0"] = time.monotonic()
                    times["profiler_s"] += prof["t0"] - t0
                torch.cuda.synchronize()
                t0 = time.monotonic()
                out = fn(*args)
                torch.cuda.synchronize()
                times[kind].append(time.monotonic() - t0)
                if kind == "prefill":
                    times["prefill_bucket"].append(int(args[0].shape[1]))
                if step == hi - 1:
                    t0 = time.monotonic()
                    wall_us = (t0 - prof["t0"]) * 1e6
                    prof["p"].__exit__(None, None, None)
                    profiles[kind] = _profile_rec(prof["p"], wall_us,
                                                  hi - lo)
                    times["profiler_s"] += time.monotonic() - t0
                return out
            return run
        return {key: wrap(fn) for key, fn in fns.items()}

    def build_timed(model, params, layout, *a, **k):
        eng = build(model, params, layout, *a, **k)
        eng.prefill_fns = timed("prefill", eng.prefill_fns)
        eng.decode_fn = timed("decode", {0: eng.decode_fn})[0]
        return eng
    return build_timed


def _serve_mla(cfg, args, build, counters):
    """``serve_config`` on ``cfg``, its engine made by ``build``,
    with every kernel counter zeroed just before and read just after;
    frees the model when done."""
    import gc
    import torch
    from repro_torch.launch import serve as tserve
    orig = tserve.build_engine
    tserve.build_engine = build
    try:
        for f in counters.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats(torch.device("cuda", 0))
        t0 = time.monotonic()
        result = tserve.serve_config(cfg, args)
        seconds = time.monotonic() - t0
        launches = {n: f.launches for n, f in counters.items()}
    finally:
        tserve.build_engine = orig
    peak = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    return result, launches, peak, seconds


def mla_path_phase(fa, md, dev, smi, every):
    """deepseek-v2-236b served through ``serve_config`` at full width, 8
    layers, bf16, attention_impl="kernel" (phase 4's settings): every
    request finishes, launch counts, finite logits; the bf16 kernel vs
    reference difference and the routing choices that differ on the
    first prefill group and first decode step, for the record. The same
    weights then generate through the static path (:func:`mla_generate`,
    with every counter in ``every``). Then the gate: the same serve at
    fp32 (TF32 off) on 2 layers, where the kernel and reference paths
    must agree, and on its weights the static path's gate
    (:func:`mla_generate_gate`)."""
    import gc
    import torch
    from repro_torch.configs.base import resolve
    from repro_torch.launch import serve as tserve
    from repro_torch.models import blocks as tblocks

    full = resolve("deepseek-v2-236b")
    args = tserve.parser().parse_args(MLA_SERVE_ARGV)
    counters = _serve_counters(fa, md)
    log = {"target": None, "reference": [], "kernel": []}
    orig_router = tblocks._router

    def router(params, x2d, cfg):
        out = orig_router(params, x2d, cfg)
        if log["target"] is not None:
            log[log["target"]].append(out[1].sort(dim=-1).values)
        return out

    def run(cfg, gate, then):
        """The serve, then ``then(model, params)`` on its weights."""
        checks, check_s = {}, [0.0]
        log.update(reference=[], kernel=[])

        def compare(what, got, want):
            g, w = got.float(), want.float()
            err = (g - w).abs().max().item()
            scale = max(1.0, w.abs().max().item())
            ks, rs = log["kernel"], log["reference"]
            differ = sum(int((k != r).any(dim=-1).sum())
                         for k, r in zip(ks, rs))
            checks[what] = {"max_abs_err": err, "ref_max_abs": scale,
                            "argmax_agree": float(
                                (g.argmax(-1) == w.argmax(-1)).float()
                                .mean()),
                            "routed_tokens": sum(len(r) for r in rs),
                            "routing_differs": differ}
            log.update(reference=[], kernel=[])
            tol = f" (tol {MLA_GATE_TOL * scale:.4e})" if gate else ""
            print(f"[mla-path] {cfg.num_layers} layers {cfg.compute_dtype} "
                  f"{what}: kernel vs reference logits max abs err "
                  f"{err:.4e}{tol}, argmax agree "
                  f"{checks[what]['argmax_agree']:.3f}, tokens routed "
                  f"differently {differ} of "
                  f"{checks[what]['routed_tokens']} (over the layers)",
                  flush=True)
            if gate:
                checks[what]["tol"] = MLA_GATE_TOL * scale
                check(err <= MLA_GATE_TOL * scale,
                      f"MLA gate {what}: logits differ by {err}")

        build = reference_checked_build(tserve.build_engine, compare,
                                        check_s, router_log=log,
                                        all_finite=True)
        if not gate:
            build = step_timed_build(build, step_s, profiles)
        held = {}

        def capture(model, params, *a, **k):
            held.update(model=model, params=params)
            return build(model, params, *a, **k)
        result, launches, peak, secs = _serve_mla(cfg, args, capture,
                                                  counters)
        check(len(checks) == 2, f"reference checks ran: {sorted(checks)}")
        t0 = time.monotonic()
        then_out = then(held.pop("model"), held.pop("params"))
        gc.collect()
        torch.cuda.empty_cache()
        then_out["seconds"] = time.monotonic() - t0
        return result, launches, peak, secs, checks, check_s[0], then_out

    step_s = {"prefill": [], "decode": [], "prefill_bucket": [],
              "profiler_s": 0.0}
    profiles = {}

    tblocks._router = router
    try:
        held = torch.cuda.memory_allocated(dev) / 2**30
        print(f"[mla-path] before: {held:.2f} GiB allocated on the card",
              flush=True)
        cfg = dataclasses.replace(full, num_layers=MLA_LAYERS,
                                  attention_impl="kernel")
        result, launches, peak, secs, checks, check_s, generate = run(
            cfg, False, lambda m, p: mla_generate(m, p, every, smi))
        gate_cfg = dataclasses.replace(
            full, num_layers=MLA_GATE_LAYERS, compute_dtype="float32",
            attention_impl="kernel")
        _, gate_launches, gate_peak, gate_secs, gate_checks, _, gen_gate = \
            run(gate_cfg, True, lambda m, p: mla_generate_gate(m, p, every))
    finally:
        tblocks._router = orig_router

    st = result.stats
    reqs = tserve.synthetic_requests(
        args.requests, full.vocab_size, args.rate,
        (args.min_prompt, args.max_prompt), (args.min_gen, args.max_gen),
        args.seed)
    for r in reqs:
        toks = result.tokens[r.rid]
        check(len(toks) == r.max_new_tokens,
              f"MLA request {r.rid}: {len(toks)} of {r.max_new_tokens}")
        check(all(0 <= t < full.vocab_size for t in toks),
              f"MLA request {r.rid}: token id out of vocab")
    expect = {"flash_attention_cuda": MLA_LAYERS * st["prefill_groups"],
              "flash_decode_paged_cuda": 0,
              "mla_decode_paged_cuda": MLA_LAYERS * st["decode_steps"]}
    check(launches == expect, f"MLA launches {launches} != {expect}")
    check(st["kernel_launches"] == launches,
          f"engine stats {st['kernel_launches']} != counters {launches}")
    gate_st = gate_launches["mla_decode_paged_cuda"]
    check(gate_st > 0 and gate_launches["flash_attention_cuda"] > 0,
          f"the fp32 gate did not run the kernels: {gate_launches}")
    wall = st["wall_seconds"] - check_s - step_s["profiler_s"]
    out = {"layers": MLA_LAYERS, "stats": st, "launches": launches,
           "expected_launches": expect, "bf16_checks": checks,
           "check_seconds": check_s, "seconds": secs,
           "profiler_seconds": step_s["profiler_s"],
           "tokens_per_s_wall": st["total_tokens"] / wall,
           "ms_per_decode_step_median": statistics.median(
               step_s["decode"][1:]) * 1e3,
           "prefill_group_ms": [(bkt, t * 1e3) for bkt, t in zip(
               step_s["prefill_bucket"], step_s["prefill"])],
           "profiles": profiles,
           "peak_memory_gib": peak, "weights_gib": tserve.weight_bytes(
               cfg) / 2**30,
           "gate": {"layers": MLA_GATE_LAYERS, "checks": gate_checks,
                    "launches": gate_launches, "peak_memory_gib": gate_peak,
                    "seconds": gate_secs},
           "generate": {**generate, "gate": gen_gate}}
    print(f"[mla-path] deepseek-v2-236b, {MLA_LAYERS} of 60 layers at full "
          f"width, bf16: {st['requests']} requests, {st['total_tokens']} "
          f"tokens in {wall:.3f} s of wall (reference checks and the "
          f"profiler's start and stop excluded): "
          f"{out['tokens_per_s_wall']:.1f} tok/s, {st['decode_steps']} decode "
          f"steps (median {out['ms_per_decode_step_median']:.2f} ms, "
          f"reference check excluded), {st['prefill_groups']} prefill "
          f"groups, peak memory "
          f"{peak:.2f} GiB (weights {out['weights_gib']:.2f} GiB), launches "
          f"{launches}; fp32 gate on {MLA_GATE_LAYERS} layers: peak "
          f"{gate_peak:.2f} GiB [{smi}]", flush=True)
    print("[mla-path] prefill groups (bucket, ms; group 0 holds the "
          "reference check): " + ", ".join(
              f"({bkt}, {ms:.1f})" for bkt, ms in out["prefill_group_ms"]),
          flush=True)
    for kind, prof in profiles.items():
        busy, win = prof["device_busy_us"], prof["window_us"]
        print(f"[mla-path] torch.profiler over {prof['steps']} {kind} "
              f"step(s): kernels {busy / 1e3:.3f} ms of device time in "
              f"{win / 1e3:.3f} ms of wall; by kernel: " + "; ".join(
                  f"{k['name'][:48]} x{k['count']} {k['us'] / 1e3:.3f} ms"
                  for k in prof["kernels"][:10]), flush=True)
    return out


# the MLA generate phase on phase 9's weights: batch, prompt, generated
# tokens (8 layers, bf16); its profiled decode steps [first, last); the
# fp32 gate's prompt and tokens (phase 9's 2-layer gate weights)
MLA_GEN_RUN = (MLA_GEN_B, 1024, MLA_GEN_S - 1024)
MLA_GEN_PROFILE = (10, 13)
MLA_GEN_GATE = (300, 8)


def mla_generate(model, params, counters, smi):
    """deepseek-v2's 8-layer cut at full width on phase 9's bf16 weights
    (attention_impl="kernel") generates 64 tokens after a 1024-token
    prompt for 4 sequences through ``launch.serve.static_generate``: the
    contiguous MLA decode launches once a layer a decode step, the D=192
    prefill once a layer, every other kernel never; finite logits;
    timings; a profile of three decode steps and of a second prefill."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    cfg = model.cfg
    batch, plen, ngen = MLA_GEN_RUN
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, plen)).astype(np.int32)
    profiler = lambda: tprofile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
    record = {"prefill": [], "decode": [], "finite": True, "profiles": {},
              "profiler_s": 0.0, "profiler": profiler,
              "profile": {"lo": MLA_GEN_PROFILE[0],
                          "hi": MLA_GEN_PROFILE[1]}}
    toks, launches, secs, peak = _counted_generate(model, params, prompts,
                                                 ngen, counters, record)
    expect = {n: 0 for n in counters}
    expect.update(mla_decode_cuda=cfg.num_layers * (ngen - 1),
                  flash_attention_cuda=cfg.num_layers)
    check(launches == expect, f"MLA generate launches {launches} != "
          f"{expect}")
    check(toks.shape == (batch, ngen), f"MLA generate tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "MLA generate: token id out of vocab")
    check(record["finite"], "MLA generate: non-finite logits")
    check(len(record["prefill"]) == 1 and len(record["decode"]) == ngen - 1,
          f"MLA generate steps {len(record['prefill'])} prefill, "
          f"{len(record['decode'])} decode")
    lo, hi = MLA_GEN_PROFILE
    decode_s = record["decode"][:lo] + record["decode"][hi:]
    wall = secs - record["profiler_s"]
    with profiler() as prof:              # the prefill once more, traced
        t0 = time.monotonic()
        model.prefill(params, torch.as_tensor(prompts, device=model.device),
                      max_len=plen + ngen)
        torch.cuda.synchronize()
        pre_wall = (time.monotonic() - t0) * 1e6
    record["profiles"]["prefill"] = _profile_rec(prof, pre_wall)
    out = {"layers": cfg.num_layers, "batch": batch, "prompt": plen,
           "generated": ngen, "launches": launches,
           "expected_launches": expect, "seconds_generate": secs,
           "profiler_seconds": record["profiler_s"],
           "prefill_ms": record["prefill"][0] * 1e3,
           "decode_step_ms_median": statistics.median(decode_s) * 1e3,
           "decode_step_ms": [t * 1e3 for t in record["decode"]],
           "tokens_per_s_wall": batch * ngen / wall,
           "peak_memory_gib": peak,
           "profiles": record["profiles"], "tokens_head": toks[:, :8].tolist()}
    print(f"[mla-generate] deepseek-v2-236b, {cfg.num_layers} of 60 layers "
          f"at full width, bf16, static_generate: batch {batch}, prompt "
          f"{plen}, {ngen} tokens: prefill {out['prefill_ms']:.2f} ms, "
          f"decode step median {out['decode_step_ms_median']:.2f} ms "
          f"(profiled steps excluded), {out['tokens_per_s_wall']:.1f} tok/s "
          f"of wall (the profiler's start and stop excluded), peak memory "
          f"{peak:.2f} GiB, launches {launches} [{smi}]", flush=True)
    for kind, prof_rec in record["profiles"].items():
        busy, win = prof_rec["device_busy_us"], prof_rec["window_us"]
        print(f"[mla-generate] torch.profiler over {prof_rec['steps']} "
              f"{kind} step(s): kernels {busy / 1e3:.3f} ms of device time "
              f"in {win / 1e3:.3f} ms of wall; by kernel: " + "; ".join(
                  f"{k['name'][:48]} x{k['count']} {k['us'] / 1e3:.3f} ms"
                  for k in prof_rec["kernels"][:10]), flush=True)
    return out


def mla_generate_gate(kern, params, counters):
    """The static path's fp32 gate (TF32 off) on phase 9's 2-layer gate
    weights, prompt 300, 8 tokens: the kernel path and the reference path
    give identical greedy tokens and every step's logits agree within
    ``MLA_GATE_TOL`` of the largest reference logit; one sequence through
    the paged engine gives the static path's tokens."""
    import numpy as np
    from repro_torch.launch import serve as tserve
    from repro_torch.models.kvcache import PagedLayout
    from repro_torch.models.model import build_model
    from repro_torch.serve import Request
    cfg = kern.cfg
    plen, ngen = MLA_GEN_GATE
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (MLA_GEN_B, plen)).astype(np.int32)
    runs = {}
    for name in ("kernel", "reference"):
        model = kern if name == "kernel" else build_model(
            dataclasses.replace(cfg, attention_impl="reference"),
            kern.device)
        rec = {"prefill": [], "decode": [], "finite": True, "logits": []}
        toks, launched, _, peak = _counted_generate(model, params, prompts,
                                                    ngen, counters, rec)
        check(rec["finite"], f"MLA generate gate {name}: non-finite logits")
        runs[name] = (toks, rec["logits"], launched, peak)
    want = {"kernel": (cfg.num_layers * (ngen - 1), cfg.num_layers),
            "reference": (0, 0)}
    got = {n: (r[2]["mla_decode_cuda"], r[2]["flash_attention_cuda"])
           for n, r in runs.items()}
    check(got == want and not any(
        r[2][k] for r in runs.values() for k in r[2]
        if k not in ("mla_decode_cuda", "flash_attention_cuda")),
          f"MLA generate gate launches: {[r[2] for r in runs.values()]}")
    steps = []
    for i, (g, w) in enumerate(zip(runs["kernel"][1], runs["reference"][1])):
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        steps.append({"step": i, "max_abs_err": err, "ref_max_abs": scale,
                      "tol": MLA_GATE_TOL * scale})
    same = bool(np.array_equal(runs["kernel"][0], runs["reference"][0]))
    # one sequence alone: the MoE's eval capacity, and so which tokens
    # it drops, depends on the batch
    single = tserve.static_generate(kern, params, prompts[:1], ngen)
    mbs = -(-(plen + ngen) // 16)
    eng = tserve.build_engine(
        kern, params, PagedLayout(block_size=16, num_blocks=mbs,
                                  max_blocks_per_seq=mbs),
        slots=1, prefill_batch=1, pod_speeds=[1.0])
    paged = eng.run([Request(rid=0, prompt=tuple(int(t) for t in prompts[0]),
                             max_new_tokens=ngen, arrival=0.0)]).tokens[0]
    same_paged = [int(t) for t in single[0]] == list(paged)
    worst = max(s_["max_abs_err"] / s_["tol"] for s_ in steps)
    print(f"[mla-generate] fp32 gate, {cfg.num_layers} layers, prompt "
          f"{plen}, {ngen} tokens: greedy tokens identical {same}, equal to "
          f"the paged engine's on one sequence {same_paged}; logits max abs "
          f"err by step " + ", ".join(f"{s_['max_abs_err']:.3e}"
                                      for s_ in steps)
          + f" (largest err/tol {worst:.3f}); peak "
          f"{runs['kernel'][3]:.2f} GiB", flush=True)
    check(same, "MLA generate gate: kernel and reference tokens differ")
    check(same_paged, "MLA generate gate: the static path and the paged "
          "engine differ on one sequence")
    check(len(steps) == ngen and all(s_["max_abs_err"] <= s_["tol"]
                                     for s_ in steps),
          f"MLA generate gate: logits differ beyond {MLA_GATE_TOL}")
    return {"layers": cfg.num_layers, "prompt": plen, "generated": ngen,
            "tokens_identical": same, "paged_engine_identical": same_paged,
            "steps": steps, "launches": {n: r[2] for n, r in runs.items()},
            "peak_memory_gib": runs["kernel"][3]}


# --------------------------------------------------------------------------
# zamba2 (Mamba2 hybrid): SSD kernel phase and generate path phase
# --------------------------------------------------------------------------

ZAMBA_P, ZAMBA_N = 64, 64           # SSM head dim P and state dim N
ZAMBA_HEADS, ZAMBA_DH = 32, 80      # the shared attention block
ZAMBA_RUN = (4, 1024, 64)           # batch, prompt, generated tokens
ZAMBA_GATE = (6, 300, 8)            # the fp32 gate: layers, prompt, tokens
# kernel path vs reference path logits of the fp32 gate (TF32 off): they
# differ in the SSD scan's and the prefill attention's summation order.
# Relative to the largest reference logit of the step (at least 1).
ZAMBA_GATE_TOL = 1e-3
# (B, S, H, G, chunk, with D): the path's shape first (zamba2's prefill:
# 80 heads, one group, chunk 256), then a ragged tail, S shorter than the
# chunk, two group layouts, and no D
SSD_CASES = [(4, 1024, 80, 1, 256, True), (4, 1000, 80, 1, 256, True),
             (2, 100, 80, 1, 256, True), (2, 512, 8, 2, 256, True),
             (2, 300, 6, 3, 128, True), (2, 700, 16, 1, 256, False)]
# decode steps of the 64-token run traced with torch.profiler, [first,
# last); the median decode step leaves them out
ZAMBA_PROFILE = (10, 13)


def ssd_flops_bytes(b, s, h, g, chunk, tensors):
    """The SSD scan's operations and bytes for these shapes: per (b, h)
    and chunk of q rows, C B^T and its product with dt x on the causal
    half (q (q + 1) / 2 pairs, N and P multiply-adds each), the carried
    state's term and the state update (q N P each); every input read
    once and every output written once."""
    q_full = min(chunk, s)
    rows = [min(q_full, s - t0) for t0 in range(0, s, q_full)]
    pairs = sum(q * (q + 1) // 2 for q in rows)
    flops = 2.0 * b * h * (pairs * (ZAMBA_N + ZAMBA_P)
                           + 2 * s * ZAMBA_N * ZAMBA_P)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return flops, nbytes


def ssd_case(sk, b, s, h, g, chunk, use_d, dtype, gen, dev, timed):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.parity import rel_l2

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = r(b, s, h, ZAMBA_P).to(dtype)
    dt = F.softplus(r(b, s, h) - 2.0)
    A = -torch.exp(r(h) * 0.5)
    Bm = (r(b, s, g, ZAMBA_N) * 0.3).to(dtype)
    Cm = (r(b, s, g, ZAMBA_N) * 0.3).to(dtype)
    D = r(h) if use_d else None
    args = (x, dt, A, Bm, Cm, D)
    y, fin = sk.ssd_scan_cuda(*args, chunk_size=chunk)
    yw, fw = sk.ssd_scan_plain(*args, chunk_size=chunk)
    torch.cuda.synchronize()
    check(y.dtype == dtype and fin.dtype == torch.float32
          and y.shape == x.shape and fin.shape == (b, h, ZAMBA_P, ZAMBA_N),
          f"SSD kernel: y {y.dtype} {tuple(y.shape)}, final {fin.dtype} "
          f"{tuple(fin.shape)}")
    y2, fin2 = sk.ssd_scan_cuda(*args, chunk_size=chunk)
    check(torch.equal(y2, y) and torch.equal(fin2, fin),
          f"SSD kernel {dtype} at {(b, s, h, g, chunk)}: two runs differ")
    rec = {"kernel": "ssd_scan_cuda", "dtype": str(dtype), "B": b, "S": s,
           "H": h, "G": g, "P": ZAMBA_P, "N": ZAMBA_N, "chunk": chunk,
           "with_D": use_d,
           "rel_l2": max(rel_l2(y, yw), rel_l2(fin, fw)),
           "rel_l2_y": rel_l2(y, yw), "rel_l2_final": rel_l2(fin, fw),
           "max_abs_err": max((y.float() - yw.float()).abs().max().item(),
                              (fin - fw).abs().max().item()),
           "bitwise_repeat": True}
    if timed:
        run = lambda: sk.ssd_scan_cuda(*args, chunk_size=chunk)
        rec["ms"] = cuda_ms(run)
        # the device time of each launch of a call (bf16: chunk states,
        # state passing, chunk scan), and their sum
        by_kernel = device_ms_by_kernel(run)
        rec["device_ms_by_launch"] = by_kernel and {
            next((k for k in ("ssd_chunk_state_sm90", "ssd_state_pass",
                              "ssd_chunk_scan_sm90", "ssd_scan_kernel")
                  if k in n), n[:60]): ms for n, ms in by_kernel.items()}
        rec["device_ms"] = by_kernel and sum(by_kernel.values())
        rec["plain_ms"] = cuda_ms(lambda: sk.ssd_scan_plain(
            *args, chunk_size=chunk))
        rec["library_ms"] = None        # no PyTorch call computes it
        flops, nbytes = ssd_flops_bytes(
            b, s, h, g, chunk, [t for t in args if t is not None]
            + [y, fin])
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops)
    return rec


def prefill80_case(fa, b, s, h, hkv, dtype, gen, dev, timed):
    """The shared attention block's prefill: head dim 80, causal."""
    import torch
    from repro_torch.kernels.parity import rel_l2
    q = torch.randn((b, s, h, ZAMBA_DH), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, ZAMBA_DH), generator=gen,
                    device=dev).to(dtype)
    v = torch.randn((b, s, hkv, ZAMBA_DH), generator=gen,
                    device=dev).to(dtype)
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    check(torch.equal(fa.flash_attention_cuda(q, k, v, causal=True), got),
          f"D=80 prefill {dtype} at S={s}: two runs differ")
    rec = {"kernel": "flash_attention_cuda", "dtype": str(dtype), "B": b,
           "S": s, "H": h, "Hkv": hkv, "D": ZAMBA_DH,
           "rel_l2": rel_l2(got, want),
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "bitwise_repeat": True}
    if timed:
        rec["ms"] = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v))
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(q, k, v))
        qt, kt, vt = _sdpa_layout(q, k, v)
        rec["library_ms"] = cuda_ms(lambda: _sdpa(qt, kt, vt, True))
        rec["bound_ms"], rec["bound_by"] = _attn_bound(
            b, s, h, hkv, ZAMBA_DH, 1.0, (q, k, v), (got,))
    return rec


def zamba_kernel_phase(fa, sk, dev, smi):
    """The SSD kernel and the D=80 prefill against their plain versions,
    fp32 (TF32 off) and bf16, by relative L2 (``parity.RTOL``); timed in
    bf16 at the generate phase's shapes (B=4, S=1024)."""
    import torch
    from repro_torch.kernels.parity import RTOL
    gen = torch.Generator(device=dev).manual_seed(10)
    b, s, _ = ZAMBA_RUN
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        new = [ssd_case(sk, *c, dtype, gen, dev, timed=bf16 and i == 0)
               for i, c in enumerate(SSD_CASES)]
        new += [prefill80_case(fa, bb, ss, h, hkv, dtype, gen, dev,
                               timed=bf16 and i == 0)
                for i, (bb, ss, h, hkv) in enumerate(
                    [(b, s, ZAMBA_HEADS, ZAMBA_HEADS), (2, 200, 8, 2),
                     (1, 16, ZAMBA_HEADS, ZAMBA_HEADS)])]
        for r in new:
            r["tol"] = RTOL[(r["kernel"], dtype)]
            shape = {k: r[k] for k in ("B", "S", "H", "G", "Hkv", "D",
                                       "chunk", "with_D") if k in r}
            print(f"[zamba-kernels] {r['kernel']} {r['dtype']} {shape}: "
                  f"rel L2 {r['rel_l2']:.3e} (tol {r['tol']:g}), max abs "
                  f"err {r['max_abs_err']:.3e}"
                  + (f", {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                     f"library "
                     + ("none" if r["library_ms"] is None
                        else f"{r['library_ms']:.4f} ms (SDPA)")
                     + f", bound {r['bound_ms']:.6f} ms ({r['bound_by']}) "
                       f"[{smi}]" if "ms" in r else "")
                  + (f"; device time {_ms_or_not(r['device_ms'])} by "
                     f"launch {r['device_ms_by_launch']}"
                     if "device_ms_by_launch" in r else ""), flush=True)
        bad = [f"{r['kernel']} {r['dtype']}: {r['rel_l2']}"
               for r in new if not r["rel_l2"] <= r["tol"]]
        check(not bad, "zamba kernels vs plain: " + "; ".join(bad))
        recs += new
    return recs


def _wrap_steps(model, record):
    """Wrap ``model.prefill`` / ``model.decode`` (what the static steps
    call): each call between two device syncs on the host clock, its
    logits kept (``record["logits"]``) when asked and checked finite."""
    import torch
    orig = {"prefill": model.prefill, "decode": model.decode}

    def wrap(kind):
        def run(*args, **kwargs):
            step = len(record[kind])
            prof = record.get("profile") if kind == "decode" else None
            if prof is not None and step == prof["lo"]:
                t0 = time.monotonic()
                prof["p"] = record["profiler"]()
                prof["p"].__enter__()
                prof["t0"] = time.monotonic()
                record["profiler_s"] += prof["t0"] - t0
            torch.cuda.synchronize()
            t0 = time.monotonic()
            logits, cache = orig[kind](*args, **kwargs)
            torch.cuda.synchronize()
            record[kind].append(time.monotonic() - t0)
            if prof is not None and step == prof["hi"] - 1:
                t0 = time.monotonic()
                wall_us = (t0 - prof["t0"]) * 1e6
                prof["p"].__exit__(None, None, None)
                record["profiles"]["decode"] = _profile_rec(
                    prof["p"], wall_us, prof["hi"] - prof["lo"])
                record["profiler_s"] += time.monotonic() - t0
            if "logits" in record:
                record["logits"].append(logits.float().cpu())
            record["finite"] &= bool(torch.isfinite(logits).all())
            return logits, cache
        return run
    model.prefill = wrap("prefill")
    model.decode = wrap("decode")


def _counted_generate(model, params, prompts, gen, counters, record):
    """``static_generate`` with every kernel counter zeroed just before
    and read just after."""
    import torch
    from repro_torch.launch import serve as tserve
    _wrap_steps(model, record)
    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    toks = tserve.static_generate(model, params, prompts, gen)
    seconds = time.monotonic() - t0
    launches = {n: f.launches for n, f in counters.items()}
    return toks, launches, seconds, torch.cuda.max_memory_allocated() / 2**30


def zamba_path_phase(fa, md, sk, dev, smi):
    """zamba2-2.7b at full width and depth (bf16, seed 0,
    attention_impl="kernel") generates 64 tokens after a 1024-token
    prompt for 4 sequences through ``launch.serve.static_generate``:
    exact launch counts, finite logits, timings, a profile of three
    decode steps. Then the fp32 gate on 6 layers: kernel path against
    reference path, identical greedy tokens and logits within
    ``ZAMBA_GATE_TOL``."""
    import gc
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.configs.base import resolve
    from repro_torch.launch import serve as tserve
    from repro_torch.models import transformer as tr
    from repro_torch.models.model import build_model

    held = torch.cuda.memory_allocated(dev) / 2**30
    print(f"[zamba-path] before: {held:.2f} GiB allocated on the card",
          flush=True)
    full = resolve("zamba2-2.7b")
    counters = {"ssd_scan_cuda": sk.ssd_scan_cuda,
                "flash_attention_cuda": fa.flash_attention_cuda,
                "flash_decode_paged_cuda": fa.flash_decode_paged_cuda,
                "mla_decode_paged_cuda": md.mla_decode_paged_cuda,
                "mla_decode_cuda": md.mla_decode_cuda}
    batch, plen, ngen = ZAMBA_RUN
    cfg = dataclasses.replace(full, attention_impl="kernel")
    model = build_model(cfg, dev)
    params = tr.cast_params(model.init_params(0), torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    weights = sum(t.numel() * t.element_size()
                  for t in tr.tree_leaves(params)) / 2**30
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, plen)).astype(np.int32)
    record = {"prefill": [], "decode": [], "finite": True, "profiles": {},
              "profiler_s": 0.0,
              "profile": {"lo": ZAMBA_PROFILE[0], "hi": ZAMBA_PROFILE[1]},
              "profiler": lambda: tprofile(activities=[
                  ProfilerActivity.CPU, ProfilerActivity.CUDA])}
    toks, launches, secs, peak = _counted_generate(model, params, prompts,
                                                 ngen, counters, record)
    groups = cfg.num_layers // cfg.hybrid.attn_every
    expect = {"ssd_scan_cuda": cfg.num_layers,
              "flash_attention_cuda": groups,
              "flash_decode_paged_cuda": 0, "mla_decode_paged_cuda": 0,
              "mla_decode_cuda": 0}
    check(launches == expect, f"zamba launches {launches} != {expect}")
    check(toks.shape == (batch, ngen), f"zamba tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "zamba token id out of vocab")
    check(record["finite"], "zamba: non-finite logits")
    check(len(record["prefill"]) == 1 and len(record["decode"]) == ngen - 1,
          f"zamba steps {len(record['prefill'])} prefill, "
          f"{len(record['decode'])} decode")
    lo, hi = ZAMBA_PROFILE
    decode_s = record["decode"][:lo] + record["decode"][hi:]
    wall = secs - record["profiler_s"]
    # the prefill once more under the profiler (after the counted run)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        model.prefill(params, torch.as_tensor(prompts, device=dev),
                      max_len=plen + ngen)
        torch.cuda.synchronize()
        pre_wall = (time.monotonic() - t0) * 1e6
    record["profiles"]["prefill"] = _profile_rec(prof, pre_wall)
    out = {"layers": cfg.num_layers, "batch": batch, "prompt": plen,
           "generated": ngen, "launches": launches,
           "expected_launches": expect, "seconds": secs,
           "profiler_seconds": record["profiler_s"],
           "prefill_ms": record["prefill"][0] * 1e3,
           "decode_step_ms_median": statistics.median(decode_s) * 1e3,
           "decode_step_ms": [t * 1e3 for t in record["decode"]],
           "tokens_per_s_wall": batch * ngen / wall,
           "peak_memory_gib": peak, "weights_gib": weights,
           "profiles": record["profiles"], "tokens_head": toks[:, :8].tolist()}
    print(f"[zamba-path] zamba2-2.7b, {cfg.num_layers} layers at full width, "
          f"bf16, batch {batch}, prompt {plen}, {ngen} tokens: prefill "
          f"{out['prefill_ms']:.2f} ms, decode step median "
          f"{out['decode_step_ms_median']:.2f} ms (profiled steps "
          f"excluded), {out['tokens_per_s_wall']:.1f} tok/s of wall "
          f"(the profiler's start and stop excluded), peak memory "
          f"{peak:.2f} GiB (weights {weights:.2f} GiB), launches "
          f"{launches} [{smi}]", flush=True)
    for kind, prof_rec in record["profiles"].items():
        busy, win = prof_rec["device_busy_us"], prof_rec["window_us"]
        print(f"[zamba-path] torch.profiler over {prof_rec['steps']} "
              f"{kind} step(s): kernels {busy / 1e3:.3f} ms of device time "
              f"in {win / 1e3:.3f} ms of wall; by kernel: " + "; ".join(
                  f"{k['name'][:48]} x{k['count']} {k['us'] / 1e3:.3f} ms"
                  for k in prof_rec["kernels"][:10]), flush=True)
    del model, params, prof
    gc.collect()
    torch.cuda.empty_cache()

    # the fp32 gate: 6 layers (one group), prompt 300 (a full chunk and
    # a ragged tail), 8 tokens; kernel path against reference path
    layers, gplen, ggen = ZAMBA_GATE
    gcfg = dataclasses.replace(full, num_layers=layers,
                               compute_dtype="float32",
                               attention_impl="kernel")
    kern = build_model(gcfg, dev)
    gparams = kern.init_params(0)
    gprompts = np.random.default_rng(1).integers(
        0, gcfg.vocab_size, (batch, gplen)).astype(np.int32)
    runs = {}
    for name in ("kernel", "reference"):
        model = kern if name == "kernel" else build_model(
            dataclasses.replace(gcfg, attention_impl="reference"), dev)
        rec = {"prefill": [], "decode": [], "finite": True, "logits": []}
        gtoks, glaunch, _, gpeak = _counted_generate(
            model, gparams, gprompts, ggen, counters, rec)
        check(rec["finite"], f"zamba gate {name}: non-finite logits")
        runs[name] = (gtoks, rec["logits"], glaunch, gpeak)
    check(runs["kernel"][2]["ssd_scan_cuda"] == layers
          and runs["kernel"][2]["flash_attention_cuda"] == 1
          and runs["reference"][2]["ssd_scan_cuda"] == 0
          and runs["reference"][2]["flash_attention_cuda"] == 0,
          f"zamba gate launches: kernel {runs['kernel'][2]}, reference "
          f"{runs['reference'][2]}")
    steps = []
    for i, (g, w) in enumerate(zip(runs["kernel"][1], runs["reference"][1])):
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        steps.append({"step": i, "max_abs_err": err, "ref_max_abs": scale,
                      "tol": ZAMBA_GATE_TOL * scale})
    same = bool(np.array_equal(runs["kernel"][0], runs["reference"][0]))
    worst = max(s_["max_abs_err"] / s_["tol"] for s_ in steps)
    print(f"[zamba-path] fp32 gate, {layers} layers, prompt {gplen}, {ggen} "
          f"tokens: greedy tokens identical {same}; logits max abs err by "
          f"step " + ", ".join(f"{s_['max_abs_err']:.3e}" for s_ in steps)
          + f" (largest err/tol {worst:.3f}); peak "
          f"{runs['kernel'][3]:.2f} GiB", flush=True)
    check(same, "zamba gate: kernel and reference tokens differ")
    check(len(steps) == ggen and all(s_["max_abs_err"] <= s_["tol"]
                                     for s_ in steps),
          f"zamba gate: logits differ beyond {ZAMBA_GATE_TOL}")
    out["gate"] = {"layers": layers, "prompt": gplen, "generated": ggen,
                   "tokens_identical": same, "steps": steps,
                   "launches": {n: r[2] for n, r in runs.items()},
                   "peak_memory_gib": runs["kernel"][3]}
    del kern, model, gparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# xLSTM: mLSTM kernel phase and generate path phase
# --------------------------------------------------------------------------

XLSTM_RUN = (4, 1024, 64)           # batch, prompt, generated tokens
XLSTM_GATE = (300, 8)               # the fp32 gate at full depth: prompt,
                                    # tokens
# kernel path vs reference path logits of the fp32 gate (TF32 off): they
# differ in the mLSTM scan's summation order only. Relative to the
# largest reference logit of the step (at least 1).
XLSTM_GATE_TOL = 1e-3
# (B, S, H, dk, dv, chunk): the path's shape first (xlstm-125m's prefill:
# 4 heads of 384, chunk 256), then a ragged tail, S shorter than the
# chunk, the Pallas wrapper's chunk of 128, and the smoke widths
MLSTM_CASES = [(4, 1024, 4, 384, 384, 256), (4, 1000, 4, 384, 384, 256),
               (2, 100, 4, 384, 384, 256), (2, 300, 4, 384, 384, 128),
               (2, 300, 2, 64, 64, 256)]
# decode steps of the 64-token run traced with torch.profiler, [first,
# last); the median decode step leaves them out
XLSTM_PROFILE = (10, 13)


def mlstm_flops_bytes(b, s, h, dk, dv, chunk, tensors):
    """The mLSTM scan's operations and bytes for these shapes: per (b, h)
    and chunk of q rows, q k^T and the weighted sum of v on the causal
    half (q (q + 1) / 2 pairs, dk and dv multiply-adds each); q C and
    q.n for every row after the first chunk (the state is zero before
    it); the state update C and n over every row; every input read once
    and every output written once."""
    q_full = min(chunk, s)
    rows = [min(q_full, s - t0) for t0 in range(0, s, q_full)]
    pairs = sum(q * (q + 1) // 2 for q in rows)
    flops = 2.0 * b * h * (pairs * (dk + dv)
                           + (s - rows[0]) * dk * (dv + 1)
                           + s * dk * (dv + 1))
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return flops, nbytes


def mlstm_case(mk, b, s, h, dk, dv, chunk, dtype, gen, dev, timed):
    import torch
    from repro_torch.kernels.parity import rel_l2

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q, k, v = (r(b, s, h, dk).to(dtype), r(b, s, h, dk).to(dtype),
               r(b, s, h, dv).to(dtype))
    # the gate pre-activations as xlstm-125m's init sets them up: i~
    # about N(0, 1), f~ shifted by its bias of 3..6
    i_pre, f_pre = r(b, s, h), r(b, s, h) + 3.0
    args = (q, k, v, i_pre, f_pre)
    hout, state = mk.mlstm_scan_cuda(*args, chunk_size=chunk)
    hw, state_w = mk.mlstm_scan_plain(*args, chunk_size=chunk)
    torch.cuda.synchronize()
    check(hout.dtype == dtype and hout.shape == (b, s, h, dv)
          and tuple(x.shape for x in state) == ((b, h, dk, dv), (b, h, dk),
                                                (b, h))
          and all(x.dtype == torch.float32 for x in state),
          f"mLSTM kernel: h {hout.dtype} {tuple(hout.shape)}, state "
          f"{[(x.dtype, tuple(x.shape)) for x in state]}")
    outs = list(zip(("h", "C", "n", "m"), (hout,) + state, (hw,) + state_w))
    errs = {name: rel_l2(g, w) for name, g, w in outs}
    h2, state2 = mk.mlstm_scan_cuda(*args, chunk_size=chunk)
    check(all(torch.equal(a, b_) for a, b_ in zip((h2,) + state2,
                                                  (hout,) + state)),
          f"mLSTM kernel {dtype} at {(b, s, h, dk, dv, chunk)}: two runs "
          f"differ")
    rec = {"kernel": "mlstm_scan_cuda", "dtype": str(dtype), "B": b, "S": s,
           "H": h, "dk": dk, "dv": dv, "chunk": chunk,
           "rel_l2": max(errs.values()), "rel_l2_by_output": errs,
           "max_abs_err": max((g.float() - w.float()).abs().max().item()
                              for _, g, w in outs),
           "bitwise_repeat": True}
    if timed:
        run = lambda: mk.mlstm_scan_cuda(*args, chunk_size=chunk)
        rec["ms"] = cuda_ms(run)
        # the device time of each launch of a call (bf16: chunk states,
        # state passing, chunk scan), and their sum
        by_kernel = device_ms_by_kernel(run)
        rec["device_ms_by_launch"] = by_kernel and {
            next((k for k in MLSTM_LAUNCHES + ("mlstm_scan_kernel",)
                  if k in n), n[:60]): ms for n, ms in by_kernel.items()}
        rec["device_ms"] = by_kernel and sum(by_kernel.values())
        rec["plain_ms"] = cuda_ms(lambda: mk.mlstm_scan_plain(
            *args, chunk_size=chunk))
        rec["library_ms"] = None        # no PyTorch call computes it
        flops, nbytes = mlstm_flops_bytes(b, s, h, dk, dv, chunk,
                                          list(args) + [hout, *state])
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops)
    return rec


def xlstm_kernel_phase(mk, dev, smi):
    """The mLSTM kernel against its plain version, fp32 (TF32 off) and
    bf16, by relative L2 (``parity.RTOL``; the largest over h, C, n and
    m), two runs of every case bitwise equal; every case printed before
    any is checked; timed in bf16 at the generate phase's shape (B=4,
    S=1024), also by the device time of each launch."""
    import torch
    from repro_torch.kernels.parity import RTOL
    gen = torch.Generator(device=dev).manual_seed(12)
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        recs += [mlstm_case(mk, *c, dtype, gen, dev, timed=bf16 and i == 0)
                 for i, c in enumerate(MLSTM_CASES)]
    for r in recs:
        r["tol"] = RTOL[(r["kernel"], {"torch.float32": torch.float32,
                                       "torch.bfloat16": torch.bfloat16}[
                                           r["dtype"]])]
        shape = {k: r[k] for k in ("B", "S", "H", "dk", "dv", "chunk")}
        print(f"[xlstm-kernels] {r['kernel']} {r['dtype']} {shape}: rel L2 "
              f"{r['rel_l2']:.3e} (tol {r['tol']:g}; "
              + ", ".join(f"{k} {v:.3e}"
                          for k, v in r["rel_l2_by_output"].items())
              + f"), max abs err {r['max_abs_err']:.3e}"
              + (f", {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                 f"library none, bound {r['bound_ms']:.6f} ms "
                 f"({r['bound_by']}) [{smi}]; device time "
                 f"{_ms_or_not(r['device_ms'])} by launch "
                 f"{r['device_ms_by_launch']}" if "ms" in r else ""),
              flush=True)
    bad = [f"{r['kernel']} {r['dtype']} S={r['S']}: {r['rel_l2']}"
           for r in recs if not r["rel_l2"] <= r["tol"]]
    check(not bad, "mLSTM kernel vs plain: " + "; ".join(bad))
    return recs


def _block_timed_prefill(model, params, prompts, max_len):
    """One prefill under torch.profiler with every mLSTM and sLSTM block
    between two device syncs on the host clock: the blocks' wall time by
    kind, and the window's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.models import transformer as tr
    orig = {"mlstm": tr.mlstm_block, "slstm": tr.slstm_block}
    wall = {"mlstm": 0.0, "slstm": 0.0}

    def timed(kind):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = orig[kind](*args, **kwargs)
            torch.cuda.synchronize()
            wall[kind] += time.monotonic() - t0
            return out
        return run
    tr.mlstm_block, tr.slstm_block = timed("mlstm"), timed("slstm")
    try:
        # kernels only: the sLSTM loop's ~500,000 host ops would cost the
        # profiler's event processing about a minute, and nothing reads
        # them
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            model.prefill(params,
                          torch.as_tensor(prompts, device=model.device),
                          max_len=max_len)
            torch.cuda.synchronize()
            pre_wall = time.monotonic() - t0
    finally:
        tr.mlstm_block, tr.slstm_block = orig["mlstm"], orig["slstm"]
    rec = _profile_rec(prof, pre_wall * 1e6)
    rec["block_wall_ms"] = {k: v * 1e3 for k, v in wall.items()}
    return rec


def xlstm_path_phase(counters, dev, smi):
    """xlstm-125m at full width and depth (bf16, seed 0,
    attention_impl="kernel") generates 64 tokens after a 1024-token
    prompt for 4 sequences through ``launch.serve.static_generate``:
    exact launch counts, finite logits, timings, a profile of three
    decode steps and of a prefill. Then the fp32 gate at full depth:
    kernel path against reference path, identical greedy tokens and
    logits within ``XLSTM_GATE_TOL``."""
    import gc
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.configs.base import resolve
    from repro_torch.models import transformer as tr
    from repro_torch.models.model import build_model

    held = torch.cuda.memory_allocated(dev) / 2**30
    print(f"[xlstm-path] before: {held:.2f} GiB allocated on the card",
          flush=True)
    full = resolve("xlstm-125m")
    pairs = full.num_layers // 2
    batch, plen, ngen = XLSTM_RUN
    cfg = dataclasses.replace(full, attention_impl="kernel")
    model = build_model(cfg, dev)
    params = tr.cast_params(model.init_params(0), torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    weights = sum(t.numel() * t.element_size()
                  for t in tr.tree_leaves(params)) / 2**30
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, plen)).astype(np.int32)
    record = {"prefill": [], "decode": [], "finite": True, "profiles": {},
              "profiler_s": 0.0,
              "profile": {"lo": XLSTM_PROFILE[0], "hi": XLSTM_PROFILE[1]},
              "profiler": lambda: tprofile(activities=[
                  ProfilerActivity.CPU, ProfilerActivity.CUDA])}
    toks, launches, secs, peak = _counted_generate(model, params, prompts,
                                                   ngen, counters, record)
    expect = {n: (pairs if n == "mlstm_scan_cuda" else 0) for n in counters}
    check(launches == expect, f"xlstm launches {launches} != {expect}")
    check(toks.shape == (batch, ngen), f"xlstm tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "xlstm token id out of vocab")
    check(record["finite"], "xlstm: non-finite logits")
    check(len(record["prefill"]) == 1 and len(record["decode"]) == ngen - 1,
          f"xlstm steps {len(record['prefill'])} prefill, "
          f"{len(record['decode'])} decode")
    lo, hi = XLSTM_PROFILE
    decode_s = record["decode"][:lo] + record["decode"][hi:]
    wall = secs - record["profiler_s"]
    # the prefill once more under the profiler (after the counted run),
    # its blocks timed by kind
    record["profiles"]["prefill"] = _block_timed_prefill(
        model, params, prompts, plen + ngen)
    out = {"layers": cfg.num_layers, "batch": batch, "prompt": plen,
           "generated": ngen, "launches": launches,
           "expected_launches": expect, "seconds": secs,
           "profiler_seconds": record["profiler_s"],
           "prefill_ms": record["prefill"][0] * 1e3,
           "decode_step_ms_median": statistics.median(decode_s) * 1e3,
           "decode_step_ms": [t * 1e3 for t in record["decode"]],
           "tokens_per_s_wall": batch * ngen / wall,
           "peak_memory_gib": peak, "weights_gib": weights,
           "profiles": record["profiles"], "tokens_head": toks[:, :8].tolist()}
    print(f"[xlstm-path] xlstm-125m, {cfg.num_layers} layers at full width, "
          f"bf16, batch {batch}, prompt {plen}, {ngen} tokens: prefill "
          f"{out['prefill_ms']:.2f} ms, decode step median "
          f"{out['decode_step_ms_median']:.2f} ms (profiled steps "
          f"excluded), {out['tokens_per_s_wall']:.1f} tok/s of wall "
          f"(the profiler's start and stop excluded), peak memory "
          f"{peak:.2f} GiB (weights {weights:.2f} GiB), launches "
          f"{launches} [{smi}]", flush=True)
    blocks = record["profiles"]["prefill"]["block_wall_ms"]
    print(f"[xlstm-path] profiled prefill, blocks between syncs: mLSTM "
          f"{blocks['mlstm']:.2f} ms, sLSTM {blocks['slstm']:.2f} ms of "
          f"{record['profiles']['prefill']['window_us'] / 1e3:.2f} ms",
          flush=True)
    for kind, prof_rec in record["profiles"].items():
        busy, win = prof_rec["device_busy_us"], prof_rec["window_us"]
        print(f"[xlstm-path] torch.profiler over {prof_rec['steps']} "
              f"{kind} step(s): kernels {busy / 1e3:.3f} ms of device time "
              f"in {win / 1e3:.3f} ms of wall; by kernel: " + "; ".join(
                  f"{k['name'][:48]} x{k['count']} {k['us'] / 1e3:.3f} ms"
                  for k in prof_rec["kernels"][:10]), flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # the fp32 gate at full depth: prompt 300 (a full chunk and a ragged
    # tail), 8 tokens; kernel path against reference path
    gplen, ggen = XLSTM_GATE
    gcfg = dataclasses.replace(full, compute_dtype="float32",
                               attention_impl="kernel")
    kern = build_model(gcfg, dev)
    gparams = kern.init_params(0)
    gprompts = np.random.default_rng(1).integers(
        0, gcfg.vocab_size, (batch, gplen)).astype(np.int32)
    runs = {}
    for name in ("kernel", "reference"):
        model = kern if name == "kernel" else build_model(
            dataclasses.replace(gcfg, attention_impl="reference"), dev)
        rec = {"prefill": [], "decode": [], "finite": True, "logits": []}
        gtoks, glaunch, _, gpeak = _counted_generate(
            model, gparams, gprompts, ggen, counters, rec)
        check(rec["finite"], f"xlstm gate {name}: non-finite logits")
        runs[name] = (gtoks, rec["logits"], glaunch, gpeak)
    check(runs["kernel"][2]["mlstm_scan_cuda"] == pairs
          and runs["reference"][2]["mlstm_scan_cuda"] == 0,
          f"xlstm gate launches: kernel {runs['kernel'][2]}, reference "
          f"{runs['reference'][2]}")
    steps = []
    for i, (g, w) in enumerate(zip(runs["kernel"][1], runs["reference"][1])):
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        steps.append({"step": i, "max_abs_err": err, "ref_max_abs": scale,
                      "tol": XLSTM_GATE_TOL * scale})
    same = bool(np.array_equal(runs["kernel"][0], runs["reference"][0]))
    worst = max(s_["max_abs_err"] / s_["tol"] for s_ in steps)
    print(f"[xlstm-path] fp32 gate, {gcfg.num_layers} layers, prompt "
          f"{gplen}, {ggen} tokens: greedy tokens identical {same}; logits "
          f"max abs err by step "
          + ", ".join(f"{s_['max_abs_err']:.3e}" for s_ in steps)
          + f" (largest err/tol {worst:.3f}); peak "
          f"{runs['kernel'][3]:.2f} GiB", flush=True)
    check(same, "xlstm gate: kernel and reference tokens differ")
    check(len(steps) == ggen and all(s_["max_abs_err"] <= s_["tol"]
                                     for s_ in steps),
          f"xlstm gate: logits differ beyond {XLSTM_GATE_TOL}")
    out["gate"] = {"layers": gcfg.num_layers, "prompt": gplen,
                   "generated": ggen, "tokens_identical": same,
                   "steps": steps,
                   "launches": {n: r[2] for n, r in runs.items()},
                   "peak_memory_gib": runs["kernel"][3]}
    del kern, model, gparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# checkpoint and re-mesh path phase
# --------------------------------------------------------------------------

# phase 14's re-mesh run: phase 7's settings at full width, the depth cut
# to 1 layer (a two-pod checkpoint holds the residual of both pods, about
# twice the bytes; the script's run neared its time limit at 4 layers, and
# again at 2 once phase 20 was added), capacities
# 1,1, a checkpoint every 4 steps and pod 1
# lost at step 3: three missed reports later (step 5) the replan cannot
# fit the global batch in pod 0's buffer, and the run restarts on one pod
# from the step-4 checkpoint, accum x2, to step 6
REMESH_LAYERS = 1
REMESH_ARGV = [a for a in MULTI_ARGV]
for _flag, _value in (("--capacities", "1,1"), ("--steps", "6")):
    REMESH_ARGV[REMESH_ARGV.index(_flag) + 1] = _value
REMESH_ARGV += ["--ckpt-every", "4", "--kill-pod", "1@3"]
# the resume runs: phase 5's settings (olmo-1b at full width, 8 rows of
# 1024, accum 2) with the depth cut to RESUME_LAYERS (the checks do not
# grow with depth, and at full depth the script's run neared its time
# limit once phase 15 was added, at 4 layers once phase 19 was, at 2 once
# phase 20 was). The
# first takes RESUME_FIRST steps with checkpoints at steps 12 and 24: its
# steps 2-12 run with no write in flight and its steps 13-24 while step
# 12's write is (a write outlasts 12 steps), the two medians of one
# process. The second resumes from step 24 to
# RESUME_STEPS, against that many uninterrupted steps.
RESUME_LAYERS = 1
RESUME_CKPT_EVERY = 12
RESUME_FIRST = 24
RESUME_STEPS = 26
# a checkpoint's fp32 arrays: parameters, AdamW m and v
CKPT_ARRAYS = 3
SUMMARY = "[train] summary "


def train_launches(cfg, buffer_rows, accum, seq_len, steps,
                   exchange_chunks=0):
    """The driver's counters after ``steps`` steps of one rank: the
    exchange's three legs once an exchange chunk each (kernels 4 and 5's
    own entry points never)."""
    from repro_torch.kernels.cross_entropy.cross_entropy import BWD_CHUNK
    ce_chunks = -(-(buffer_rows // accum) * seq_len // BWD_CHUNK)
    fwd = 2 if cfg.remat == "full" else 1          # remat: once more
    L = cfg.num_layers
    return {"flash_attention_cuda": fwd * L * accum * steps,
            "flash_attention_bwd_cuda": L * accum * steps,
            "cross_entropy_cuda": accum * steps,
            "ce_dlogits_cuda": ce_chunks * accum * steps,
            "quantize_int8_cuda": 0, "dequant_accum_cuda": 0,
            **{n: exchange_chunks * steps for n in LEG_NAMES}}


def run_driver(argv, tag, layers=None, timeout=900):
    """``repro_torch.launch.train`` in a fresh process (``python -m``;
    with ``layers``, the same ``main`` with olmo-1b's depth cut, since
    the CLI has no depth flag): its ``[train]`` and ``[ckpt]`` lines
    echoed, and its summary."""
    import os
    if layers is None:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *argv]
    else:
        prog = ("import dataclasses, sys\n"
                "from repro_torch.configs import base\n"
                "from repro_torch.launch import train\n"
                "base.register('olmo-1b-cut', *(lambda get=get: "
                f"dataclasses.replace(get('olmo-1b'), num_layers={layers})"
                " for get in (base.resolve, base.smoke_config)))\n"
                "train.main(sys.argv[1:])\n")
        argv = list(argv)
        argv[argv.index("--arch") + 1] = "olmo-1b-cut"
        cmd = [sys.executable, "-c", prog, *argv]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.monotonic() - t0
    lines = proc.stdout.splitlines()
    for line in lines:
        if line.startswith(("[train]", "[ckpt]")) and \
                not line.startswith(SUMMARY):
            print(f"[{tag}] {line}", flush=True)
    check(proc.returncode == 0, f"{tag}: the driver exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    found = [ln for ln in lines if ln.startswith(SUMMARY)]
    check(len(found) == 1, f"{tag}: no summary line")
    return proc.stdout, json.loads(found[0][len(SUMMARY):]), wall


def ckpt_phase(smi, train_rec):
    """Phase 14: checkpoints, resume and the elastic re-mesh through the
    driver, each run a fresh process under a temporary ``--ckpt-dir``
    (removed after): the disk check, the one-rank resume at full width
    and RESUME_LAYERS of depth (bitwise against an uninterrupted run)
    and the two-pod run that loses a pod and re-meshes (2 layers:
    ``REMESH_LAYERS``)."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.checkpoint import repack
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core import buckets as bkt
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    from repro_torch.models.model import build_model

    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[ckpt-phase] this process holds "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB on the card "
          f"before the drivers start", flush=True)
    root = Path(tempfile.mkdtemp(prefix="hetseq_ckpt_phase_"))
    out = {}
    try:
        # 1. disk: the resume runs keep two checkpoints, the re-mesh run
        # two of its own (one two-pod, one one-pod)
        args = ttrain.parser().parse_args(TRAIN_ARGV)
        margs = ttrain.parser().parse_args(REMESH_ARGV)
        cfg = dataclasses.replace(ttrain.build_config(args)[0],
                                  num_layers=RESUME_LAYERS)
        cut = dataclasses.replace(ttrain.build_config(margs)[0],
                                  num_layers=REMESH_LAYERS)
        ckpt_bytes = CKPT_ARRAYS * 4 * cfg.param_count()
        cut_bytes = (CKPT_ARRAYS + EXCHANGE_RANKS) * 4 * cut.param_count()
        need = max(2 * ckpt_bytes, 2 * cut_bytes)
        free = shutil.disk_usage(root).free
        print(f"[ckpt-phase] {root}: {free / 1e9:.1f} GB free, a "
              f"checkpoint of olmo-1b at {RESUME_LAYERS} layers "
              f"{ckpt_bytes / 1e9:.2f} GB (fp32 parameters, m, v), of the "
              f"{REMESH_LAYERS}-layer two-pod run "
              f"{cut_bytes / 1e9:.2f} GB; the phase needs "
              f"{need / 1e9:.1f} GB", flush=True)
        check(free >= need, f"checkpoint phase: {free} bytes free at "
              f"{root}, the phase needs {need}")

        # 2. resume on one rank, olmo-1b at RESUME_LAYERS: RESUME_FIRST
        # steps with checkpoints, then --resume to RESUME_STEPS, against
        # RESUME_STEPS uninterrupted steps
        data = ["--data-dir", str(root / "data")]
        ck = ["--ckpt-dir", str(root / "resume")]
        base = [a for a in TRAIN_ARGV]
        steps_at = base.index("--steps") + 1
        base[steps_at] = str(RESUME_STEPS)
        first = list(base)
        first[steps_at] = str(RESUME_FIRST)
        _, a, a_s = run_driver(first + data + ck + [
            "--ckpt-every", str(RESUME_CKPT_EVERY)], "resume-1",
            layers=RESUME_LAYERS)
        _, b, b_s = run_driver(base + data + ck + ["--resume"], "resume-2",
                               layers=RESUME_LAYERS)
        _, c, c_s = run_driver(base + data, "uninterrupted",
                               layers=RESUME_LAYERS)
        ra, rb, rc = (x["worlds"][0]["ranks"][0] for x in (a, b, c))
        plan = ttrain.make_plan(ttrain.build_config(args)[1])
        n_b = RESUME_STEPS - RESUME_FIRST
        per = {n: train_launches(cfg, plan.buffer_rows, args.accum,
                                 args.seq_len, n)
               for n in (RESUME_FIRST, n_b, RESUME_STEPS)}
        check(ra["launches"] == per[RESUME_FIRST]
              and rb["launches"] == per[n_b]
              and rc["launches"] == per[RESUME_STEPS],
              f"checkpoint phase launches {ra['launches']}, "
              f"{rb['launches']}, {rc['launches']} != "
              f"{per[RESUME_FIRST]}, {per[n_b]}, {per[RESUME_STEPS]}")
        check(rb["restore"] is not None
              and rb["restore"]["step"] == RESUME_FIRST
              and rb["start_step"] == RESUME_FIRST,
              f"resume: {rb['restore']}")
        check(b["losses"] == c["losses"][RESUME_FIRST:] and a["losses"] ==
              c["losses"][:RESUME_FIRST] and all(map(_finite, c["losses"])),
              f"resume: losses {a['losses']} + {b['losses']} vs "
              f"{c['losses']}")
        check(b["end_checksums"] == c["end_checksums"],
              f"resume: parameter checksums {b['end_checksums']} vs "
              f"{c['end_checksums']}")
        writes, saves = ra["writes"], ra["saves"]
        check(ckpt_bytes <= writes[0]["bytes"] <= 1.01 * ckpt_bytes,
              f"resume: a checkpoint of {writes[0]['bytes']} bytes, "
              f"{ckpt_bytes} predicted")
        check([w["step"] for w in writes] == list(range(
            RESUME_CKPT_EVERY, RESUME_FIRST + 1, RESUME_CKPT_EVERY))
              and all(w["attempts"] == 1 for w in writes),
              f"resume: writes {writes}")
        # steps 2.. of the first run, split by whether a write was in
        # flight when the step began
        timed = list(zip(ra["step_s"], ra["during_save"]))[1:]
        in_flight = [t for t, busy in timed if busy]
        no_write = [t for t, busy in timed if not busy]
        check(in_flight and no_write, f"resume: steps with a write in "
              f"flight {ra['during_save']}")
        ms_save = statistics.median(in_flight) * 1e3
        ms_idle = statistics.median(no_write) * 1e3
        ms_c = statistics.median(rc["step_s"][1:]) * 1e3
        ms_p5 = train_rec["ms_per_step_median_2_to_n"]
        rest = rb["restore"]
        print(f"[ckpt-phase] olmo-1b ({RESUME_LAYERS} layers) resume: "
              f"bitwise equal to the "
              f"uninterrupted run (losses of steps {RESUME_FIRST + 1}-"
              f"{RESUME_STEPS} {b['losses']}, "
              f"parameter checksum {b['end_checksums'][0]}) [{smi}]",
              flush=True)
        for w, sv in zip(writes, saves):
            print(f"[ckpt-phase] checkpoint at step {w['step']}: "
                  f"{w['bytes']} bytes; the loop waited "
                  f"{sv['snapshot_s']:.2f} s for the host snapshot and "
                  f"{sv['wait_s']:.2f} s for the previous write; the "
                  f"writer thread {w['seconds']:.2f} s (write and fsync "
                  f"{w['write_s']:.2f} s, sha256 {w['sha256_s']:.2f} s) "
                  f"[{smi}]", flush=True)
        print(f"[ckpt-phase] restore of step {RESUME_FIRST}: "
              f"{rest['seconds']:.2f} s (manifest check "
              f"{rest['verify_s']:.2f} s, loading {rest['load_s']:.2f} s, "
              f"repack {rest['adapt_s']:.2f} s, the rest onto the card); "
              f"median step while a save is in flight {ms_save:.1f} ms "
              f"({len(in_flight)} steps) against {ms_idle:.1f} ms with no "
              f"write in flight ({len(no_write)} steps of the same run), "
              f"{ms_c:.1f} ms (the uninterrupted run, steps 2-"
              f"{RESUME_STEPS}) and phase 5's {ms_p5:.1f} ms [{smi}]",
              flush=True)
        out["resume"] = {
            "checkpoint_bytes": writes[0]["bytes"],
            "predicted_checkpoint_bytes": ckpt_bytes,
            "writes": writes, "saves": saves, "restore": rest,
            "ms_step_during_save": ms_save, "in_flight_step_s": in_flight,
            "ms_step_no_write": ms_idle, "no_write_step_s": no_write,
            "ms_step_uninterrupted": ms_c, "ms_step_phase5": ms_p5,
            "losses": c["losses"], "end_checksum": c["end_checksums"][0],
            "launches": {"resume-1": ra["launches"],
                         "resume-2": rb["launches"],
                         "uninterrupted": rc["launches"]},
            "process_seconds": [a_s, b_s, c_s]}
        shutil.rmtree(root / "resume")

        # 3. the re-mesh on two ranks sharing the card
        rdir = root / "remesh"
        text, r, r_s = run_driver(REMESH_ARGV + data + [
            "--ckpt-dir", str(rdir)], "remesh", layers=REMESH_LAYERS)
        for needle in ("remesh:", "re-meshed to", "accum_steps scaled x2"):
            check(needle in text, f"re-mesh: no '{needle}' line")
        check(len(r["worlds"]) == 2, f"re-mesh: {len(r['worlds'])} worlds")
        w0, w1 = (w["ranks"] for w in r["worlds"])
        rec = w0[0]["remesh"]
        check(len(w0) == 2 and len(w1) == 1 and all(
            x["remesh"] == rec and x["replans"] == w0[0]["replans"]
            for x in w0), f"re-mesh: ranks disagree: "
            f"{[(x['remesh'], x['replans']) for x in w0]}")
        check(rec is not None and rec["dead"] == [1]
              and rec["checkpoint"] == 4, f"re-mesh: {rec}")
        check(r["steps"] == margs.steps and len(r["losses"]) == margs.steps
              and all(map(_finite, r["losses"])),
              f"re-mesh: losses {r['losses']}")
        mplan = ttrain.make_plan(ttrain.build_config(margs)[1], 2)
        chunks = bkt.exchange_chunks(exchange_layout(cut))
        want = train_launches(cut, mplan.buffer_rows, margs.accum,
                              margs.seq_len, rec["step"], chunks)
        for x in w0:
            check(x["launches"] == want, f"re-mesh: rank {x['rank']} "
                  f"launches {x['launches']} != {want}")
        check(all(w1[0]["launches"][n] == 0 for n in (
            "quantize_int8_cuda", "dequant_accum_cuda", *LEG_NAMES))
              and w1[0]["start_step"] == 4, f"re-mesh: the one-pod world "
              f"{w1[0]['launches']} from step {w1[0]['start_step']}")
        # the two-pod residual through the restore: its sum over the
        # ranks conserved bitwise into 1 and 3 ranks
        rcfg = dataclasses.replace(
            ttrain.build_config(margs)[1], model=cut)
        model = build_model(cut, "cpu")
        tpl = tsteps.state_shapes(model, rcfg, mesh_mod.unjoined(
            (2, 1, 1), ("pod", "data", "model")))
        mgr = CheckpointManager(str(rdir))
        saved, meta = mgr.restore(tpl, step=4)
        check(meta["format"]["hosts"] == 2, "re-mesh: step 4 not two-pod")
        total = saved.err.reshape(2, -1).sum(axis=0)
        check(bool(np.any(total)) and bool(np.all(np.isfinite(total))),
              "re-mesh: the saved residual is zero or not finite")
        sums = {}
        for ranks in (1, 3):           # the restore's own repack of err
            got = repack.adapt_arrays({"err": saved.err}, {
                "err": repack.ShapeDtype((ranks, *tpl.err.shape[1:]),
                                         np.dtype(np.float32))})["err"]
            sums[ranks] = bool(np.array_equal(
                got.reshape(ranks, -1).sum(axis=0), total))
        check(all(sums.values()), f"re-mesh: residual sum not conserved "
              f"{sums}")
        print(f"[ckpt-phase] re-mesh ({REMESH_LAYERS} layers): pod 1 lost "
              f"at step {margs.kill_pod.split('@')[1]}, RemeshRequired at "
              f"step {rec['step']} on both ranks (replans "
              f"{w0[0]['replans']}), restart on one pod from step 4 with "
              f"accum x2 to step {r['steps']}, losses {r['losses']}; "
              f"the exchange's send, receive and decode legs launched "
              + ", ".join(str(w0[0]["launches"][n]) for n in LEG_NAMES)
              + f" times a rank "
              f"on the two-pod mesh; the residual's sum conserved bitwise "
              f"into 1 and 3 ranks; {r_s:.1f} s [{smi}]", flush=True)
        out["remesh"] = {
            "layers": REMESH_LAYERS, "record": rec,
            "replans": w0[0]["replans"], "losses": r["losses"],
            "launches_two_pod": [x["launches"] for x in w0],
            "launches_one_pod": w1[0]["launches"],
            "expected_two_pod": want, "residual_sum_conserved": sums,
            "writes": w0[0]["writes"] + w1[0]["writes"],
            "restore": w1[0]["restore"], "process_seconds": r_s}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# --------------------------------------------------------------------------
# overlap and canonical path phase
# --------------------------------------------------------------------------

# phase 7's command three more times: the per-bucket pipeline after the
# backward, buckets flushed during the backward, and that with LAMB
OVERLAP_RUNS = (("buckets", ["--overlap", "buckets"]),
                ("backward", ["--overlap", "backward", "--no-scan-layers"]),
                ("backward_lamb", ["--overlap", "backward",
                                   "--no-scan-layers", "--optimizer",
                                   "lamb"]))
# the three overlap runs (phase 7's command with each overlap mode) at
# full width, the depth cut to 2 layers (full depth before phase 20 was
# added: their checks, launches and wire bytes a bucket, do not depend on
# depth); the exactness probe: two ranks at full width, depth cut to 2
# layers, fp32 (TF32 off), grad_clip 0, accum 2, 2 steps of 8 rows x
# 1024 (the second from the first's update; 3 before phase 20)
OVERLAP_LAYERS = 2
OVERLAP_STEPS = 2
# canonical at full width: phase 5's settings with --weighting canonical
# (accum 1, which canonical requires), 4 steps; then two ranks at depth
# 2, fp32, 6 rows of 1024 a batch from a 14-row corpus (the last batch
# partial: 6, 6, 2), under two plan sequences of 3 steps (4 of a 20-row
# corpus before phase 20 was added)
CANONICAL_ARGV = [a for a in TRAIN_ARGV] + ["--weighting", "canonical"]
for _flag, _value in (("--accum", "1"), ("--steps", "4")):
    CANONICAL_ARGV[CANONICAL_ARGV.index(_flag) + 1] = _value
CANONICAL_ROWS = 6
CANONICAL_PLANS = {"fixed": ((2.0, 1.0),) * 3,
                   "replanned": ((1.0, 1.0),) + ((3.0, 1.0),) * 2}


def _flat_params(params):
    import torch
    from repro_torch.models.transformer import tree_leaves
    return torch.cat([t.detach().reshape(-1).float()
                      for t in tree_leaves(params)])


def overlap_probes_rank(rank, world, init_method, seq_len, corpus):
    """One rank of phase 15's two probes, in one process group: the
    exactness probe on a (pod, data, model) mesh, then the canonical
    replan probe on (data, model); fp32 with TF32 off."""
    import torch
    from repro_torch.launch import mesh as mesh_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_mod.init((world, 1, 1), ("pod", "data", "model"), rank,
                         init_method, "cuda")
    try:
        exact = overlap_probe(mesh, seq_len)
        canon = canonical_probe(mesh_mod.init(
            (world, 1), ("data", "model"), rank, init_method, "cuda"),
            seq_len, corpus)
    finally:
        mesh_mod.destroy(mesh)
    return {"exactness": exact, "canonical": canon}


def overlap_probe(mesh, seq_len):
    """The exactness probe: OVERLAP_STEPS steps of a 2-layer full-width
    olmo-1b at fp32 under overlap none, buckets and backward, with
    ``bucketed_allreduce`` (fp32) and with hierarchical int8 and error
    feedback, from the same parameters and batches. Returns each mode's
    losses, parameter and error differences against ``none``, and the
    error state's norm."""
    import numpy as np
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import capacity as cap
    from repro_torch.core import dummy
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.model import build_model
    rank = mesh.rank
    out = {}
    cfg = dataclasses.replace(
        cfgbase.resolve("olmo-1b"), num_layers=OVERLAP_LAYERS,
        compute_dtype="float32", attention_impl="kernel",
        scan_layers=False)
    model = build_model(cfg, mesh.device)
    plan = cap.plan_capacities(8, (2.0, 1.0), headroom=1.25,
                               round_buffer_to=2)
    rng = np.random.default_rng(5)
    b = plan.buffer_rows
    batches = []
    for _ in range(OVERLAP_STEPS):
        packed = dummy.pack_global_batch(
            {k: rng.integers(0, cfg.vocab_size, (8, seq_len)).astype(
                np.int32) for k in ("inputs", "labels")}, plan)
        batches.append({k: torch.from_numpy(v[rank * b:(rank + 1) * b])
                        .to(mesh.device) for k, v in packed.items()})
    for name, het in (("bucketed_allreduce",
                       dict(grad_reduction="bucketed_allreduce")),
                      ("hierarchical_int8",
                       dict(grad_reduction="hierarchical",
                            compression="int8"))):
        base = None
        for ov in ("none", "buckets", "backward"):
            tcfg = cfgbase.TrainConfig(
                model=cfg, shape=cfgbase.ShapeConfig("t", seq_len, 8,
                                                     "train"),
                het=cfgbase.HetConfig(bucket_mb=EXCHANGE_BUCKET_MB,
                                      quantize_impl="pallas",
                                      overlap=ov, accum_steps=2, **het),
                optimizer=cfgbase.OptimizerConfig(
                    lr=3e-4, warmup_steps=1, schedule="constant",
                    grad_clip=0.0))
            state = tsteps.init_train_state(model, tcfg, mesh=mesh)
            step = tsteps.build_train_step(model, tcfg, mesh)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            losses = []
            for bt in batches:
                state, met = step(state, bt)
                losses.append(float(met["loss"]))
            secs = time.monotonic() - t0
            flat = _flat_params(state.params)
            err = state.err if isinstance(state.err, torch.Tensor) \
                else None
            rec = {"losses": losses, "seconds": secs,
                   "checksum": tsteps.params_checksum(state.params),
                   "err_norm": None if err is None
                   else float(err.norm())}
            if base is None:                # overlap "none"
                base = {"losses": losses, "flat": flat,
                        "params": state.params, "err": err}
            else:
                rec["params_bitwise"] = bool(torch.equal(flat,
                                                         base["flat"]))
                rec["losses_bitwise"] = losses == base["losses"]
                rec["loss_rel"] = max(abs(x - y) / abs(y) for x, y in
                                      zip(losses, base["losses"]))
                rec["leaf_rel"] = _worst_leaf_rel(state.params,
                                                  base["params"])
                if err is not None:
                    rec["err_bitwise"] = bool(torch.equal(err,
                                                          base["err"]))
            out[f"{name}/{ov}"] = rec
            del state, step, flat, err
    return out


def _worst_leaf_rel(got, want):
    """The largest difference of any parameter leaf, relative to that
    leaf's largest magnitude."""
    from repro_torch.models.transformer import tree_leaves
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp(min=1e-30))
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def canonical_probe(mesh, seq_len, corpus):
    """The canonical bit-identity probe: a 2-layer full-width olmo-1b at
    fp32 trained on the canonical batches of ``corpus`` under each plan
    sequence of CANONICAL_PLANS (the plan set before each step, as a
    replan would); returns each run's losses and parameter checksum."""
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import capacity as cap
    from repro_torch.data.dataset import ShardedDataset
    from repro_torch.data.sampler import HetSampler
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.model import build_model
    out = {}
    cfg = dataclasses.replace(
        cfgbase.resolve("olmo-1b"), num_layers=OVERLAP_LAYERS,
        compute_dtype="float32", attention_impl="kernel")
    model = build_model(cfg, mesh.device)
    ds = ShardedDataset(corpus)
    tcfg = cfgbase.TrainConfig(
        model=cfg, shape=cfgbase.ShapeConfig("t", seq_len,
                                             CANONICAL_ROWS, "train"),
        het=cfgbase.HetConfig(weighting="canonical"),
        optimizer=cfgbase.OptimizerConfig(lr=1e-3, warmup_steps=2))
    for name, caps in CANONICAL_PLANS.items():
        plans = [cap.plan_capacities(CANONICAL_ROWS, c) for c in caps]
        smp = HetSampler(ds, plans[0], seed=3, canonical_order=True)
        state = tsteps.init_train_state(model, tcfg, mesh=mesh)
        step = tsteps.build_train_step(model, tcfg, mesh)
        losses, rows = [], []
        t0 = time.monotonic()
        for plan, entry in zip(plans, smp.epoch_batches(0)):
            smp.set_plan(plan)
            raw = smp.pack(entry)
            batch = {k: torch.from_numpy(raw[k][:, :seq_len].copy()).to(
                mesh.device) for k in ("inputs", "labels", "weights")}
            rows.append(int((raw["weights"].sum(axis=1) > 0).sum()))
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
        out[name] = {"losses": losses, "real_rows": rows,
                     "rows_per_rank": [p.rows_per_rank.tolist()
                                       for p in plans],
                     "checksum": tsteps.params_checksum(state.params),
                     "seconds": time.monotonic() - t0}
        del state, step
    return out


def canonical_train(dev, fa, ce, smi):
    """The driver's one-rank canonical run at full width, counters
    zeroed just before and read just after: per row of every step, the
    attention forward twice a layer (remat) and its backward once, the
    CE forward and one dlogits chunk."""
    import gc
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.kernels.cross_entropy.cross_entropy import BWD_CHUNK
    from repro_torch.launch import train as ttrain
    gc.collect()
    torch.cuda.empty_cache()
    fns = _counters(fa, ce)
    args = ttrain.parser().parse_args(CANONICAL_ARGV)
    cfg = cfgbase.resolve(args.arch)
    for f in fns.values():
        f.launches = 0
    result = ttrain.main(CANONICAL_ARGV)
    launches = {n: f.launches for n, f in fns.items()}
    n = result["steps"]
    losses = result["losses"]
    check(n == args.steps and all(map(_finite, losses)),
          f"canonical: losses {losses}")
    rows = result["plan"]["global_rows"] * n
    L = cfg.num_layers
    expect = {"flash_attention_cuda": (2 if cfg.remat == "full" else 1)
              * L * rows,
              "flash_attention_bwd_cuda": L * rows,
              "cross_entropy_cuda": rows,
              "ce_dlogits_cuda": -(-args.seq_len // BWD_CHUNK) * rows,
              "flash_decode_paged_cuda": 0}
    check(launches == expect, f"canonical launches {launches} != {expect}")
    ms = statistics.median(result["step_s"][1:]) * 1e3
    tokens = args.global_batch * args.seq_len
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[canonical] {cfg.name}, one rank, weighting canonical: "
          f"{result['plan']['global_rows']} rows of {args.seq_len} a step, "
          f"each its own backward: {ms:.1f} ms/step (median of steps "
          f"2..{n}), {tokens / (ms / 1e3):.0f} real tokens/s, peak memory "
          f"{peak:.2f} GiB, losses {losses}, launches {launches} [{smi}]",
          flush=True)
    return {"losses": losses, "launches": launches,
            "expected_launches": expect, "rows_per_step":
            result["plan"]["global_rows"], "ms_per_step_median_2_to_n": ms,
            "step_s": result["step_s"], "tokens_per_s": tokens / (ms / 1e3),
            "peak_memory_gib": peak, "wall_s": result["wall_s"]}


def _olmo_cut_argv(argv, layers):
    """``argv`` with olmo-1b at ``layers`` layers, registered in this
    process as ``olmo-1b-cut`` (the driver's ranks take the resolved
    config from it, so no CLI depth flag is needed)."""
    from repro_torch.configs import base as cfgbase
    cfgbase.register("olmo-1b-cut", *(
        lambda get=get: dataclasses.replace(get("olmo-1b"),
                                            num_layers=layers)
        for get in (cfgbase.resolve, cfgbase.smoke_config)))
    argv = list(argv)
    argv[argv.index("--arch") + 1] = "olmo-1b-cut"
    return argv


def overlap_phase(dev, fa, ce, smi, multi):
    """Phase 15: the overlap modes at full width through the driver,
    their exactness on the card at depth 2, and canonical weighting."""
    import shutil
    import tempfile
    from repro_torch.configs import base as cfgbase
    from repro_torch.data.synthetic import build_synthetic_corpus
    from repro_torch.launch import mesh as mesh_mod
    out = {"runs": {}}
    argv = _olmo_cut_argv(MULTI_ARGV, OVERLAP_LAYERS)
    for name, flags in OVERLAP_RUNS:
        t0 = time.monotonic()
        rec = multi_rank_train(dev, argv + flags, smi,
                               per_bucket=True, tag=f"overlap-{name}")
        rec["process_seconds"] = time.monotonic() - t0
        out["runs"][name] = rec
    ms7 = multi["ms_per_step_median_2_to_n"]
    print("[overlap] ms/step, real tokens/s, peak GiB per rank (phase 7's "
          f"run first, for information): none {ms7:.1f}, "
          f"{multi['tokens_per_s']:.0f}, {multi['peak_memory_gib_by_rank']}; "
          + "; ".join(f"{k} {r['ms_per_step_median_2_to_n']:.1f}, "
                      f"{r['tokens_per_s']:.0f}, "
                      f"{r['peak_memory_gib_by_rank']}"
                      for k, r in out["runs"].items()) + f" [{smi}]",
          flush=True)

    out["canonical"] = canonical_train(dev, fa, ce, smi)
    root = tempfile.mkdtemp(prefix="hetseq_canonical_")
    try:
        corpus = build_synthetic_corpus(
            root + "/c", num_seqs=14, seq_len=1025,
            vocab=cfgbase.resolve("olmo-1b").vocab_size, rows_per_shard=8,
            seed=0)
        t0 = time.monotonic()
        probes = mesh_mod.spawn(overlap_probes_rank, 2, (1024, corpus),
                                timeout_s=900)[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["probes_seconds"] = time.monotonic() - t0
    probe, runs = probes["exactness"], probes["canonical"]
    out["exactness"] = probe
    for key, rec in probe.items():
        print(f"[overlap] exactness {key} ({OVERLAP_LAYERS} layers, fp32, "
              f"{OVERLAP_STEPS} steps, {rec['seconds']:.1f} s): losses "
              f"{rec['losses']}"
              + (f", params bitwise {rec['params_bitwise']}, losses "
                 f"bitwise {rec['losses_bitwise']}, loss rel "
                 f"{rec['loss_rel']:.2e}, worst leaf rel "
                 f"{rec['leaf_rel']:.2e}" if "params_bitwise" in rec
                 else "")
              + (f", error state norm {rec['err_norm']:.4e}"
                 + (f" bitwise {rec['err_bitwise']}"
                    if "err_bitwise" in rec else "")
                 if rec["err_norm"] is not None else ""), flush=True)
    # every mode bitwise the monolithic step, as the CPU test
    # (test_overlap_steps_bitwise_monolithic) asserts: the int8 case's
    # error state too, and it must be non-zero
    for ov in ("buckets", "backward"):
        fp = probe[f"bucketed_allreduce/{ov}"]
        check(fp["params_bitwise"] and fp["losses_bitwise"],
              f"overlap {ov}: fp32 bucketed_allreduce not bitwise the "
              f"monolithic step")
        q = probe[f"hierarchical_int8/{ov}"]
        check(q["params_bitwise"] and q["losses_bitwise"]
              and q["err_bitwise"] and q["err_norm"] > 0,
              f"overlap {ov}: int8 with error feedback not bitwise the "
              f"monolithic step: {q}")
    fixed, replanned = runs["fixed"], runs["replanned"]
    same = (fixed["losses"] == replanned["losses"]
            and fixed["checksum"] == replanned["checksum"])
    out["canonical_replans"] = {**runs, "bitwise": same}
    print(f"[canonical] two ranks, {OVERLAP_LAYERS} layers, fp32, "
          f"{CANONICAL_ROWS} rows of 1024 a batch: plans "
          f"{fixed['rows_per_rank']} vs {replanned['rows_per_rank']}: "
          f"losses {fixed['losses']} vs {replanned['losses']}, checksums "
          f"{fixed['checksum']} vs {replanned['checksum']}: bitwise equal "
          f"{same} [{smi}]", flush=True)
    check(same, "canonical: a replanned run differs from the fixed plan's")
    check(all(map(_finite, fixed["losses"])), "canonical: losses")
    return out


# --------------------------------------------------------------------------
# pipeline path phase
# --------------------------------------------------------------------------

# phase 5's settings with two pipeline stages, olmo-1b at full width cut
# to 4 layers (full depth before phase 20 was added: the checks, the
# stage plan, launches and pipe bytes, follow the cut): 3 steps (4
# before), accum 4 (the plan's 12 buffer rows divide by it: 4
# microbatches of 3 rows, so 1F1B has a steady state), the uniform cut on
# one rank
PIPE_STEPS, PIPE_ACCUM, PIPE_LAYERS = 3, 4, 4
PIPE_ARGV = [a for a in TRAIN_ARGV]
for _flag, _value in (("--steps", str(PIPE_STEPS)),
                      ("--accum", str(PIPE_ACCUM))):
    PIPE_ARGV[PIPE_ARGV.index(_flag) + 1] = _value
PIPE_ARGV += ["--pipeline-stages", "2", "--no-scan-layers"]
# the fp32 exactness probe: olmo-1b at full width cut to 4 layers, 2 rows
# of 1024 a step in 2 microbatches, 2 steps (3 before phase 20 was
# added), grad_clip 0; each
# pipelined run (one a reduction x optimizer x schedule, the 1f1b runs
# on the uniform cut [2, 2], the gpipe runs on capacities 3,1's [3, 1])
# against the pipeline_stages=1 run of its reduction and optimizer
PIPE_EXACT_LAYERS, PIPE_EXACT_STEPS, PIPE_EXACT_ROWS = 4, 2, 2
PIPE_EXACT_CUTS = {"1f1b": (), "gpipe": (3.0, 1.0)}
# --cards 4: two data-parallel ranks of capacities 3,1, whose two
# entries also size the stages: layers [12, 4]
PIPE_CARDS_ARGV = PIPE_ARGV + ["--devices", "2,1", "--capacities", "3,1"]
# the pipe-axis run takes PIPE_CKPT_EVERY steps and writes its
# checkpoint there; from it a pipe-axis --resume and a --resume without
# the axis each take the one-process run's last step (a pipe-axis run of
# all PIPE_STEPS would write a second 4.46 GB checkpoint at its end:
# ~17 s more of phase 16 on an H100)
PIPE_CKPT_EVERY = 2
# --cards 4, the re-mesh on stage ranks: phase 16's settings (olmo-1b at
# full width cut to PIPE_LAYERS layers, 1024 tokens a row) on two pods
# of capacities 2,1, whose entries cut the stages [3, 1], global batch
# 16 and accum 2 (pod 0's buffer of 14 rows cannot take pod 1's; at 8
# rows every unequal pair's buffer could, and no re-mesh would happen),
# pod 1 lost at step 3: RemeshRequired at step 5, one pod of two stage
# ranks on the uniform cut [2, 2] from the step-4 checkpoint, accum x2
PIPE_REMESH_ARGV = [a for a in PIPE_ARGV]
for _flag, _value in (("--steps", "6"), ("--accum", "2"),
                      ("--global-batch", "16")):
    PIPE_REMESH_ARGV[PIPE_REMESH_ARGV.index(_flag) + 1] = _value
PIPE_REMESH_ARGV += ["--devices", "2,1,1", "--capacities", "2,1",
                     "--ckpt-every", "2", "--kill-pod", "1@3"]


def stage_launches(cfg, layers, head, buffer_rows, accum, seq_len, steps):
    """The driver's counters of one rank that runs ``layers`` layers and
    (``head``) the cross entropy."""
    n = train_launches(dataclasses.replace(cfg, num_layers=layers),
                       buffer_rows, accum, seq_len, steps)
    if not head:
        n["cross_entropy_cuda"] = n["ce_dlogits_cuda"] = 0
    return n


def _pipe_run(argv, tag, smi, layers=None):
    """The driver's pipelined run with the checks both forms share:
    finite losses, the stage plan, every stage's ranks equal, each
    rank's launches of its own layers and head, the exchange idle,
    and (a pipe axis) each rank's pipe bytes a step the modeled count.
    ``layers``: olmo-1b's depth cut (``argv`` names ``olmo-1b-cut``,
    registered at that depth here and in the driver's process)."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    from repro_torch.models.model import build_model
    args = ttrain.parser().parse_args(argv)
    cfg, tcfg = ttrain.build_config(args)
    n_dp = ttrain.mesh_mod.topology_from_devices(args.devices).dp_size
    plan = ttrain.make_plan(tcfg, n_dp)
    splan = tsteps.stage_plan_for(build_model(cfg, "cpu"), tcfg)
    text, summary, wall = run_driver(argv, tag, layers=layers)
    backend = [ln.split("backend ")[1].split(",")[0]
               for ln in text.splitlines() if "backend " in ln][0]
    losses = summary["losses"]
    ran = args.steps - summary["start_step"]        # fewer after --resume
    check(summary["steps"] == args.steps and len(losses) == ran
          and all(map(_finite, losses)), f"{tag}: losses {losses}")
    check(summary["stage_plan"] == splan.layers_per_stage.tolist(),
          f"{tag}: stage plan {summary['stage_plan']}")
    ranks = summary["worlds"][-1]["ranks"]
    S = splan.num_stages if args.pipe_axis else 1
    sums = summary["end_checksums"]
    groups = ttrain.stage_groups(sums, S)
    check(all(len(set(g)) == 1 for g in groups),
          f"{tag}: a stage's ranks differ: {sums}")
    ranges = splan.stage_ranges()
    for r in ranks:
        if args.pipe_axis:
            s = r["stage"]
            expect = stage_launches(cfgbase.resolve(args.arch),
                                    ranges[s][1] - ranges[s][0], s == S - 1,
                                    plan.buffer_rows, args.accum,
                                    args.seq_len, ran)
            check(r["pipe_bytes"] == r["pipe_bytes_modeled"],
                  f"{tag}: rank {r['rank']} pipe bytes {r['pipe_bytes']} "
                  f"!= modeled {r['pipe_bytes_modeled']}")
        else:
            expect = train_launches(cfgbase.resolve(args.arch),
                                    plan.buffer_rows, args.accum,
                                    args.seq_len, ran)
        check(r["launches"] == expect, f"{tag}: rank {r['rank']} launches "
              f"{r['launches']} != {expect}")
    ms = [statistics.median(r["step_s"][1:] or r["step_s"]) * 1e3
          for r in ranks]
    tokens = args.global_batch * args.seq_len
    rec = {"argv": argv, "losses": losses, "stage_plan": summary[
               "stage_plan"], "schedule": summary["schedule"],
           "end_checksums": sums, "model_checksum": summary[
               "model_checksum"],
           "launches_by_rank": [r["launches"] for r in ranks],
           "stage_by_rank": [r.get("stage") for r in ranks],
           "pipe_bytes_by_rank": [r["pipe_bytes"] for r in ranks],
           "ms_per_step_median_2_to_n_by_rank": ms,
           "ms_per_step_median_2_to_n": ms[0],
           "tokens_per_s": tokens / (ms[0] / 1e3),
           "peak_memory_gib_by_rank": [(r["peak_memory_bytes"] or 0) / 2**30
                                       for r in ranks],
           "process_seconds": wall, "backend": backend,
           "start_step": summary["start_step"],
           "saves_by_rank": [r["saves"] for r in ranks],
           "writes": ranks[0]["writes"],
           "restore_by_rank": [r["restore"] for r in ranks]}
    print(f"[pipeline] {tag}: {cfg.name}, --devices {args.devices}"
          + (" --pipe-axis" if args.pipe_axis else "")
          + f", stages {rec['stage_plan']} ({rec['schedule']}), accum "
          f"{args.accum}: {ms[0]:.1f} ms/step (median of steps "
          f"{summary['start_step'] + min(2, ran)}..{args.steps}"
          f"; by rank {', '.join(f'{x:.1f}' for x in ms)}), "
          f"{rec['tokens_per_s']:.0f} real tokens/s, peak memory by rank "
          f"{', '.join(f'{p:.2f}' for p in rec['peak_memory_gib_by_rank'])}"
          f" GiB, model checksum {rec['model_checksum']}"
          + (f", pipe bytes a step by rank "
             f"{[b[0] for b in rec['pipe_bytes_by_rank']]} (modeled)"
             if args.pipe_axis else "")
          + f", launches by rank {rec['launches_by_rank']} [{smi}]",
          flush=True)
    return rec


def pipeline_exactness(dev):
    """(c): fp32, TF32 off, grad_clip 0, one rank on the card: each
    two-stage run's losses and parameters against its one-stage run's."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import tree_leaves
    cfg = dataclasses.replace(
        cfgbase.resolve("olmo-1b"), num_layers=PIPE_EXACT_LAYERS,
        compute_dtype="float32", scan_layers=False, attention_impl="kernel")
    model = build_model(cfg, dev)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(PIPE_EXACT_STEPS):
        b = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (PIPE_EXACT_ROWS, 1024)).astype(np.int32)).to(
            dev) for k in ("inputs", "labels")}
        b["weights"] = torch.from_numpy(
            (rng.random((PIPE_EXACT_ROWS, 1024)) > 0.1).astype(
                np.float32)).to(dev)
        batches.append(b)

    def run(stages, red, opt, sched="1f1b", caps=()):
        tcfg = cfgbase.TrainConfig(
            model=cfg, shape=cfgbase.ShapeConfig("t", 1024, PIPE_EXACT_ROWS,
                                                 "train"),
            het=cfgbase.HetConfig(
                grad_reduction=red, bucket_mb=25.0 if red != "allreduce"
                else 0.0, accum_steps=2, pipeline_stages=stages,
                pipeline_schedule=sched, capacities=caps),
            optimizer=cfgbase.OptimizerConfig(
                name=opt, lr=1e-3, warmup_steps=1, schedule="constant",
                grad_clip=0.0))
        mesh = mesh_mod.local(device=dev)
        state = tsteps.init_train_state(model, tcfg, mesh=mesh)
        step = tsteps.build_train_step(model, tcfg, mesh)
        losses = []
        for b in batches:
            state, met = step(state, b)
            losses.append(float(met["loss"]))
        return losses, tree_leaves(state.params)

    out = {}
    for red in ("allreduce", "bucketed_allreduce"):
        for opt in ("adamw", "lamb"):
            t0 = time.monotonic()
            base_losses, base = run(1, red, opt)
            for sched, caps in PIPE_EXACT_CUTS.items():
                losses, params = run(2, red, opt, sched, caps)
                same = all(torch.equal(a, b) for a, b in zip(base, params))
                out[f"{red}/{opt}/{sched}"] = {
                    "cut": tsteps.stage_plan_for(model, cfgbase.TrainConfig(
                        model=cfg, het=cfgbase.HetConfig(
                            pipeline_stages=2, accum_steps=2,
                            capacities=caps))).layers_per_stage.tolist(),
                    "losses": losses, "losses_one_stage": base_losses,
                    "losses_bitwise": losses == base_losses,
                    "params_bitwise": same,
                    "seconds": time.monotonic() - t0}
                del params
            del base
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _stage_part_bytes(cfg, tcfg, stage):
    """The bytes a stage rank holds of the state: its parameters (a
    tied table's copy on stage 0 too) and the moments of what it owns."""
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.transformer import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    splan = tsteps._stage_plan(cfg.num_layers, tcfg)
    held = tsteps.stage_params(tsteps._param_shapes(cfg), cfg, splan, stage)
    return nbytes(held) + 2 * nbytes(tsteps.owned_params(held, cfg, splan,
                                                         stage))


def pipe_ckpt_runs(argv, smi, one):
    """Phase 16's pipe-axis run to step PIPE_CKPT_EVERY, with its
    checkpoint there, then from it a pipe-axis --resume and a --resume
    without the axis (each a fresh process, under a temporary
    --ckpt-dir removed after): the pipe-axis run's steps and both
    resumed steps bitwise the one-process run's; each stage rank's
    restore holds no more than its stage's part on the card."""
    import shutil
    import tempfile
    from repro_torch.launch import train as ttrain
    args = ttrain.parser().parse_args(argv)
    cfg, tcfg = ttrain.build_config(args)
    ckpt_bytes = CKPT_ARRAYS * 4 * cfg.param_count()
    root = Path(tempfile.mkdtemp(prefix="hetseq_pipe_ckpt_"))
    try:
        free = shutil.disk_usage(root).free
        print(f"[pipeline] {root}: {free / 1e9:.1f} GB free, a checkpoint "
              f"of olmo-1b at {PIPE_LAYERS} layers {ckpt_bytes / 1e9:.2f} "
              f"GB (fp32 parameters, m, v)", flush=True)
        check(free >= ckpt_bytes, f"pipe-axis checkpoint: {free} bytes "
              f"free at {root}, it needs {ckpt_bytes}")
        ck = ["--ckpt-dir", str(root / "ck")]
        first = list(argv)
        first[first.index("--steps") + 1] = str(PIPE_CKPT_EVERY)
        staged = _pipe_run(first + ["--pipe-axis", "--ckpt-every",
                                    str(PIPE_CKPT_EVERY)] + ck,
                           "pipe-axis", smi, PIPE_LAYERS)
        check(staged["losses"] == one["losses"][:PIPE_CKPT_EVERY],
              f"pipe axis: losses {staged['losses']} != the one-process "
              f"run's {one['losses']}")
        writes = staged["writes"]
        check([w["step"] for w in writes] == [PIPE_CKPT_EVERY]
              and ckpt_bytes <= writes[0]["bytes"] <= 1.01 * ckpt_bytes,
              f"pipe axis: writes {writes}, {ckpt_bytes} bytes predicted")
        resumed = {}
        for tag, flags in (("pipe-axis-resume", ["--pipe-axis"]),
                           ("resume-without-axis", [])):
            r = resumed[tag] = _pipe_run(argv + flags + ["--resume"] + ck,
                                         tag, smi, PIPE_LAYERS)
            check(r["start_step"] == PIPE_CKPT_EVERY
                  and all(x["step"] == PIPE_CKPT_EVERY
                          for x in r["restore_by_rank"])
                  and r["losses"] == one["losses"][PIPE_CKPT_EVERY:]
                  and r["model_checksum"] == one["model_checksum"],
                  f"{tag}: from step {r['start_step']} losses "
                  f"{r['losses']}, checksum {r['model_checksum']}; the "
                  f"uninterrupted run's {one['losses']}, "
                  f"{one['model_checksum']}")
        parts = [_stage_part_bytes(cfg, dataclasses.replace(
            tcfg, het=dataclasses.replace(tcfg.het, capacities=())), s)
            for s in range(2)]
        for s, rest in enumerate(resumed["pipe-axis-resume"][
                "restore_by_rank"]):
            peak = rest["device_peak_bytes"]
            check(peak is not None and peak <= 1.05 * parts[s] + 2**28,
                  f"pipe-axis resume: stage {s} held {peak} bytes on the "
                  f"card in its restore, its part is {parts[s]}")
        saves = staged["saves_by_rank"]
        for w, *by_rank in zip(writes, *saves):
            print(f"[pipeline] pipe-axis checkpoint at step {w['step']}: "
                  f"{w['bytes']} bytes; the gather over the pipe group "
                  f"and host copy {by_rank[0]['snapshot_s']:.2f} s on rank "
                  f"0 (stage 1's sends {by_rank[1]['snapshot_s']:.2f} s), "
                  f"the wait for the previous write "
                  f"{by_rank[0]['wait_s']:.2f} s; the writer thread "
                  f"{w['seconds']:.2f} s (write and fsync "
                  f"{w['write_s']:.2f} s, sha256 {w['sha256_s']:.2f} s) "
                  f"[{smi}]", flush=True)
        for tag, r in resumed.items():
            for rank, rest in enumerate(r["restore_by_rank"]):
                print(f"[pipeline] {tag} rank {rank}: restore of step "
                      f"{rest['step']} {rest['seconds']:.2f} s (manifest "
                      f"check {rest['verify_s']:.2f} s, loading "
                      f"{rest['load_s']:.2f} s, repack "
                      f"{rest['adapt_s']:.2f} s, the rest onto the card); "
                      f"host peak {rest['host_peak_bytes'] / 2**30:.2f} "
                      f"GiB ({rest['host_peak_before_bytes'] / 2**30:.2f} "
                      f"before it), device peak "
                      f"{(rest['device_peak_bytes'] or 0) / 2**30:.2f} GiB"
                      + (f" (the stage's part {parts[rank] / 2**30:.2f} "
                         f"GiB)" if r is resumed["pipe-axis-resume"]
                         else "") + f" [{smi}]", flush=True)
        print(f"[pipeline] the pipe-axis run's steps 1-{PIPE_CKPT_EVERY} "
              f"and both resumes' steps {PIPE_CKPT_EVERY + 1}-{PIPE_STEPS} "
              f"bitwise the one-process run's (losses {one['losses']}, "
              f"model checksum {one['model_checksum']}) [{smi}]",
              flush=True)
        return staged, {"checkpoint_bytes": writes[0]["bytes"],
                        "predicted_checkpoint_bytes": ckpt_bytes,
                        "stage_part_bytes": parts, **resumed}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def pipeline_phase(dev, smi, train):
    """Phase 16: pipeline stages through the driver at full width, in one
    process and on two stage ranks sharing the card (with checkpoints,
    and resumed from one on the pipe axis and without it), and their
    exactness in fp32."""
    import torch
    t0 = time.monotonic()
    argv = _olmo_cut_argv(PIPE_ARGV, PIPE_LAYERS)
    one = _pipe_run(argv, "one-process", smi, PIPE_LAYERS)
    staged, ckpt = pipe_ckpt_runs(argv, smi, one)
    runs_s = time.monotonic() - t0
    print(f"[pipeline] against phase 5 (8 rows of 1024, accum 2, no "
          f"stages): {train['ms_per_step_median_2_to_n']:.1f} ms/step, "
          f"{train['tokens_per_s']:.0f} real tokens/s, peak "
          f"{train['peak_memory_gib']:.2f} GiB; the pipe-axis run's and "
          f"its resumes' losses and checksum bitwise the one-process "
          f"run's [{smi}]", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    exact = pipeline_exactness(dev)
    for key, rec in exact.items():
        print(f"[pipeline] exactness {key} (cut {rec['cut']}, "
              f"{PIPE_EXACT_LAYERS} layers, fp32, {PIPE_EXACT_STEPS} steps):"
              f" losses {rec['losses']}, losses bitwise "
              f"{rec['losses_bitwise']}, params bitwise "
              f"{rec['params_bitwise']}", flush=True)
        check(rec["losses_bitwise"] and rec["params_bitwise"],
              f"pipeline exactness {key}: not bitwise the one-stage step")
    return {"one_process": one, "pipe_axis": staged, "checkpoints": ckpt,
            "exactness": exact, "runs_seconds": runs_s,
            "exactness_seconds": time.monotonic() - t0,
            "launches": one["launches_by_rank"][0]}


def pipeline_cards(smi):
    """``--cards 4``: Part A on two data-parallel ranks (NCCL), then the
    same run with a pipe axis on four (a card a rank)."""
    one = _pipe_run(PIPE_CARDS_ARGV, "cards-one-process", smi)
    staged = _pipe_run(PIPE_CARDS_ARGV + ["--pipe-axis"], "cards-pipe-axis",
                       smi)
    check(staged["stage_plan"] == [12, 4],
          f"cards: the cut {staged['stage_plan']}, not [12, 4]")
    check(one["backend"] == staged["backend"] == "nccl",
          f"cards: backends {one['backend']}, {staged['backend']}")
    check(staged["model_checksum"] == one["model_checksum"],
          f"cards pipe axis: checksum {staged['model_checksum']} != "
          f"{one['model_checksum']}")
    check(staged["losses"] == one["losses"],
          f"cards pipe axis: losses {staged['losses']} != {one['losses']}")
    return {"one_process": one, "pipe_axis": staged,
            "remesh": pipe_remesh_cards(smi)}


def pipe_remesh_cards(smi):
    """``--cards 4``: the re-mesh on stage ranks (``PIPE_REMESH_ARGV``),
    four ranks then two, NCCL, against the same command without
    ``--pipe-axis`` (two ranks, then one): the cut [3, 1] then [2, 2]
    with the change logged, every rank's RemeshRequired at step 5, and
    losses and model checksum bitwise the run's without the axis. Each
    run under a temporary --ckpt-dir, removed after."""
    import shutil
    import tempfile
    from repro_torch.core import capacity as cap
    from repro_torch.launch import train as ttrain
    argv = _olmo_cut_argv(PIPE_REMESH_ARGV, PIPE_LAYERS)
    args = ttrain.parser().parse_args(argv)
    cfg = ttrain.build_config(args)[0]
    ckpt_bytes = CKPT_ARRAYS * 4 * cfg.param_count()

    def launches(world, cut, accum, staged):
        """Each rank's expected counters in one world: its stage's
        layers (all of them without the axis) and head, the world's
        plan, the steps it ran."""
        r0 = world["ranks"][0]
        plan = cap.plan_from_record(r0["plan"])
        return [stage_launches(cfg, cut[r["stage"]] if staged else
                               cfg.num_layers,
                               not staged or r["stage"] == len(cut) - 1,
                               plan.buffer_rows, accum, args.seq_len,
                               r0["steps"] - r0["start_step"])
                for r in world["ranks"]]

    out = {}
    for tag, flags in (("cards-remesh-pipe-axis", ["--pipe-axis"]),
                       ("cards-remesh", [])):
        root = Path(tempfile.mkdtemp(prefix="hetseq_pipe_remesh_"))
        try:
            free = shutil.disk_usage(root).free
            check(free >= 3 * ckpt_bytes, f"{tag}: {free} bytes free at "
                  f"{root}, three checkpoints need {3 * ckpt_bytes}")
            text, summary, wall = run_driver(
                argv + flags + ["--ckpt-dir", str(root)], tag,
                layers=PIPE_LAYERS)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        worlds = summary["worlds"]
        rec = worlds[0]["ranks"][0]["remesh"]
        staged = bool(flags)
        got = [[r["launches"] for r in w["ranks"]] for w in worlds]
        # the re-mesh scales accum x2 and takes the uniform cut
        want = [launches(w, cut, accum, staged) for w, cut, accum in zip(
            worlds, ([3, 1], [2, 2]), (args.accum, 2 * args.accum))]
        check(got == want, f"{tag}: launches by world and rank {got}, "
              f"expected {want}")
        out[tag] = {"losses": summary["losses"], "launches": got,
                    "model_checksum": summary["model_checksum"],
                    "stage_plan": summary["stage_plan"], "remesh": rec,
                    "worlds": [[w["devices"], len(w["ranks"])]
                               for w in worlds],
                    "restore": [r["restore"] for r in worlds[-1]["ranks"]],
                    "writes": [x for w in worlds
                               for x in w["ranks"][0]["writes"]],
                    "lines": [ln for ln in text.splitlines() if any(
                        k in ln for k in ("remesh:", "re-meshed to",
                                          "stage plan changed"))],
                    "backend_nccl": "backend nccl" in text,
                    "process_seconds": wall}
        check(all(x["remesh"] == rec for x in worlds[0]["ranks"])
              and rec is not None and (rec["step"], rec["dead"],
                                       rec["checkpoint"]) == (5, [1], 4),
              f"{tag}: the ranks' re-mesh records "
              f"{[x['remesh'] for x in worlds[0]['ranks']]}")
        check(len(summary["losses"]) == 6 and all(map(_finite,
                                                      summary["losses"])),
              f"{tag}: losses {summary['losses']}")
        check(out[tag]["backend_nccl"], f"{tag}: not over NCCL")
    pipe, flat = out["cards-remesh-pipe-axis"], out["cards-remesh"]
    check(pipe["stage_plan"] == [3, 1]
          and pipe["worlds"] == [["2,1,1", 4], ["1,1", 2]]
          and flat["worlds"] == [["2,1,1", 2], ["1,1", 1]],
          f"cards re-mesh: cut {pipe['stage_plan']}, worlds "
          f"{pipe['worlds']} / {flat['worlds']}")
    changed = [ln for ln in pipe["lines"] if "stage plan changed" in ln]
    check(len(changed) == 1 and "[3, 1]" in changed[0]
          and "[2, 2]" in changed[0],
          f"cards re-mesh: the cut change logged as {changed}")
    check(pipe["losses"] == flat["losses"]
          and pipe["model_checksum"] == flat["model_checksum"],
          f"cards re-mesh: losses {pipe['losses']} / {flat['losses']}, "
          f"checksums {pipe['model_checksum']} / {flat['model_checksum']}")
    print(f"[pipeline] cards re-mesh on stage ranks: cut [3, 1] on four "
          f"ranks, pod 1 lost at step 3, RemeshRequired at step 5, two "
          f"stage ranks on [2, 2] from step 4 ({changed[0]}); losses "
          f"{pipe['losses']} and model checksum {pipe['model_checksum']} "
          f"bitwise the run's without --pipe-axis; "
          f"{pipe['process_seconds']:.1f} s and "
          f"{flat['process_seconds']:.1f} s [{smi}]", flush=True)
    return out


def _finite(x):
    return x == x and abs(x) != float("inf")


# --------------------------------------------------------------------------
# phase 17: the last five archs (glm4-9b, phi4-mini-3.8b, arctic-480b,
# chameleon-34b, musicgen-large)
# --------------------------------------------------------------------------

# the D=128 decode cases: (arch, H, Hkv), B=8 over phase 2's tables and
# lengths; fp32 (TF32 off) is held to 1e-5, bf16 to phase 2's 2e-2
D128_HEADS = (("glm4-9b", 32, 2), ("phi4-mini-3.8b", 24, 8),
              ("arctic-480b", 56, 8))
D128_FP32_TOL = 1e-5
# the prefill kernel at D=128 and groups 16 (glm4) and 7 (arctic): B, S,
# H, Hkv
D128_PREFILL = ((2, 512, 32, 2), (2, 200, 56, 8))
# arctic-480b's depth cut: 13.6 B parameters (27.2 GB in bf16) a layer;
# 2 of 35 layers leave room for the draw's fp32 temporary of one expert
# stack (17.8 GB); the fp32 gate (fp32 parameters, ~56 GB) takes 1
ARCTIC_LAYERS = 2
ARCTIC_GATE_LAYERS = 1
ARCTIC_GATE_ARGV = ["--slots", "1", "--prefill-batch", "1",
                    "--requests", "4", "--pod-speeds", "1"]
# glm4's static_generate: batch, prompt, generated tokens; its fp32 gate
# (layers, prompt, tokens): kernel and reference paths give the same
# tokens, one sequence through the paged engine the static path's
ARCH_GEN = (4, 1024, 64)
ARCH_GATE = (3, 300, 8)
# the stub-frontend training runs: phase 5's settings (8 rows of 1024,
# accum 2, the plan's 2 dummy rows, bf16, remat full), 3 steps;
# chameleon-34b at full width cut to 2 of 48 layers (~31 GB of fp32
# parameters, gradients and AdamW moments), musicgen-large at full size
STUB_TRAIN = {"chameleon-34b": 2, "musicgen-large": None}
# 3 steps, a warm-up and two timed ones (4 before phase 20 was added)
STUB_ROWS, STUB_SEQ, STUB_ACCUM, STUB_STEPS = 8, 1024, 2, 3
# the fp32 probe (TF32 off) at 2 layers: 2 rows of 1024 and a dummy row,
# kernel path vs plain path, held to phase 5's fp32 limits
STUB_PROBE_LAYERS = 2


def _arch_argv(arch, extra=()):
    out = [a if a != "tinyllama-1.1b" else arch for a in SERVE_ARGV]
    for flag, val in zip(extra[::2], extra[1::2]):
        if flag in out:
            out[out.index(flag) + 1] = val
        else:
            out += [flag, val]
    return out


def d128_kernel_phase(fa, dev, smi):
    """Phase 17 (a): kernel 2 at D=128 at glm4's, phi4's and arctic's
    heads; the split length the library reports; kernel 1 at D=128 and
    groups 16 and 7."""
    import torch
    from repro_torch.kernels import _build
    gen = torch.Generator(device=dev).manual_seed(17)
    split = _build.load().paged_decode_split_len()
    check(split == fa.DECODE_SPLIT, f"D=128: the decode kernel splits by "
          f"{split} positions, DECODE_SPLIT says {fa.DECODE_SPLIT}")
    recs = []
    for arch, h, hkv in D128_HEADS:
        for dtype, tol in ((torch.float32, D128_FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            r = decode_case(fa, gen, dev, dtype, heads=(h, hkv, 128))
            r.update(kernel="paged_decode_d128", arch=arch, tol=tol)
            recs.append(r)
            print(f"[d128] {arch} decode (B=8, H={h}, Hkv={hkv}, D=128) "
                  f"{r['dtype']}: max abs err {r['max_abs_err']:.3e} (tol "
                  f"{tol:g})" + (
                      f", {r['ms']:.4f} ms, device time "
                      f"{_ms_or_not(r['device_ms'])}, plain "
                      f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} "
                      f"ms (device {_ms_or_not(r['library_device_ms'])}), "
                      f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}) "
                      f"[{smi}]" if "ms" in r else ""), flush=True)
            check(r["max_abs_err"] <= tol, f"decode D=128 {arch} "
                  f"{r['dtype']}: error {r['max_abs_err']} > {tol}")
    # batch invariance at D=128: one sequence alone over a shorter table
    q, kp, vp, tables, kv_lens = paged_inputs(gen, dev, torch.bfloat16,
                                              heads=(32, 2, 128))
    batched = fa.flash_decode_paged_cuda(q, kp, vp, tables, kv_lens)
    alone = fa.flash_decode_paged_cuda(
        q[5:6].contiguous(), kp, vp, tables[5:6, :20].contiguous(),
        kv_lens[5:6])
    check(torch.equal(alone[0], batched[5]), "decode D=128: a sequence "
          "alone differs from itself inside the batch")
    prefill = []
    for b, s, h, hkv in D128_PREFILL:
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            r = prefill_case(fa, b, s, dtype, gen, dev, heads=(h, hkv, 128),
                             timed=False)
            r["tol"] = tol
            prefill.append(r)
            print(f"[d128] prefill D=128 group {h // hkv} (B={b}, S={s}, "
                  f"H={h}) {r['dtype']}: max abs err {r['max_abs_err']:.3e} "
                  f"(tol {tol:g})", flush=True)
            check(r["max_abs_err"] <= tol, f"prefill D=128 group "
                  f"{h // hkv}: error {r['max_abs_err']}")
    return recs, {"split_len": split, "prefill": prefill,
                  "batch_invariant": True}


def _serve_counters(fa, md):
    return {"flash_attention_cuda": fa.flash_attention_cuda,
            "flash_decode_paged_cuda": fa.flash_decode_paged_cuda,
            "mla_decode_paged_cuda": md.mla_decode_paged_cuda}


def arch_serve(cfg, argv, fa, md, smi, *, gate_tol=None, then=None):
    """``serve_config`` on ``cfg`` with ``argv``'s settings, every step
    timed and the first prefill group and decode step held to the
    reference path: within ``gate_tol`` of the largest reference logit
    when given, else within phase 4's ``LOGIT_TOL`` for a dense model
    and printed only for a MoE one (its routing flips on near-ties in
    bf16). Kernel 1 launches once a layer a prefill group, kernel 2
    once a layer a decode step; every request finishes with finite
    logits. ``then(model, params)`` runs on the weights after."""
    import gc
    import torch
    from repro_torch.launch import serve as tserve
    args = tserve.parser().parse_args(argv)
    checks, check_s = {}, [0.0]
    name = cfg.name
    tol = gate_tol if gate_tol is not None else (
        None if cfg.moe.enabled else LOGIT_TOL)

    def compare(what, got, want):
        g, w = got.float(), want.float()
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        checks[what] = {"max_abs_err": err, "ref_max_abs": scale,
                        "argmax_agree": float(
                            (g.argmax(-1) == w.argmax(-1)).float().mean())}
        limit = f" (tol {tol * scale:.4e})" if tol is not None else \
            " (for the record)"
        print(f"[arch-serve] {name} {cfg.num_layers} layers "
              f"{cfg.compute_dtype} {what}: kernel vs reference logits max "
              f"abs err {err:.4e}{limit}, argmax agree "
              f"{checks[what]['argmax_agree']:.3f}", flush=True)
        if tol is not None:
            checks[what]["tol"] = tol * scale
            check(err <= tol * scale, f"{name} {what}: logits differ by "
                  f"{err}")

    step_s = {"prefill": [], "decode": [], "prefill_bucket": [],
              "profiler_s": 0.0}
    profiles = {}
    build = step_timed_build(reference_checked_build(
        tserve.build_engine, compare, check_s, all_finite=True), step_s,
        profiles)
    held = {}

    def capture(model, params, *a, **k):
        held.update(model=model, params=params)
        return build(model, params, *a, **k)

    result, launches, peak, secs = _serve_mla(cfg, args, capture,
                                              _serve_counters(fa, md))
    check(len(checks) == 2, f"{name}: reference checks ran: "
          f"{sorted(checks)}")
    st = result.stats
    reqs = tserve.synthetic_requests(
        args.requests, cfg.vocab_size, args.rate,
        (args.min_prompt, args.max_prompt), (args.min_gen, args.max_gen),
        args.seed)
    for r in reqs:
        toks = result.tokens[r.rid]
        check(len(toks) == r.max_new_tokens and all(
            0 <= t < cfg.vocab_size for t in toks),
              f"{name} request {r.rid}: {len(toks)} of {r.max_new_tokens} "
              f"tokens, or one out of vocab")
    L = cfg.num_layers
    expect = {"flash_attention_cuda": L * st["prefill_groups"],
              "flash_decode_paged_cuda": L * st["decode_steps"],
              "mla_decode_paged_cuda": 0}
    check(launches == expect, f"{name} launches {launches} != {expect}")
    check(st["kernel_launches"] == launches,
          f"{name}: engine stats {st['kernel_launches']} != {launches}")
    wall = st["wall_seconds"] - check_s[0] - step_s["profiler_s"]
    out = {"arch": name, "layers": L, "dtype": cfg.compute_dtype,
           "stats": st, "launches": launches, "checks": checks,
           "check_seconds": check_s[0], "seconds": secs,
           "tokens_per_s_wall": st["total_tokens"] / wall,
           "decode_steps": st["decode_steps"],
           "ms_per_decode_step_median": statistics.median(
               step_s["decode"][1:]) * 1e3,
           "prefill_group_ms": [(b, t * 1e3) for b, t in zip(
               step_s["prefill_bucket"], step_s["prefill"])],
           "profiles": profiles, "peak_memory_gib": peak,
           "weights_gib": tserve.weight_bytes(cfg) / 2**30}
    print(f"[arch-serve] {name}, {L} layers, {cfg.compute_dtype}, "
          f"{args.slots} slots: {st['requests']} requests, "
          f"{st['total_tokens']} tokens in {wall:.3f} s of wall (reference "
          f"checks and the profiler excluded): "
          f"{out['tokens_per_s_wall']:.1f} tok/s, {st['decode_steps']} "
          f"decode steps (median {out['ms_per_decode_step_median']:.2f} "
          f"ms), {st['prefill_groups']} prefill groups, peak memory "
          f"{peak:.2f} GiB (weights {out['weights_gib']:.2f} GiB), "
          f"launches {launches} [{smi}]", flush=True)
    for kind, prof in profiles.items():
        print(f"[arch-serve] {name} torch.profiler over {prof['steps']} "
              f"{kind} step(s): kernels {prof['device_busy_us'] / 1e3:.3f} "
              f"ms of device time in {prof['window_us'] / 1e3:.3f} ms of "
              f"wall; by kernel: " + "; ".join(
                  f"{k['name'][:40]} x{k['count']} {k['us'] / 1e3:.3f} ms"
                  for k in prof["kernels"][:6]), flush=True)
    if then is not None:
        out["then"] = then(held["model"], held["params"])
    held.clear()
    del result
    gc.collect()
    torch.cuda.empty_cache()
    return out


def arch_generate(model, params, counters, smi):
    """glm4-9b's static path on the serve's weights: 4 sequences, a
    1024-token prompt, 64 greedy tokens; kernel 1 once a layer (the
    contiguous decode attends densely, as in the JAX package), every
    other kernel never; finite logits; prefill ms, decode-step ms."""
    import numpy as np
    cfg = model.cfg
    batch, plen, ngen = ARCH_GEN
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, plen)).astype(np.int32)
    record = {"prefill": [], "decode": [], "finite": True, "profiles": {},
              "profiler_s": 0.0}
    toks, launches, secs, peak = _counted_generate(model, params, prompts,
                                                   ngen, counters, record)
    expect = {n: 0 for n in counters}
    expect["flash_attention_cuda"] = cfg.num_layers
    check(launches == expect, f"{cfg.name} generate launches {launches} "
          f"!= {expect}")
    check(toks.shape == (batch, ngen) and record["finite"],
          f"{cfg.name} generate: tokens {toks.shape}, finite "
          f"{record['finite']}")
    out = {"batch": batch, "prompt": plen, "generated": ngen,
           "launches": launches, "prefill_ms": record["prefill"][0] * 1e3,
           "decode_step_ms_median": statistics.median(
               record["decode"]) * 1e3,
           "tokens_per_s_wall": batch * ngen / secs,
           "peak_memory_gib": peak}
    print(f"[arch-generate] {cfg.name}, {cfg.num_layers} layers, bf16, "
          f"static_generate: batch {batch}, prompt {plen}, {ngen} tokens: "
          f"prefill {out['prefill_ms']:.2f} ms, decode step median "
          f"{out['decode_step_ms_median']:.2f} ms, "
          f"{out['tokens_per_s_wall']:.1f} tok/s of wall, peak "
          f"{peak:.2f} GiB, launches {launches} [{smi}]", flush=True)
    return out


def arch_gate(arch, fa, md, dev):
    """The fp32 gate (TF32 off) of a dense D=128 arch at ``ARCH_GATE``'s
    depth: ``static_generate`` through the kernel path and the reference
    path gives the same greedy tokens; one sequence through the paged
    engine (kernels 1 and 2) gives the static path's tokens."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.base import resolve
    from repro_torch.launch import serve as tserve
    from repro_torch.models import transformer as tr
    from repro_torch.models.kvcache import PagedLayout
    from repro_torch.models.model import build_model
    from repro_torch.serve import Request
    layers, plen, ngen = ARCH_GATE
    cfg = dataclasses.replace(resolve(arch), num_layers=layers,
                              compute_dtype="float32",
                              attention_impl="kernel")
    kern = build_model(cfg, dev)
    params = kern.init_params(1)
    ref = build_model(dataclasses.replace(cfg, attention_impl="reference"),
                      dev)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, plen)).astype(np.int32)
    counters = _serve_counters(fa, md)
    for f in counters.values():
        f.launches = 0
    toks = {m: tserve.static_generate(model, params, prompts, ngen)
            for m, model in (("kernel", kern), ("reference", ref))}
    static_launches = {n: f.launches for n, f in counters.items()}
    mbs = -(-(plen + ngen) // 16)
    eng = tserve.build_engine(
        kern, params, PagedLayout(block_size=16, num_blocks=mbs,
                                  max_blocks_per_seq=mbs),
        slots=1, prefill_batch=1, pod_speeds=[1.0])
    paged = eng.run([Request(rid=0, prompt=tuple(int(t) for t in prompts[0]),
                             max_new_tokens=ngen, arrival=0.0)]).tokens[0]
    paged_launches = {n: f.launches - static_launches[n]
                      for n, f in counters.items()}
    same = bool(np.array_equal(toks["kernel"], toks["reference"]))
    same_paged = [int(t) for t in toks["kernel"][0]] == list(paged)
    print(f"[arch-gate] {arch}, {layers} layers, fp32: kernel and "
          f"reference static_generate tokens identical {same}, the paged "
          f"engine's on one sequence identical {same_paged} (paged launches "
          f"{paged_launches})", flush=True)
    check(same, f"{arch} gate: kernel and reference tokens differ")
    check(same_paged, f"{arch} gate: paged engine and static path differ")
    check(paged_launches["flash_decode_paged_cuda"] == layers * (ngen - 1)
          and static_launches["flash_attention_cuda"] == layers,
          f"{arch} gate launches: static {static_launches}, paged "
          f"{paged_launches}")
    del kern, ref, params, eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": layers, "prompt": plen, "generated": ngen,
            "tokens_identical": same, "paged_engine_identical": same_paged,
            "static_launches": static_launches,
            "paged_launches": paged_launches}


def stub_batches(cfg, dev, seed=0):
    """``STUB_STEPS`` batches of ``STUB_ROWS`` real rows of ``STUB_SEQ``
    embeddings (bf16), labels and weights from a seed, plus the plan's
    weight-0 dummy rows: the capacity plan of phase 5's run."""
    import torch
    from repro_torch.core import capacity as cap
    plan = cap.plan_capacities(STUB_ROWS, (1.0,), headroom=1.25,
                               round_buffer_to=STUB_ACCUM)
    rows = plan.buffer_rows
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(STUB_STEPS):
        w = torch.ones((rows, STUB_SEQ), device=dev)
        w[STUB_ROWS:] = 0.0
        out.append({
            "inputs": torch.randn((rows, STUB_SEQ, cfg.d_model),
                                  generator=gen, device=dev).to(
                                      torch.bfloat16),
            "labels": torch.randint(0, cfg.vocab_size, (rows, STUB_SEQ),
                                    generator=gen, device=dev,
                                    dtype=torch.int32),
            "weights": w})
    return out, rows


def stub_train(arch, fa, ce, dev, smi):
    """Phase 17 (e), (f): ``build_train_step`` on embedding batches at
    phase 5's settings; finite losses; kernels 1, 1b, 3 and 3b launch as
    phase 5 counts them; ms/step, real tokens/s, the model-FLOPs share
    and peak memory; then the fp32 probe at 2 layers."""
    import gc
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.kernels.parity import rel_l2
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.optim import adam
    full = cfgbase.resolve(arch)
    layers = STUB_TRAIN[arch] or full.num_layers
    cfg = dataclasses.replace(full, num_layers=layers,
                              attention_impl="kernel")
    model = build_model(cfg, dev)
    tcfg = cfgbase.TrainConfig(
        model=cfg, shape=cfgbase.ShapeConfig("stub", STUB_SEQ, STUB_ROWS,
                                             "train"),
        het=cfgbase.HetConfig(accum_steps=STUB_ACCUM),
        optimizer=cfgbase.OptimizerConfig(lr=3e-4, warmup_steps=2,
                                          schedule="constant",
                                          total_steps=STUB_STEPS))
    batches, rows = stub_batches(cfg, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = tsteps.init_train_state(model, tcfg)
    step = tsteps.build_train_step(model, tcfg)
    fns = _counters(fa, ce)
    for f in fns.values():
        f.launches = 0
    losses, step_s = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, met = step(state, b)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        losses.append(float(met["loss"]))
    launches = {n: f.launches for n, f in fns.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    expect = {k: v for k, v in train_launches(
        cfg, rows, STUB_ACCUM, STUB_SEQ, STUB_STEPS).items()
        if k in launches}
    expect["flash_decode_paged_cuda"] = 0
    check(all(_finite(x) for x in losses), f"{arch}: losses {losses}")
    check(launches == expect, f"{arch} train launches {launches} != "
          f"{expect}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    ms = statistics.median(step_s[1:]) * 1e3
    tokens = STUB_ROWS * STUB_SEQ
    processed = rows * STUB_SEQ
    attn = 3 * 2.0 * rows * layers * cfg.num_heads * STUB_SEQ ** 2 * \
        cfg.head_dim
    flops = 6.0 * cfg.param_count() * processed + attn
    out = {"arch": arch, "layers": layers, "rows": rows, "losses": losses,
           "launches": launches, "expected_launches": expect,
           "step_ms": [t * 1e3 for t in step_s],
           "ms_per_step_median_2_to_n": ms,
           "tokens_per_s": tokens / (ms / 1e3),
           "model_flops_per_step": flops,
           "mfu_vs_989_tflops": flops / (ms / 1e3) / H100_BF16_FLOPS,
           "peak_memory_gib": peak, "params": cfg.param_count()}
    print(f"[stub-train] {arch}, {layers} of {full.num_layers} layers at "
          f"full width, bf16, remat full, {rows} rows of {STUB_SEQ} "
          f"embeddings ({STUB_ROWS} real), accum {STUB_ACCUM}: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; {ms:.1f} ms/step (median of steps 2..{STUB_STEPS}), "
          f"{out['tokens_per_s']:.0f} real tokens/s, model FLOPs "
          f"{flops:.3e}/step = {100 * out['mfu_vs_989_tflops']:.2f}% of 989 "
          f"TFLOP/s, peak memory {peak:.2f} GiB, launches {launches} "
          f"[{smi}]", flush=True)

    # the fp32 probe: kernel path vs plain path, same params and batch
    pcfg = dataclasses.replace(cfg, num_layers=STUB_PROBE_LAYERS,
                               compute_dtype="float32")
    kern = build_model(pcfg, dev)
    plain = build_model(dataclasses.replace(pcfg,
                                            attention_impl="reference"), dev)
    params = kern.init_params(1)
    b0 = batches[0]
    probe = {k: torch.cat([v[:2], v[rows - 1:]]) for k, v in b0.items()}
    ptcfg = dataclasses.replace(tcfg, model=pcfg,
                                het=cfgbase.HetConfig(accum_steps=1))
    k_loss, _, k_grads = tsteps.loss_and_grads(kern, ptcfg, params, probe)
    loss, _, grads = tsteps.loss_and_grads(plain, ptcfg, params, probe,
                                           ce_impl="reference")
    leaves = [rel_l2(a, b) for a, b in zip(tree_leaves(k_grads),
                                           tree_leaves(grads))]
    gk, gr = adam.global_norm(k_grads), adam.global_norm(grads)
    tol = TRAIN_RTOL["float32"]
    rec = {"layers": STUB_PROBE_LAYERS, "rows": 3,
           "loss_rel": abs(float(k_loss) - float(loss)) / abs(float(loss)),
           "grad_norm_rel": abs(float(gk) - float(gr)) / float(gr),
           "worst_leaf_rel_l2": max(leaves), "tol": tol}
    print(f"[stub-train] {arch} fp32 probe, {STUB_PROBE_LAYERS} layers: "
          f"loss rel {rec['loss_rel']:.3e} (tol {tol['loss']:g}), grad norm "
          f"rel {rec['grad_norm_rel']:.3e} (tol {tol['grad_norm']:g}), "
          f"worst leaf rel L2 {rec['worst_leaf_rel_l2']:.3e} (tol "
          f"{tol['leaf']:g})", flush=True)
    check(rec["loss_rel"] <= tol["loss"] and rec["grad_norm_rel"] <=
          tol["grad_norm"] and rec["worst_leaf_rel_l2"] <= tol["leaf"],
          f"{arch} fp32 probe: {rec}")
    out["probe"] = rec
    del kern, plain, params, k_grads, grads, batches, b0, probe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def archs_phase(fa, ce, md, dev, smi):
    """Phase 17: the D=128 kernel cases, then glm4-9b and phi4-mini-3.8b
    at full size and arctic-480b at full width on the paged engine
    (glm4 also through ``static_generate``, each dense arch's fp32 gate,
    arctic's at 1 layer one sequence at a time), then chameleon-34b and
    musicgen-large through ``build_train_step``. Each path's counters
    are zeroed just before and read just after; the D=128 decode's
    launches are the serve runs' kernel-2 counts."""
    import dataclasses as dc
    import torch
    from repro_torch.configs.base import resolve
    t0 = time.monotonic()
    recs, kernel = d128_kernel_phase(fa, dev, smi)
    out = {"kernel": kernel, "seconds": {"kernels": time.monotonic() - t0}}
    serve = {}
    for arch in ("glm4-9b", "phi4-mini-3.8b"):
        t0 = time.monotonic()
        cfg = dc.replace(resolve(arch), attention_impl="kernel")
        then = ((lambda m, p: arch_generate(m, p, _serve_counters(fa, md),
                                            smi))
                if arch == "glm4-9b" else None)
        serve[arch] = arch_serve(cfg, _arch_argv(arch), fa, md, smi,
                                 then=then)
        serve[arch]["gate"] = arch_gate(arch, fa, md, dev)
        out["seconds"][arch] = time.monotonic() - t0
    t0 = time.monotonic()
    arctic = dc.replace(resolve("arctic-480b"), num_layers=ARCTIC_LAYERS,
                        attention_impl="kernel")
    serve["arctic-480b"] = arch_serve(arctic, _arch_argv("arctic-480b"),
                                      fa, md, smi)
    gate = dc.replace(arctic, num_layers=ARCTIC_GATE_LAYERS,
                      param_dtype="float32", compute_dtype="float32")
    serve["arctic-480b"]["gate"] = arch_serve(
        gate, _arch_argv("arctic-480b", ARCTIC_GATE_ARGV), fa, md, smi,
        gate_tol=MLA_GATE_TOL)
    out["seconds"]["arctic-480b"] = time.monotonic() - t0
    out["serve"] = serve
    train = {}
    for arch in STUB_TRAIN:
        t0 = time.monotonic()
        train[arch] = stub_train(arch, fa, ce, dev, smi)
        out["seconds"][arch] = time.monotonic() - t0
    out["train"] = train
    out["launches"] = {
        "serve": {n: sum(r["launches"][n] for r in serve.values())
                  for n in ("flash_attention_cuda",
                            "flash_decode_paged_cuda")},
        "train": {n: sum(r["launches"][n] for r in train.values())
                  for n in _counters(fa, ce)}}
    print("[archs] seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["seconds"].items()), flush=True)
    return recs, out


# --------------------------------------------------------------------------
# phase 18: MoE and MLA training (deepseek-v2 at full width, 1 of 60
# layers: one layer's parameters, gradients, accumulation carry and bf16
# moments come to ~50 GB; two layers do not fit one 80 GB card)
# --------------------------------------------------------------------------

DEEPSEEK_TRAIN_LAYERS = 1
DEEPSEEK_PROBE_ROWS = 3      # the fp32 probe: 2 real rows and 1 dummy


def deepseek_batches(cfg, dev, seed=0):
    """``STUB_STEPS`` packed batches of the synthetic corpus (zipf
    bigrams, ``data/synthetic.py``): ``STUB_ROWS`` real rows of
    ``STUB_SEQ`` tokens and the plan's weight-0 dummy rows (phase 5's
    plan)."""
    import torch
    from repro_torch.core import capacity as cap
    from repro_torch.core import dummy
    from repro_torch.data.synthetic import make_lm_records
    plan = cap.plan_capacities(STUB_ROWS, (1.0,), headroom=1.25,
                               round_buffer_to=STUB_ACCUM)
    out = []
    for i in range(STUB_STEPS):
        rec = make_lm_records(STUB_ROWS, STUB_SEQ, cfg.vocab_size,
                              seed=seed + i)
        packed = dummy.pack_global_batch(rec, plan)
        out.append({k: torch.from_numpy(v).to(dev)
                    for k, v in packed.items()})
    return out, plan.buffer_rows


def active_params(cfg) -> int:
    """Parameters a token runs through: all but the unrouted experts'
    (JAX's ``count_params_analytic(active_only=True)``)."""
    mo = cfg.moe
    per_expert = 3 * cfg.d_model * mo.expert_d_ff
    return cfg.param_count() - cfg.num_layers * (
        mo.num_experts - mo.top_k) * per_expert


def _rel_l2_by_rows(got, want) -> float:
    """``parity.rel_l2`` summed over blocks of leading-dim rows (its fp64
    copies of a whole 1.26 B-element expert stack would not fit beside
    the probe's two gradient trees)."""
    import torch
    from repro_torch.optim.adam import row_blocks
    num = den = 0.0
    for r in row_blocks(want):
        g, w = got[r].double(), want[r].double()
        num += torch.sum(torch.square(g - w)).item()
        den += torch.sum(torch.square(w)).item()
    return (num / den) ** 0.5 if den > 0 else num ** 0.5


def deepseek_train_phase(fa, ce, dev, smi):
    """Phase 18: deepseek-v2 at full width, ``DEEPSEEK_TRAIN_LAYERS`` of
    60 layers, through ``build_train_step`` (see the module docstring)."""
    import gc
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.optim import adam
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.monotonic()
    full = cfgbase.resolve("deepseek-v2-236b")
    cfg = dataclasses.replace(full, num_layers=DEEPSEEK_TRAIN_LAYERS,
                              attention_impl="kernel")
    ocfg = cfgbase.optimizer_for(cfg, lr=3e-4, warmup_steps=2,
                                 schedule="constant",
                                 total_steps=STUB_STEPS)
    check(ocfg.m_dtype == ocfg.v_dtype == "bfloat16",
          f"optimizer_for gave {ocfg.m_dtype}/{ocfg.v_dtype} moments")
    model = build_model(cfg, dev)
    tcfg = cfgbase.TrainConfig(
        model=cfg, shape=cfgbase.ShapeConfig("deepseek", STUB_SEQ,
                                             STUB_ROWS, "train"),
        het=cfgbase.HetConfig(accum_steps=STUB_ACCUM), optimizer=ocfg)
    batches, rows = deepseek_batches(cfg, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = tsteps.init_train_state(model, tcfg)
    step = tsteps.build_train_step(model, tcfg)
    # the aux term: loss_fn's metrics on the first microbatch
    with torch.no_grad():
        half = {k: v[:rows // STUB_ACCUM] for k, v in batches[0].items()}
        _, _, met0 = model.loss_fn(state.params, half)
    aux = float(met0["aux"])
    fns = _counters(fa, ce)
    for f in fns.values():
        f.launches = 0
    losses, step_s = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, met = step(state, b)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        losses.append(float(met["loss"]))
    launches = {n: f.launches for n, f in fns.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    expect = {k: v for k, v in train_launches(
        cfg, rows, STUB_ACCUM, STUB_SEQ, STUB_STEPS).items()
        if k in launches}
    expect["flash_decode_paged_cuda"] = 0
    check(all(_finite(x) for x in losses), f"deepseek losses {losses}")
    check(_finite(aux) and aux > 0, f"deepseek aux term {aux}")
    check(launches == expect, f"deepseek train launches {launches} != "
          f"{expect}")
    # one more step under torch.profiler: device time by kernel
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batches[-1])
        torch.cuda.synchronize()
    step_profile = _profile_rec(prof, (time.monotonic() - t0) * 1e6)
    del state, step, prof
    gc.collect()
    torch.cuda.empty_cache()
    ms = statistics.median(step_s[1:]) * 1e3
    tokens = STUB_ROWS * STUB_SEQ
    processed = rows * STUB_SEQ
    L = cfg.num_layers
    attn = 3 * 2.0 * rows * L * cfg.num_heads * STUB_SEQ ** 2 * \
        (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim)
    n_active = active_params(cfg)
    flops = 6.0 * n_active * processed + attn
    busy, win = step_profile["device_busy_us"], step_profile["window_us"]
    out = {"layers": L, "rows": rows, "losses": losses, "aux": aux,
           "moments": [ocfg.m_dtype, ocfg.v_dtype], "launches": launches,
           "expected_launches": expect,
           "step_ms": [t * 1e3 for t in step_s],
           "ms_per_step_median_2_to_n": ms,
           "tokens_per_s": tokens / (ms / 1e3),
           "params": cfg.param_count(), "active_params": n_active,
           "model_flops_per_step": flops,
           "mfu_vs_989_tflops": flops / (ms / 1e3) / H100_BF16_FLOPS,
           "peak_memory_gib": peak, "step_profile": step_profile}
    print(f"[deepseek-train] deepseek-v2-236b, {L} of {full.num_layers} "
          f"layers at full width ({cfg.param_count()} parameters, "
          f"{n_active} active), bf16, remat {cfg.remat}, {ocfg.m_dtype} "
          f"moments, {rows} rows of {STUB_SEQ} tokens ({STUB_ROWS} real), "
          f"accum {STUB_ACCUM}: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; aux {aux:.6f}; {ms:.1f} ms/step (median of steps "
          f"2..{STUB_STEPS}), {out['tokens_per_s']:.0f} real tokens/s, "
          f"model FLOPs {flops:.3e}/step = "
          f"{100 * out['mfu_vs_989_tflops']:.2f}% of 989 TFLOP/s, peak "
          f"memory {peak:.2f} GiB, launches {launches} [{smi}]",
          flush=True)
    print(f"[deepseek-train] torch.profiler over 1 step: kernels "
          f"{busy / 1e3:.3f} ms of device time in {win / 1e3:.3f} ms of "
          f"wall; by kernel: "
          + "; ".join(f"{k['name'][:60]} x{k['count']} {k['us'] / 1e3:.3f} "
                      f"ms" for k in step_profile["kernels"][:12]),
          flush=True)

    # the fp32 probe: kernel path vs plain path, same params and rows;
    # fp32 parameters, so the gradients are not rounded to bf16 (~60 GB:
    # the parameters and both gradient trees)
    pcfg = dataclasses.replace(cfg, compute_dtype="float32",
                               param_dtype="float32")
    torch.cuda.reset_peak_memory_stats(dev)
    kern = build_model(pcfg, dev)
    plain = build_model(dataclasses.replace(pcfg,
                                            attention_impl="reference"), dev)
    params = kern.init_params(1)
    b0 = batches[0]
    probe = {k: torch.cat([v[:DEEPSEEK_PROBE_ROWS - 1], v[rows - 1:]])
             for k, v in b0.items()}
    ptcfg = dataclasses.replace(tcfg, model=pcfg,
                                het=cfgbase.HetConfig(accum_steps=1))
    k_loss, _, k_grads = tsteps.loss_and_grads(kern, ptcfg, params, probe)
    loss, _, grads = tsteps.loss_and_grads(plain, ptcfg, params, probe,
                                           ce_impl="reference")
    leaves = [_rel_l2_by_rows(a, b) for a, b in zip(tree_leaves(k_grads),
                                                    tree_leaves(grads))]
    gk, gr = adam.global_norm(k_grads), adam.global_norm(grads)
    tol = TRAIN_RTOL["float32"]
    rec = {"layers": L, "rows": DEEPSEEK_PROBE_ROWS,
           "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "loss_rel": abs(float(k_loss) - float(loss)) / abs(float(loss)),
           "grad_norm_rel": abs(float(gk) - float(gr)) / float(gr),
           "worst_leaf_rel_l2": max(leaves), "tol": tol}
    print(f"[deepseek-train] fp32 probe, {L} layer, fp32 parameters, "
          f"{DEEPSEEK_PROBE_ROWS} rows (peak {rec['peak_memory_gib']:.2f} "
          f"GiB): loss rel {rec['loss_rel']:.3e} (tol "
          f"{tol['loss']:g}), grad norm rel {rec['grad_norm_rel']:.3e} "
          f"(tol {tol['grad_norm']:g}), worst leaf rel L2 "
          f"{rec['worst_leaf_rel_l2']:.3e} (tol {tol['leaf']:g})",
          flush=True)
    check(rec["loss_rel"] <= tol["loss"] and rec["grad_norm_rel"] <=
          tol["grad_norm"] and rec["worst_leaf_rel_l2"] <= tol["leaf"],
          f"deepseek fp32 probe: {rec}")
    out["probe"] = rec
    del kern, plain, params, k_grads, grads, batches, b0, probe
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t_phase
    return out


# the SSD backward cases (B, S, H, G, chunk, with D): zamba2's training
# microbatch (8 rows and 2 dummy rows in two microbatches of 5, 80 heads,
# one group, chunk 256) first, then a ragged tail, S shorter than the
# chunk, two groups and no D
SSD_BWD_CASES = [(5, 1024, 80, 1, 256, True), (2, 1000, 80, 1, 256, True),
                 (2, 100, 80, 1, 256, True), (2, 512, 8, 2, 256, True),
                 (2, 700, 16, 1, 256, False)]
# kernel 1b at head dim 80: the shared block's training microbatch
# (B=5, S=1024, H=Hkv=32), then a small ragged GQA case
BWD80_CASES = [(5, 1024, ZAMBA_HEADS, ZAMBA_HEADS), (2, 200, 8, 2)]
ZAMBA_PROBE_LAYERS = 6       # the fp32 probe: one group
ZAMBA_PROBE_ROWS = 3         # 2 real rows and 1 dummy
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")


def ssd_bwd_flops_bytes(b, s, h, chunk, tensors):
    """The SSD backward's operations and bytes for these shapes: per (b,
    h) and chunk of q rows, five products over the causal pairs (q (q +
    1) / 2 of them: C B^T and the two products of its weighted gradient
    with B and C, N multiply-adds a pair; dy x^T and M^T dy, P each) and
    five (q, P, N) products for the states (the chunk state, the
    incoming state's gradient, dy state_in, G B, x G); every input read
    once and every output written once."""
    q_full = min(chunk, s)
    rows = [min(q_full, s - t0) for t0 in range(0, s, q_full)]
    pairs = sum(q * (q + 1) // 2 for q in rows)
    flops = 2.0 * b * h * (pairs * (3 * ZAMBA_N + 2 * ZAMBA_P)
                           + 5 * s * ZAMBA_N * ZAMBA_P)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return flops, nbytes


def ssd_bwd_case(sk, b, s, h, g, chunk, use_d, dtype, gen, dev, timed):
    """The SSD backward against ``ssd_scan_bwd_plain``: the relative L2
    error of each of its six gradients, two runs bitwise equal; timed at
    the training shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.parity import rel_l2

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = r(b, s, h, ZAMBA_P).to(dtype)
    dt = F.softplus(r(b, s, h) - 2.0)
    A = -torch.exp(r(h) * 0.5)
    Bm = (r(b, s, g, ZAMBA_N) * 0.3).to(dtype)
    Cm = (r(b, s, g, ZAMBA_N) * 0.3).to(dtype)
    D = r(h) if use_d else None
    dy = r(b, s, h, ZAMBA_P).to(dtype)
    args = (x, dt, A, Bm, Cm, D, dy)
    got = sk.ssd_scan_bwd_cuda(*args, chunk_size=chunk)
    want = sk.ssd_scan_bwd_plain(*args, chunk_size=chunk)
    again = sk.ssd_scan_bwd_cuda(*args, chunk_size=chunk)
    torch.cuda.synchronize()
    check(all(a is None if w is None else (a.dtype == w.dtype
                                           and a.shape == w.shape)
              for a, w in zip(got, want)),
          f"SSD backward {dtype} at {(b, s, h, g, chunk)}: dtypes or "
          f"shapes differ from the plain version's")
    check(all(torch.equal(a, g_) for a, g_ in zip(again, got)
              if a is not None),
          f"SSD backward {dtype} at {(b, s, h, g, chunk)}: two runs differ")
    errs = {n: rel_l2(a, w) for n, a, w in zip(SSD_BWD_NAMES, got, want)
            if w is not None}
    rec = {"kernel": "ssd_scan_bwd_cuda", "dtype": str(dtype), "B": b,
           "S": s, "H": h, "G": g, "P": ZAMBA_P, "N": ZAMBA_N,
           "chunk": chunk, "with_D": use_d, "rel_l2": max(errs.values()),
           "rel_l2_by_gradient": errs,
           "max_abs_err": max((a.float() - w.float()).abs().max().item()
                              for a, w in zip(got, want) if w is not None),
           "bitwise_repeat": True}
    if timed:
        run = lambda: sk.ssd_scan_bwd_cuda(*args, chunk_size=chunk)
        rec["ms"] = cuda_ms(run)
        by_kernel = device_ms_by_kernel(run)
        rec["device_ms_by_launch"] = by_kernel and {
            next((k for k in SSD_BWD_LAUNCHES + (
                "ssd_bwd_states", "ssd_bwd_pass", "ssd_bwd_rows",
                "ssd_bwd_cols", "ssd_bwd_dt", "ssd_bwd_final") if k in n),
                 n[:60]): ms
            for n, ms in by_kernel.items()}
        rec["device_ms"] = by_kernel and sum(by_kernel.values())
        rec["plain_ms"] = cuda_ms(lambda: sk.ssd_scan_bwd_plain(
            *args, chunk_size=chunk), reps=5)
        rec["library_ms"] = None        # no PyTorch call computes it
        flops, nbytes = ssd_bwd_flops_bytes(
            b, s, h, chunk, [t for t in args + got if t is not None])
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops)
        rec["scratch_bytes"] = _ssd_bwd_scratch_bytes(sk, b, s, h, g, chunk,
                                                      dtype)
    return rec


def _ssd_bwd_scratch_bytes(sk, b, s, h, g, chunk, dtype):
    """The bytes of scratch ``ssd_scan_bwd_cuda`` asks for at these
    shapes (None for a tree whose wrapper has no ``bwd_scratch_floats``,
    such as an older checkout timed by ``fresh_times.py``)."""
    import torch
    if not hasattr(sk, "bwd_scratch_floats"):
        return None
    from repro_torch.kernels import _build
    q = min(chunk, s)
    bf16 = dtype == torch.bfloat16
    slices = (_build.load().ssd_scan_bwd_sm90_slices(b, s, h, g, q)
              if bf16 else 1)
    return 4 * sk.bwd_scratch_floats(b, s, h, ZAMBA_P, g, q, bf16, slices)


def bwd80_case(fa, b, s, h, hkv, dtype, gen, dev, timed):
    """Kernel 1b at head dim 80 against its plain version on the forward
    kernel's out and lse, two runs bitwise equal; timed beside SDPA's
    autograd backward (``is_causal=True``), also by device time."""
    import torch
    from repro_torch.kernels.parity import rel_l2

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    q, dout = r(b, s, h, ZAMBA_DH), r(b, s, h, ZAMBA_DH)
    k, v = r(b, s, hkv, ZAMBA_DH), r(b, s, hkv, ZAMBA_DH)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    check(all(torch.equal(a, g) for a, g in zip(again, got)),
          f"D=80 backward {dtype} at S={s}: two runs differ")
    rec = {"kernel": "flash_attention_bwd_cuda", "dtype": str(dtype),
           "B": b, "S": s, "H": h, "Hkv": hkv, "D": ZAMBA_DH,
           "rel_l2": max(rel_l2(a, w) for a, w in zip(got, want)),
           "max_abs_err": max((a.float() - w.float()).abs().max().item()
                              for a, w in zip(got, want)),
           "bitwise_repeat": True}
    if timed:
        run = lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
        rec["ms"] = cuda_ms(run)
        rec["device_ms"] = device_ms(run)
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, lse, dout))
        qt, kt, vt = (x.detach().requires_grad_(True)
                      for x in _sdpa_layout(q, k, v))
        o_t = _sdpa(qt, kt, vt, True)
        do_t = dout.transpose(1, 2).contiguous()
        lib = lambda: torch.autograd.grad(o_t, (qt, kt, vt), do_t,
                                          retain_graph=True)
        rec["library_ms"] = cuda_ms(lib)
        rec["library_device_ms"] = device_ms(lib)
        rec["bound_ms"], rec["bound_by"] = _attn_bound(
            b, s, h, hkv, ZAMBA_DH, 2.5, (q, k, v, out, lse, dout), got)
    return rec


def zamba_train_kernel_phase(fa, sk, dev, smi):
    """Phase 19 (a), (b): the SSD backward and kernel 1b at head dim 80
    against their plain versions, fp32 (TF32 off) and bf16, by relative
    L2 (``parity.RTOL``); every case printed before any is checked."""
    import torch
    from repro_torch.kernels.parity import RTOL
    gen = torch.Generator(device=dev).manual_seed(19)
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        new = [ssd_bwd_case(sk, *c, dtype, gen, dev, timed=bf16 and i == 0)
               for i, c in enumerate(SSD_BWD_CASES)]
        for r in new:
            r["tol"] = RTOL[("ssd_scan_bwd_cuda", dtype)]
        bwd = [bwd80_case(fa, *c, dtype, gen, dev, timed=bf16 and i == 0)
               for i, c in enumerate(BWD80_CASES)]
        for r in bwd:
            r["tol"] = RTOL[("flash_attention_bwd_d80", dtype)]
        new += bwd
        for r in new:
            shape = {k: r[k] for k in ("B", "S", "H", "G", "Hkv", "D",
                                       "chunk", "with_D") if k in r}
            print(f"[zamba-train-kernels] {r['kernel']} {r['dtype']} "
                  f"{shape}: rel L2 {r['rel_l2']:.3e} (tol {r['tol']:g})"
                  + (" by gradient " + ", ".join(
                      f"{k} {v:.2e}" for k, v in
                      r["rel_l2_by_gradient"].items())
                     if "rel_l2_by_gradient" in r else "")
                  + f", max abs err {r['max_abs_err']:.3e}"
                  + (f"; {r['ms']:.4f} ms, device "
                     f"{_ms_or_not(r['device_ms'])}, plain "
                     f"{r['plain_ms']:.4f} ms, library "
                     + ("none" if r["library_ms"] is None
                        else f"{r['library_ms']:.4f} ms (SDPA backward), "
                             f"device {_ms_or_not(r['library_device_ms'])}")
                     + f", bound {r['bound_ms']:.6f} ms ({r['bound_by']}) "
                       f"[{smi}]" if "ms" in r else "")
                  + (f"; device time by launch {r['device_ms_by_launch']}"
                     if r.get("device_ms_by_launch") else "")
                  + (f"; scratch {r['scratch_bytes']} bytes"
                     if r.get("scratch_bytes") else ""), flush=True)
        recs += new
    # every case of both dtypes is printed before any is checked
    bad = [f"{r['kernel']} {r['dtype']} {r.get('S')}: {r['rel_l2']}"
           for r in recs if not r["rel_l2"] <= r["tol"]]
    check(not bad, "zamba training kernels vs plain: " + "; ".join(bad))
    return recs


@contextlib.contextmanager
def _reference_in(ref, scan, acc_dtype):
    """The plain path's scan ``ref.<scan>`` (``ssd_chunked`` or
    ``mlstm_chunked``, which the "reference" impl runs) computed in
    ``acc_dtype`` while the block runs."""
    real = getattr(ref, scan)
    setattr(ref, scan, functools.partial(real, acc_dtype=acc_dtype))
    try:
        yield
    finally:
        setattr(ref, scan, real)


def zamba_train_phase(fa, ce, sk, dev, smi, every):
    """Phase 19 (c), (d): zamba2-2.7b at full width and depth through
    ``build_train_step`` (phase 5's settings), then the fp32 probe (see
    the module docstring)."""
    import gc
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import transformer as tr
    from repro_torch.models.model import build_model
    from repro_torch.models.ssm import mamba_dims
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.optim import adam
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.monotonic()
    cfg = dataclasses.replace(cfgbase.resolve("zamba2-2.7b"),
                              attention_impl="kernel")
    check(cfg.remat == "full" and cfg.compute_dtype == "bfloat16",
          f"zamba2's remat {cfg.remat}, compute {cfg.compute_dtype}")
    ocfg = cfgbase.optimizer_for(cfg, lr=3e-4, warmup_steps=2,
                                 schedule="constant",
                                 total_steps=STUB_STEPS)
    model = build_model(cfg, dev)
    tcfg = cfgbase.TrainConfig(
        model=cfg, shape=cfgbase.ShapeConfig("zamba", STUB_SEQ, STUB_ROWS,
                                             "train"),
        het=cfgbase.HetConfig(accum_steps=STUB_ACCUM), optimizer=ocfg)
    batches, rows = deepseek_batches(cfg, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = tsteps.init_train_state(model, tcfg)
    step = tsteps.build_train_step(model, tcfg)
    fns = dict(every)
    fns["ssd_scan_bwd_cuda"] = sk.ssd_scan_bwd_cuda
    for f in fns.values():
        f.launches = 0
    losses, step_s = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, met = step(state, b)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        losses.append(float(met["loss"]))
    launches = {n: f.launches for n, f in fns.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # per step: each Mamba2 layer's scan twice a microbatch (the forward,
    # then its group's recompute under remat full) and its backward once;
    # the shared block's attention twice an application a microbatch and
    # its backward once (9 applications); the CE forward once a
    # microbatch and the dlogits pass once a 4096-token chunk of it
    groups = cfg.num_layers // cfg.hybrid.attn_every
    n = STUB_STEPS
    expect = {k: 0 for k in launches}
    base = train_launches(dataclasses.replace(cfg, num_layers=groups), rows,
                          STUB_ACCUM, STUB_SEQ, n)
    for k in ("flash_attention_cuda", "flash_attention_bwd_cuda",
              "cross_entropy_cuda", "ce_dlogits_cuda"):
        expect[k] = base[k]
    expect["ssd_scan_cuda"] = 2 * cfg.num_layers * STUB_ACCUM * n
    expect["ssd_scan_bwd_cuda"] = cfg.num_layers * STUB_ACCUM * n
    check(all(_finite(x) for x in losses), f"zamba2 losses {losses}")
    check(launches == expect, f"zamba2 train launches {launches} != "
          f"{expect}")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batches[-1])
        torch.cuda.synchronize()
    step_profile = _profile_rec(prof, (time.monotonic() - t0) * 1e6)
    del state, step, prof
    gc.collect()
    torch.cuda.empty_cache()
    ms = statistics.median(step_s[1:]) * 1e3
    tokens = STUB_ROWS * STUB_SEQ
    processed = rows * STUB_SEQ
    # model FLOPs of a step: 6 x parameters x tokens, the shared block's
    # counted once per application (each application is its own
    # products), plus the attention's products (causal, forward and
    # backward: 3 x 2 B S^2 D H an application) and the SSD scan's (its
    # causal pair and state products, forward and backward: 3 x the
    # forward's, ssd_flops_bytes)
    shared = tr.count_params_analytic(cfg) - tr.count_params_analytic(
        dataclasses.replace(cfg, hybrid=dataclasses.replace(
            cfg.hybrid, enabled=False)))
    n_eff = cfg.param_count() + (groups - 1) * shared
    attn = 3 * 2.0 * rows * groups * cfg.num_heads * STUB_SEQ ** 2 * \
        cfg.head_dim
    scan_fwd, _ = ssd_flops_bytes(rows, STUB_SEQ, mamba_dims(cfg)[1], 1,
                                  cfg.ssm.chunk_size, [])
    scan = 3 * scan_fwd * cfg.num_layers
    flops = 6.0 * n_eff * processed + attn + scan
    busy, win = step_profile["device_busy_us"], step_profile["window_us"]
    out = {"layers": cfg.num_layers, "rows": rows, "losses": losses,
           "moments": [ocfg.m_dtype, ocfg.v_dtype], "launches": launches,
           "expected_launches": expect,
           "step_ms": [t * 1e3 for t in step_s],
           "ms_per_step_median_2_to_n": ms,
           "tokens_per_s": tokens / (ms / 1e3),
           "params": cfg.param_count(), "shared_block_params": shared,
           "model_flops_per_step": flops,
           "model_flops_parts": {"6ND": 6.0 * n_eff * processed,
                                 "attention": attn, "scan": scan},
           "mfu_vs_989_tflops": flops / (ms / 1e3) / H100_BF16_FLOPS,
           "peak_memory_gib": peak, "step_profile": step_profile}
    print(f"[zamba-train] zamba2-2.7b at full width and depth "
          f"({cfg.num_layers} Mamba2 layers, the shared block after every "
          f"{cfg.hybrid.attn_every}; {cfg.param_count()} parameters), bf16, "
          f"remat {cfg.remat}, {ocfg.m_dtype} moments, {rows} rows of "
          f"{STUB_SEQ} tokens ({STUB_ROWS} real), accum {STUB_ACCUM}: "
          f"losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f"; {ms:.1f} ms/step (median of steps 2..{STUB_STEPS}), "
          f"{out['tokens_per_s']:.0f} real tokens/s, model FLOPs "
          f"{flops:.3e}/step (6 N D {6.0 * n_eff * processed:.3e} with N = "
          f"{n_eff} counting the shared block once an application, "
          f"attention {attn:.3e}, scan {scan:.3e}) = "
          f"{100 * out['mfu_vs_989_tflops']:.2f}% of 989 TFLOP/s, peak "
          f"memory {peak:.2f} GiB, launches {launches} [{smi}]", flush=True)
    print(f"[zamba-train] torch.profiler over 1 step: kernels "
          f"{busy / 1e3:.3f} ms of device time in {win / 1e3:.3f} ms of "
          f"wall; by kernel: "
          + "; ".join(f"{k['name'][:60]} x{k['count']} {k['us'] / 1e3:.3f} "
                      f"ms" for k in step_profile["kernels"][:14]),
          flush=True)

    # the fp32 probe: kernel path vs plain path, same params and rows,
    # full width cut to one group
    pcfg = dataclasses.replace(cfg, num_layers=ZAMBA_PROBE_LAYERS,
                               compute_dtype="float32",
                               param_dtype="float32")
    torch.cuda.reset_peak_memory_stats(dev)
    kern = build_model(pcfg, dev)
    plain = build_model(dataclasses.replace(pcfg,
                                            attention_impl="reference"), dev)
    params = kern.init_params(1)
    b0 = batches[0]
    probe = {k: torch.cat([v[:ZAMBA_PROBE_ROWS - 1], v[rows - 1:]])
             for k, v in b0.items()}
    ptcfg = dataclasses.replace(tcfg, model=pcfg,
                                het=cfgbase.HetConfig(accum_steps=1))
    sk.ssd_scan_bwd_cuda.launches = 0
    k_loss, _, k_grads = tsteps.loss_and_grads(kern, ptcfg, params, probe)
    check(sk.ssd_scan_bwd_cuda.launches == ZAMBA_PROBE_LAYERS,
          f"the probe's kernel path ran {sk.ssd_scan_bwd_cuda.launches} "
          f"SSD backward launches")
    names = _leaf_names(params)
    tol = TRAIN_RTOL["float32"]
    rec = {"layers": ZAMBA_PROBE_LAYERS, "rows": ZAMBA_PROBE_ROWS,
           "tol": tol}
    gk = adam.global_norm(k_grads)

    def worst_leaf(got, want):
        errs = [_rel_l2_by_rows(a, b) for a, b in zip(tree_leaves(got),
                                                      tree_leaves(want))]
        i = max(range(len(errs)), key=errs.__getitem__)
        return errs[i], names[i]

    # the plain path twice: as it runs (fp32), for the record, then with
    # its SSD scan computed in fp64, which the limits hold
    plain_grads = {}
    for acc in (torch.float32, torch.float64):
        with _reference_in(ssd_ref, "ssd_chunked", acc):
            loss, _, grads = tsteps.loss_and_grads(plain, ptcfg, params,
                                                   probe,
                                                   ce_impl="reference")
        gr = adam.global_norm(grads)
        err, leaf = worst_leaf(k_grads, grads)
        rec["scan_" + str(acc).split(".")[-1]] = {
            "loss_rel": abs(float(k_loss) - float(loss)) / abs(float(loss)),
            "grad_norm_rel": abs(float(gk) - float(gr)) / float(gr),
            "worst_leaf_rel_l2": err, "worst_leaf": leaf}
        plain_grads[acc] = grads
    # how far the fp32 plain path itself is from its fp64-scan version
    err, leaf = worst_leaf(plain_grads[torch.float32],
                           plain_grads[torch.float64])
    rec["plain_fp32_vs_fp64_scan"] = {"worst_leaf_rel_l2": err,
                                      "worst_leaf": leaf}
    del plain_grads, grads
    rec["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    held = rec["scan_float64"]
    print(f"[zamba-train] fp32 probe, {ZAMBA_PROBE_LAYERS} layers (one "
          f"group) at full width, fp32 parameters, {ZAMBA_PROBE_ROWS} rows "
          f"(peak {rec['peak_memory_gib']:.2f} GiB), kernel path vs plain "
          f"path with its SSD scan in fp64: loss rel "
          f"{held['loss_rel']:.3e} (tol {tol['loss']:g}), grad norm rel "
          f"{held['grad_norm_rel']:.3e} (tol {tol['grad_norm']:g}), worst "
          f"leaf rel L2 {held['worst_leaf_rel_l2']:.3e} "
          f"({held['worst_leaf']}; tol {tol['leaf']:g}); against the plain "
          f"path in fp32 (not held: its own gradient of A_log is the "
          f"least exact): {rec['scan_float32']}; the fp32 plain path "
          f"against its fp64-scan self: worst leaf rel L2 "
          f"{rec['plain_fp32_vs_fp64_scan']['worst_leaf_rel_l2']:.3e} "
          f"({rec['plain_fp32_vs_fp64_scan']['worst_leaf']})", flush=True)
    check(held["loss_rel"] <= tol["loss"] and held["grad_norm_rel"] <=
          tol["grad_norm"] and held["worst_leaf_rel_l2"] <= tol["leaf"],
          f"zamba2 fp32 probe: {rec}")
    out["probe"] = rec
    del kern, plain, params, k_grads, batches, b0, probe
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t_phase
    return out


# (B, S, H, dk, dv, chunk, large gates): xlstm-125m's training microbatch
# (phase 20's: 5 rows of 1024, 4 heads of 384, chunk 256) first, then a
# ragged tail, S shorter than the chunk, dk != dv at another chunk, and
# large gates (i~ ~ U(-30, 30), f~ ~ U(-10, 6))
MLSTM_BWD_CASES = [(5, 1024, 4, 384, 384, 256, False),
                   (2, 300, 4, 384, 384, 256, False),
                   (2, 100, 4, 384, 384, 256, False),
                   (2, 300, 4, 128, 256, 128, False),
                   (2, 512, 4, 384, 384, 256, True)]
MLSTM_BWD_NAMES = ("dq", "dk", "dv", "di", "df")
# the bf16 kernels, by their order in one call
MLSTM_BWD_LAUNCHES = ("mlstm_bwd_gates", "mlstm_bwd_cstate_sm90",
                      "mlstm_bwd_fpass_sm90", "mlstm_bwd_x_sm90",
                      "mlstm_bwd_rows_sm90", "mlstm_bwd_lstate_sm90",
                      "mlstm_bwd_rpass_sm90", "mlstm_bwd_cols_sm90",
                      "mlstm_bwd_gate_grads")
XLSTM_STEPS = 2              # a warm-up and one timed step
# draws of the large-gate case beside phase 20's own, each dtype, and
# the check over the five: the kernel's median distance from the fp64
# reference at most this times the plain version's. Held on the median:
# one draw can sit at a rounding-sensitive point where any two fp32
# evaluations land far apart (on the card the kernel read 5.3x the plain
# version on phase 20's bf16 draw and the plain 16x the kernel on
# another)
LARGE_GATE_DRAWS = 4
LARGE_GATE_FP64_FACTOR = 3
XLSTM_PROBE_LAYERS = 2       # the fp32 probe: one pair
XLSTM_PROBE_ROWS = 3         # 2 real rows and 1 dummy


def mlstm_bwd_flops_bytes(b, s, h, dk, dv, chunk, tensors):
    """The mLSTM backward's operations and bytes for these shapes: per (b,
    h) and chunk of q rows, five products over the causal pairs (q (q +
    1) / 2 of them: q k^T, dS k and dS^T q, dk multiply-adds a pair; dh
    v^T and W^T dnum, dv each) and the state products of the chunks that
    have them (dk dv multiply-adds a row): C_in dh and L over the rows
    after the first chunk, the chunk states, G v and G^T k over the rows
    before the last; every input read once and every output written
    once."""
    q_full = min(chunk, s)
    rows = [min(q_full, s - t0) for t0 in range(0, s, q_full)]
    pairs = sum(q * (q + 1) // 2 for q in rows)
    flops = 2.0 * b * h * (pairs * (3 * dk + 2 * dv) + dk * dv * (
        2 * (s - rows[0]) + 3 * (s - rows[-1])))
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return flops, nbytes


def mlstm_bwd_case(mk, b, s, h, dk, dv, chunk, large, dtype, gen, dev,
                   timed):
    """The mLSTM backward against ``mlstm_scan_bwd_plain``: the relative
    L2 error of each of its five gradients, two runs bitwise equal; timed
    at the training shape."""
    import torch
    from repro_torch.kernels.parity import rel_l2

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q, k = r(b, s, h, dk).to(dtype), r(b, s, h, dk).to(dtype)
    v, dh = r(b, s, h, dv).to(dtype), r(b, s, h, dv).to(dtype)
    if large:
        i_pre = torch.rand((b, s, h), generator=gen, device=dev) * 60 - 30
        f_pre = torch.rand((b, s, h), generator=gen, device=dev) * 16 - 10
    else:
        # as xlstm-125m's init sets the gates up: f~ shifted by its bias
        i_pre, f_pre = r(b, s, h), r(b, s, h) + 4.5
    args = (q, k, v, i_pre, f_pre, dh)
    got = mk.mlstm_scan_bwd_cuda(*args, chunk_size=chunk)
    want = mk.mlstm_scan_bwd_plain(*args, chunk_size=chunk)
    again = mk.mlstm_scan_bwd_cuda(*args, chunk_size=chunk)
    torch.cuda.synchronize()
    shape = (b, s, h, dk, dv, chunk)
    check(all(a.dtype == w.dtype and a.shape == w.shape
              for a, w in zip(got, want)),
          f"mLSTM backward {dtype} at {shape}: dtypes or shapes differ from "
          f"the plain version's")
    check(all(torch.equal(a, g_) for a, g_ in zip(again, got)),
          f"mLSTM backward {dtype} at {shape}: two runs differ")
    errs = {n: rel_l2(a, w) for n, a, w in zip(MLSTM_BWD_NAMES, got, want)}
    rec = {"kernel": "mlstm_scan_bwd_cuda", "dtype": str(dtype), "B": b,
           "S": s, "H": h, "dk": dk, "dv": dv, "chunk": chunk,
           "large_gates": large, "rel_l2": max(errs.values()),
           "rel_l2_by_gradient": errs,
           "max_abs_err": max((a.float() - w.float()).abs().max().item()
                              for a, w in zip(got, want)),
           "bitwise_repeat": True}
    if large:
        # at these gates every fp32 evaluation (the kernel, the plain
        # version, autograd through the reference) reads ~1e-4 to ~3e-2
        # against the fp64 reference, by draw (b reaches ~1e3 over a chunk
        # and denominators cancel): each is read against autograd through
        # the reference scan in fp64 (xlstm_train_kernel_phase holds the
        # kernel's median over five draws)
        from repro_torch.kernels.mlstm_scan import ref
        ins = [t.double().requires_grad_(True) for t in args[:5]]
        y64, _ = ref.mlstm_chunked(*ins, chunk_size=chunk,
                                   acc_dtype=torch.float64)
        exact = torch.autograd.grad(y64, ins, dh.double())
        # the reference's own fp32 evaluation: autograd through the fp32
        # scan, on the same (fp32-cast) inputs
        ins = [t.float().requires_grad_(True) for t in args[:5]]
        y32, _ = ref.mlstm_chunked(*ins, chunk_size=chunk)
        auto32 = torch.autograd.grad(y32, ins, dh.float())
        for key, ev in (("kernel", got), ("plain", want),
                        ("autograd32", auto32)):
            rec[f"{key}_vs_fp64"] = max(rel_l2(a, w)
                                        for a, w in zip(ev, exact))
            rec[f"{key}_vs_fp64_by_gradient"] = {
                n: rel_l2(a, w)
                for n, a, w in zip(MLSTM_BWD_NAMES, ev, exact)}
        del ins, y64, exact, y32, auto32
    if timed:
        run = lambda: mk.mlstm_scan_bwd_cuda(*args, chunk_size=chunk)
        rec["ms"] = cuda_ms(run)
        by_kernel = device_ms_by_kernel(run)
        rec["device_ms_by_launch"] = {
            next((k for k in MLSTM_BWD_LAUNCHES if k in n), n[:60]): ms
            for n, ms in by_kernel.items()} if by_kernel else None
        rec["device_ms"] = sum(by_kernel.values()) if by_kernel else None
        rec["plain_ms"] = cuda_ms(lambda: mk.mlstm_scan_bwd_plain(
            *args, chunk_size=chunk), reps=5)
        rec["library_ms"] = None        # no PyTorch call computes it
        flops, nbytes = mlstm_bwd_flops_bytes(b, s, h, dk, dv, chunk,
                                              list(args) + list(got))
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops)
        q_ = min(chunk, s)
        # (a checkout before the bf16 layout counts one layout for both)
        import inspect
        by_dtype = "bf16" in inspect.signature(
            mk.bwd_scratch_floats).parameters
        rec["scratch_bytes"] = 4 * (
            mk.bwd_scratch_floats(b, s, h, dk, dv, q_,
                                  dtype == torch.bfloat16) if by_dtype
            else mk.bwd_scratch_floats(b, s, h, dk, dv, q_))
    return rec


def xlstm_train_kernel_phase(mk, dev, smi):
    """Phase 20 (a): the mLSTM backward against its plain version, fp32
    (TF32 off) and bf16, by relative L2 (``parity.RTOL``); every case
    printed before any is checked."""
    import torch
    from repro_torch.kernels.parity import RTOL
    gen = torch.Generator(device=dev).manual_seed(20)
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        new = [mlstm_bwd_case(mk, *c, dtype, gen, dev,
                              timed=bf16 and i == 0)
               for i, c in enumerate(MLSTM_BWD_CASES)]
        for r in new:
            r["tol"] = RTOL[("mlstm_scan_bwd_large_gates" if r["large_gates"]
                             else "mlstm_scan_bwd_cuda", dtype)]
            shape = {k: r[k] for k in ("B", "S", "H", "dk", "dv", "chunk",
                                       "large_gates")}
            print(f"[xlstm-train-kernels] {r['kernel']} {r['dtype']} "
                  f"{shape}: rel L2 {r['rel_l2']:.3e} (tol {r['tol']:g}) by "
                  f"gradient " + ", ".join(
                      f"{k} {v:.2e}" for k, v in
                      r["rel_l2_by_gradient"].items())
                  + f", max abs err {r['max_abs_err']:.3e}"
                  + (f"; against the fp64 reference: kernel "
                     f"{r['kernel_vs_fp64']:.3e}, plain "
                     f"{r['plain_vs_fp64']:.3e}" if r["large_gates"] else "")
                  + (f"; {r['ms']:.4f} ms, device "
                     f"{_ms_or_not(r['device_ms'])}, plain "
                     f"{r['plain_ms']:.4f} ms, library none, bound "
                     f"{r['bound_ms']:.6f} ms ({r['bound_by']}) [{smi}]; "
                     f"device time by launch {r['device_ms_by_launch']}; "
                     f"scratch {r['scratch_bytes']} bytes"
                     if "ms" in r else ""), flush=True)
        recs += new
    # the large-gate case on LARGE_GATE_DRAWS more draws a dtype, each
    # from a generator of its own (phase 20's draw above is unchanged):
    # the kernel, the plain version and the reference's fp32 autograd,
    # each against autograd through the fp64 reference scan
    for dtype in (torch.float32, torch.bfloat16):
        draws = [r for r in recs if r["large_gates"]
                 and r["dtype"] == str(dtype)]
        for i in range(LARGE_GATE_DRAWS):
            g_i = torch.Generator(device=dev).manual_seed(2000 + i)
            r = mlstm_bwd_case(mk, *MLSTM_BWD_CASES[-1], dtype, g_i, dev,
                               timed=False)
            r["tol"] = RTOL[("mlstm_scan_bwd_large_gates", dtype)]
            r["draw"] = i + 1
            recs.append(r)
            draws.append(r)
        for i, r in enumerate(draws):
            print(f"[xlstm-train-kernels] large gates {r['dtype']} draw "
                  f"{i}: against the fp64 reference: kernel "
                  f"{r['kernel_vs_fp64']:.3e}, plain "
                  f"{r['plain_vs_fp64']:.3e}, the reference's fp32 "
                  f"autograd {r['autograd32_vs_fp64']:.3e}; kernel vs "
                  f"plain {r['rel_l2']:.3e}; by gradient (kernel / plain) "
                  + ", ".join(f"{n} {r['kernel_vs_fp64_by_gradient'][n]:.1e}"
                              f" / {r['plain_vs_fp64_by_gradient'][n]:.1e}"
                              for n in MLSTM_BWD_NAMES), flush=True)
        med = {k: statistics.median(r[f"{k}_vs_fp64"] for r in draws)
               for k in ("kernel", "plain")}
        print(f"[xlstm-train-kernels] large gates {dtype}: median over "
              f"the {len(draws)} draws against the fp64 reference: kernel "
              f"{med['kernel']:.3e}, plain {med['plain']:.3e} (held: the "
              f"kernel's within {LARGE_GATE_FP64_FACTOR}x the plain "
              f"version's)", flush=True)
        check(med["kernel"] <= LARGE_GATE_FP64_FACTOR * med["plain"],
              f"mLSTM backward at large gates, {dtype}: the kernel's "
              f"median distance from the fp64 reference {med['kernel']:.3e}"
              f" is above {LARGE_GATE_FP64_FACTOR}x the plain version's "
              f"{med['plain']:.3e}")
    bad = [f"{r['kernel']} {r['dtype']} S={r['S']}: {r['rel_l2']}"
           for r in recs if not r["rel_l2"] <= r["tol"]]
    check(not bad, "mLSTM backward vs plain: " + "; ".join(bad))
    return recs


def xlstm_train_phase(ce, mk, dev, smi, every):
    """Phase 20 (b), (c): xlstm-125m at full width and depth through
    ``build_train_step`` (phase 5's settings), then the fp32 probe (see
    the module docstring)."""
    import gc
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.kernels.mlstm_scan import ref as mlstm_ref
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.models.xlstm import mlstm_dims
    from repro_torch.optim import adam
    t_phase = time.monotonic()
    cfg = dataclasses.replace(cfgbase.resolve("xlstm-125m"),
                              attention_impl="kernel")
    check(cfg.remat == "full" and cfg.compute_dtype == "bfloat16",
          f"xlstm-125m's remat {cfg.remat}, compute {cfg.compute_dtype}")
    ocfg = cfgbase.optimizer_for(cfg, lr=3e-4, warmup_steps=2,
                                 schedule="constant",
                                 total_steps=STUB_STEPS)
    model = build_model(cfg, dev)
    tcfg = cfgbase.TrainConfig(
        model=cfg, shape=cfgbase.ShapeConfig("xlstm", STUB_SEQ, STUB_ROWS,
                                             "train"),
        het=cfgbase.HetConfig(accum_steps=STUB_ACCUM), optimizer=ocfg)
    batches, rows = deepseek_batches(cfg, dev)
    batches = batches[:XLSTM_STEPS]
    torch.cuda.reset_peak_memory_stats(dev)
    state = tsteps.init_train_state(model, tcfg)
    step = tsteps.build_train_step(model, tcfg)
    fns = dict(every)
    fns["mlstm_scan_bwd_cuda"] = mk.mlstm_scan_bwd_cuda
    for f in fns.values():
        f.launches = 0
    losses, step_s = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, met = step(state, b)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        losses.append(float(met["loss"]))
    launches = {n: f.launches for n, f in fns.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # per step: each mLSTM layer's scan twice a microbatch (the forward,
    # then its pair's recompute under remat full) and its backward once;
    # the CE forward once a microbatch and the dlogits pass once a
    # 4096-token chunk of it; no attention
    pairs = cfg.num_layers // 2
    n = len(batches)
    expect = {k: 0 for k in launches}
    base = train_launches(cfg, rows, STUB_ACCUM, STUB_SEQ, n)
    for k in ("cross_entropy_cuda", "ce_dlogits_cuda"):
        expect[k] = base[k]
    expect["mlstm_scan_cuda"] = 2 * pairs * STUB_ACCUM * n
    expect["mlstm_scan_bwd_cuda"] = pairs * STUB_ACCUM * n
    check(all(_finite(x) for x in losses), f"xlstm-125m losses {losses}")
    check(launches == expect, f"xlstm-125m train launches {launches} != "
          f"{expect}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    ms = statistics.median(step_s[1:]) * 1e3
    tokens = STUB_ROWS * STUB_SEQ
    processed = rows * STUB_SEQ
    # model FLOPs of a step: 6 x parameters x tokens, plus the mLSTM
    # scan's own products (its causal pair and state products, forward
    # and backward: 3 x the forward's, mlstm_flops_bytes)
    _, h, dk = mlstm_dims(cfg)
    scan_fwd, _ = mlstm_flops_bytes(rows, STUB_SEQ, h, dk, dk, 256, [])
    scan = 3 * scan_fwd * pairs
    flops = 6.0 * cfg.param_count() * processed + scan
    out = {"layers": cfg.num_layers, "rows": rows, "losses": losses,
           "moments": [ocfg.m_dtype, ocfg.v_dtype], "launches": launches,
           "expected_launches": expect,
           "step_ms": [t * 1e3 for t in step_s],
           "ms_per_step_median_2_to_n": ms,
           "tokens_per_s": tokens / (ms / 1e3),
           "params": cfg.param_count(),
           "model_flops_per_step": flops,
           "model_flops_parts": {"6ND": 6.0 * cfg.param_count() * processed,
                                 "scan": scan},
           "mfu_vs_989_tflops": flops / (ms / 1e3) / H100_BF16_FLOPS,
           "peak_memory_gib": peak}
    print(f"[xlstm-train] xlstm-125m at full width and depth "
          f"({pairs} mLSTM and {pairs} sLSTM blocks; {cfg.param_count()} "
          f"parameters), bf16, remat {cfg.remat}, {ocfg.m_dtype} moments, "
          f"{rows} rows of {STUB_SEQ} tokens ({STUB_ROWS} real), accum "
          f"{STUB_ACCUM}: losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f"; {ms:.1f} ms/step (median of steps 2..{n}), "
          f"{out['tokens_per_s']:.0f} real tokens/s, model FLOPs "
          f"{flops:.3e}/step (6 N D {6.0 * cfg.param_count() * processed:.3e}"
          f", scan {scan:.3e}) = {100 * out['mfu_vs_989_tflops']:.3f}% of "
          f"989 TFLOP/s, peak memory {peak:.2f} GiB, launches {launches} "
          f"[{smi}]", flush=True)

    # the fp32 probe: kernel path vs plain path, same params and rows,
    # full width cut to one pair
    pcfg = dataclasses.replace(cfg, num_layers=XLSTM_PROBE_LAYERS,
                               compute_dtype="float32",
                               param_dtype="float32")
    torch.cuda.reset_peak_memory_stats(dev)
    kern = build_model(pcfg, dev)
    plain = build_model(dataclasses.replace(pcfg,
                                            attention_impl="reference"), dev)
    params = kern.init_params(1)
    b0 = batches[0]
    probe = {k: torch.cat([v[:XLSTM_PROBE_ROWS - 1], v[rows - 1:]])
             for k, v in b0.items()}
    ptcfg = dataclasses.replace(tcfg, model=pcfg,
                                het=cfgbase.HetConfig(accum_steps=1))
    mk.mlstm_scan_bwd_cuda.launches = 0
    k_loss, _, k_grads = tsteps.loss_and_grads(kern, ptcfg, params, probe)
    check(mk.mlstm_scan_bwd_cuda.launches == XLSTM_PROBE_LAYERS // 2,
          f"the probe's kernel path ran {mk.mlstm_scan_bwd_cuda.launches} "
          f"mLSTM backward launches")
    names = _leaf_names(params)
    tol = TRAIN_RTOL["float32"]
    rec = {"layers": XLSTM_PROBE_LAYERS, "rows": XLSTM_PROBE_ROWS,
           "tol": tol}
    gk = adam.global_norm(k_grads)

    def worst_leaf(got, want):
        errs = [_rel_l2_by_rows(a, b) for a, b in zip(tree_leaves(got),
                                                      tree_leaves(want))]
        i = max(range(len(errs)), key=errs.__getitem__)
        return errs[i], names[i]

    # the plain path with its mLSTM scan computed in fp64 (its sLSTM loop
    # costs seconds, so the fp32 plain path, 2.2e-6 off this one at the
    # worst leaf on an H100, is not run as well)
    with _reference_in(mlstm_ref, "mlstm_chunked", torch.float64):
        loss, _, grads = tsteps.loss_and_grads(plain, ptcfg, params, probe,
                                               ce_impl="reference")
    gr = adam.global_norm(grads)
    err, leaf = worst_leaf(k_grads, grads)
    held = rec["scan_float64"] = {
        "loss_rel": abs(float(k_loss) - float(loss)) / abs(float(loss)),
        "grad_norm_rel": abs(float(gk) - float(gr)) / float(gr),
        "worst_leaf_rel_l2": err, "worst_leaf": leaf}
    del grads
    rec["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[xlstm-train] fp32 probe, {XLSTM_PROBE_LAYERS} layers (one "
          f"pair) at full width, fp32 parameters, {XLSTM_PROBE_ROWS} rows "
          f"(peak {rec['peak_memory_gib']:.2f} GiB), kernel path vs plain "
          f"path with its mLSTM scan in fp64: loss rel "
          f"{held['loss_rel']:.3e} (tol {tol['loss']:g}), grad norm rel "
          f"{held['grad_norm_rel']:.3e} (tol {tol['grad_norm']:g}), worst "
          f"leaf rel L2 {held['worst_leaf_rel_l2']:.3e} "
          f"({held['worst_leaf']}; tol {tol['leaf']:g})", flush=True)
    check(held["loss_rel"] <= tol["loss"] and held["grad_norm_rel"] <=
          tol["grad_norm"] and held["worst_leaf_rel_l2"] <= tol["leaf"],
          f"xlstm-125m fp32 probe: {rec}")
    out["probe"] = rec
    del kern, plain, params, k_grads, batches, b0, probe
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t_phase
    return out


def _phase_done(phases, name, t0):
    """Record and print the seconds of the phase begun at ``t0``."""
    phases[name] = time.monotonic() - t0
    print(f"[phase] {name} {phases[name]:.1f} s", flush=True)


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="chip smoke test of "
                                 "repro_torch (no arguments: one card)")
    ap.add_argument("--cards", type=int, default=1,
                    help="above 1: only the multi-rank path with one card "
                         "per rank (NCCL), on 2 and 4 ranks")
    opts = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if opts.cards > 1:
        cards_main(dev, smi, opts.cards)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    from repro_torch.kernels import _build
    from repro_torch.kernels.cross_entropy import cross_entropy as ce
    from repro_torch.kernels.cross_entropy import ref as ce_ref
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mla_decode import mla_decode as md
    from repro_torch.kernels.mla_decode import ref as mla_ref
    from repro_torch.kernels.mlstm_scan import mlstm_scan as mk
    from repro_torch.kernels.quantize import quantize as qz
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    t0 = time.monotonic()
    lib_path = _build.build(verbose=True)
    _build.load()
    build_s = time.monotonic() - t0
    print(f"[build] {lib_path.name} from "
          f"{[s.name for s in _build.sources()]} and "
          f"{[s.name for s in _build.headers()]} in {build_s:.1f} s",
          flush=True)
    t0 = time.monotonic()
    sm90 = sm90_report(_build, _build.load(), fa, ce, md, sk, mk)
    sm90["paged_decode"] = decode_ptxas_report(_build)

    phases = {"build": build_s, "sm90_report": time.monotonic() - t0}
    t0 = time.monotonic()
    recs = kernel_phase(fa, dev)
    _phase_done(phases, "serve_kernels", t0)
    t0 = time.monotonic()
    rows_mb, seq = TRAIN_MICROBATCH
    recs += train_kernel_phase(fa, ce, ce_ref, dev, rows_mb, seq)
    _phase_done(phases, "train_kernels", t0)
    t0 = time.monotonic()
    path = path_phase(fa, md, dev)
    _phase_done(phases, "serve_path", t0)
    t0 = time.monotonic()
    train = train_phase(fa, ce, dev)
    _phase_done(phases, "train_path", t0)
    t0 = time.monotonic()
    exchange_recs, exchange_chunks = exchange_kernel_phase(dev)
    recs += exchange_recs
    _phase_done(phases, "exchange_kernels", t0)
    t0 = time.monotonic()
    multi = multi_rank_phase(dev, smi)
    _phase_done(phases, "multi_rank_path", t0)
    t0 = time.monotonic()
    recs += mla_kernel_phase(fa, md, mla_ref, dev)
    _phase_done(phases, "mla_kernels", t0)
    every = {**_counters(fa, ce),
             "quantize_int8_cuda": qz.quantize_int8_cuda,
             "dequant_accum_cuda": qz.dequant_accum_cuda,
             **{n: getattr(qz, n) for n in LEG_NAMES},
             "mla_decode_paged_cuda": md.mla_decode_paged_cuda,
             "mla_decode_cuda": md.mla_decode_cuda,
             "ssd_scan_cuda": sk.ssd_scan_cuda,
             "mlstm_scan_cuda": mk.mlstm_scan_cuda}
    t0 = time.monotonic()
    mla = mla_path_phase(fa, md, dev, smi, every)
    gen_s = mla["generate"]["seconds"] + mla["generate"]["gate"]["seconds"]
    phases["mla_serve_path"] = time.monotonic() - t0 - gen_s
    phases["mla_generate_path"] = gen_s
    t0 = time.monotonic()
    recs += zamba_kernel_phase(fa, sk, dev, smi)
    _phase_done(phases, "zamba_kernels", t0)
    t0 = time.monotonic()
    zamba = zamba_path_phase(fa, md, sk, dev, smi)
    _phase_done(phases, "zamba_generate_path", t0)
    t0 = time.monotonic()
    recs += xlstm_kernel_phase(mk, dev, smi)
    _phase_done(phases, "xlstm_kernels", t0)
    t0 = time.monotonic()
    xlstm = xlstm_path_phase(every, dev, smi)
    _phase_done(phases, "xlstm_generate_path", t0)
    t0 = time.monotonic()
    ckpt = ckpt_phase(smi, train)
    _phase_done(phases, "ckpt_remesh_path", t0)
    t0 = time.monotonic()
    overlap = overlap_phase(dev, fa, ce, smi, multi)
    _phase_done(phases, "overlap_canonical_path", t0)
    t0 = time.monotonic()
    pipeline = pipeline_phase(dev, smi, train)
    _phase_done(phases, "pipeline_path", t0)
    t0 = time.monotonic()
    d128_recs, archs = archs_phase(fa, ce, md, dev, smi)
    recs += d128_recs
    _phase_done(phases, "archs_path", t0)
    t0 = time.monotonic()
    deepseek = deepseek_train_phase(fa, ce, dev, smi)
    _phase_done(phases, "deepseek_train_path", t0)
    t0 = time.monotonic()
    recs += zamba_train_kernel_phase(fa, sk, dev, smi)
    _phase_done(phases, "zamba_train_kernels", t0)
    t0 = time.monotonic()
    zamba_train = zamba_train_phase(fa, ce, sk, dev, smi, every)
    _phase_done(phases, "zamba_train_path", t0)
    t0 = time.monotonic()
    recs += xlstm_train_kernel_phase(mk, dev, smi)
    _phase_done(phases, "xlstm_train_kernels", t0)
    t0 = time.monotonic()
    xlstm_train = xlstm_train_phase(ce, mk, dev, smi, every)
    _phase_done(phases, "xlstm_train_path", t0)
    print("[phases] seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.items()), flush=True)

    root = "src/repro/kernels/"
    src = {"flash_attention_cuda": (
               "src/repro_torch/csrc/flash_attention.cu",
               root + "flash_attention/flash_attention.py:88"),
           "flash_decode_paged_cuda": (
               "src/repro_torch/csrc/paged_decode.cu",
               root + "flash_attention/flash_attention.py:210"),
           "flash_attention_bwd_cuda": (
               "src/repro_torch/csrc/flash_attention_bwd.cu",
               root + "flash_attention/ref.py:115"),
           "cross_entropy_cuda": (
               "src/repro_torch/csrc/cross_entropy.cu",
               root + "cross_entropy/cross_entropy.py:90"),
           "ce_dlogits_cuda": (
               "src/repro_torch/csrc/cross_entropy.cu",
               root + "cross_entropy/ref.py:90"),
           # kernels 4 and 5 in the exchange's fused legs (their own
           # entry points ride in the send and receive legs' entries as
           # "standalone": no path launches them)
           "exchange_send_cuda": (
               "src/repro_torch/csrc/quantize.cu",
               root + "quantize/quantize.py:50"),
           "exchange_receive_cuda": (
               "src/repro_torch/csrc/quantize.cu",
               root + "quantize/quantize.py:107"),
           "exchange_decode_cuda": (
               "src/repro_torch/csrc/quantize.cu",
               root + "quantize/quantize.py:107"),
           "mla_decode_paged_cuda": (
               "src/repro_torch/csrc/mla_decode.cu",
               root + "mla_decode/mla_decode.py:178"),
           "mla_decode_cuda": (
               "src/repro_torch/csrc/mla_decode.cu",
               root + "mla_decode/mla_decode.py:80"),
           "ssd_scan_cuda": (
               "src/repro_torch/csrc/ssd_scan.cu",
               root + "ssd_scan/ssd_scan.py:86"),
           "mlstm_scan_cuda": (
               "src/repro_torch/csrc/mlstm_scan.cu",
               root + "mlstm_scan/mlstm_scan.py:95"),
           # kernel 2 at head dim 128 (glm4-9b, phi4-mini, arctic): the
           # same wrapper and counter, its launches the phase-17 serves'
           "paged_decode_d128": (
               "src/repro_torch/csrc/paged_decode.cu",
               root + "flash_attention/flash_attention.py:210"),
           # kernel 1b at head dim 192 (deepseek-v2's MLA training): the
           # same wrapper and counter, its launches phase 18's
           "flash_attention_bwd_d192": (
               "src/repro_torch/csrc/flash_attention_bwd.cu",
               root + "flash_attention/ref.py:115"),
           # the SSD scan's backward: no TPU kernel (the JAX package
           # differentiates ref.ssd_chunked); its launches phase 19's
           "ssd_scan_bwd": (
               "src/repro_torch/csrc/ssd_scan_bwd.cu",
               "none: JAX differentiates " + root + "ssd_scan/ref.py:80"),
           # kernel 1b at head dim 80 (zamba2's shared block): the same
           # wrapper and counter, its launches phase 19's
           "flash_attention_bwd_d80": (
               "src/repro_torch/csrc/flash_attention_bwd.cu",
               root + "flash_attention/ref.py:115"),
           # the mLSTM scan's backward: no TPU kernel (the JAX package
           # differentiates ref.mlstm_chunked); its launches phase 20's
           "mlstm_scan_bwd": (
               "src/repro_torch/csrc/mlstm_scan_bwd.cu",
               "none: JAX differentiates " + root + "mlstm_scan/ref.py:66")}
    counter_of = {"ssd_scan_bwd": "ssd_scan_bwd_cuda",
                  "flash_attention_bwd_d80": "flash_attention_bwd_cuda",
                  "mlstm_scan_bwd": "mlstm_scan_bwd_cuda"}
    # launches: the path each kernel serves (GQA decode: serve; the MLA
    # paged decode: the MLA serve path; the contiguous MLA decode: the
    # MLA generate path; the exchange kernels: the multi-rank train path,
    # rank 0's counts; the SSD scan: the zamba2 generate path; the mLSTM
    # scan: the xLSTM generate path; the rest: the one-rank train path);
    # every path's counts go to the json
    by_path = {n: {"serve": path["launches"].get(n, 0),
                   "train": train["launches"].get(n, 0),
                   "multi_rank": multi["launches"].get(n, 0),
                   "mla_serve": mla["launches"].get(n, 0),
                   "mla_generate": mla["generate"]["launches"].get(n, 0),
                   "zamba_generate": zamba["launches"].get(n, 0),
                   "xlstm_generate": xlstm["launches"].get(n, 0),
                   "ckpt_resume": ckpt["resume"]["launches"]["resume-2"]
                   .get(n, 0),
                   "ckpt_remesh_two_pod": ckpt["remesh"]["launches_two_pod"]
                   [0].get(n, 0),
                   **{f"overlap_{k}": r["launches"].get(n, 0)
                      for k, r in overlap["runs"].items()},
                   "canonical": overlap["canonical"]["launches"].get(n, 0),
                   "pipeline": pipeline["launches"].get(n, 0),
                   "pipe_axis": sum(r.get(n, 0) for r in pipeline[
                       "pipe_axis"]["launches_by_rank"]),
                   "archs_serve": archs["launches"]["serve"].get(
                       "flash_decode_paged_cuda" if n == "paged_decode_d128"
                       else n, 0),
                   "archs_train": archs["launches"]["train"].get(n, 0),
                   "deepseek_train": deepseek["launches"].get(
                       "flash_attention_bwd_cuda"
                       if n == "flash_attention_bwd_d192" else n, 0),
                   "zamba_train": zamba_train["launches"].get(
                       counter_of.get(n, n), 0),
                   "xlstm_train": xlstm_train["launches"].get(
                       counter_of.get(n, n), 0)}
               for n in src}
    path_of = {"flash_decode_paged_cuda": "serve",
               **{n: "multi_rank" for n in LEG_NAMES},
               "mla_decode_paged_cuda": "mla_serve",
               "mla_decode_cuda": "mla_generate",
               "ssd_scan_cuda": "zamba_generate",
               "mlstm_scan_cuda": "xlstm_generate",
               "paged_decode_d128": "archs_serve",
               "flash_attention_bwd_d192": "deepseek_train",
               "ssd_scan_bwd": "zamba_train",
               "flash_attention_bwd_d80": "zamba_train",
               "mlstm_scan_bwd": "xlstm_train"}
    at_keys = ("dtype", "B", "Sq", "S", "H", "Hkv", "D", "T", "V", "R",
               "kv_lens", "bs", "rows", "MB", "G", "P", "N", "chunk", "dk",
               "dv", "nbc", "ns", "d_rows")
    kernels = []
    attention = ("flash_attention_cuda", "flash_attention_bwd_cuda")
    for name, (source, replaces) in src.items():
        if name in ("flash_attention_bwd_d192", "flash_attention_bwd_d80"):
            d = MLA_DQK if name.endswith("192") else ZAMBA_DH
            mine = [r for r in recs if r["kernel"] == attention[1]
                    and r.get("D") == d]
        else:
            mine = [r for r in recs if r["kernel"] == counter_of.get(name,
                                                                     name)]
        timed = [r for r in mine if "ms" in r]
        # the attention kernels' rows are the train path's D=128 cases;
        # the prefill's D=192 case (the MLA prefill) and D=80 case
        # (zamba2's shared attention) ride beside it, the backward's
        # D=192 case has its own row
        main_rec = [r for r in timed
                    if (r.get("D") not in (64, MLA_DQK, ZAMBA_DH)
                        or name not in attention)
                    and r.get("window") != "long"
                    and "continuity" not in r and not r.get("bucket")
                    and r.get("arch") in (None, D128_HEADS[0][0])][-1]
        path_name = path_of.get(name, "train")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": by_path[name][path_name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "launches_by_path": by_path[name],
            "two_call_ms": main_rec.get("two_call_ms"),
            "device_ms": main_rec.get("device_ms"),
            "library_device_ms": main_rec.get("library_device_ms"),
            "device_ms_by_launch": main_rec.get("device_ms_by_launch"),
            "at": {k: main_rec[k] for k in main_rec if k in at_keys}})
        if name == "paged_decode_d128":
            # glm4's heads lead; phi4's and arctic's ride beside them
            kernels[-1]["cases"] = [
                {"arch": r["arch"], **{k: r[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "device_ms", "library_device_ms")},
                 "at": {k: r[k] for k in r if k in at_keys}}
                for r in timed]
        for key, d, path_name_d in ((("at_d64", 64, "serve"),
                                     ("at_d192", MLA_DQK, "mla_serve"),
                                     ("at_d80", ZAMBA_DH, "zamba_generate"))
                                    if name == attention[0] else ()):
            # D=64: phase 2's largest bucket (B=2, S=512)
            at_d = [r for r in timed if r.get("D") == d
                    and (d != 64 or r.get("Sq") == 512)]
            if at_d:
                kernels[-1][key] = {
                    "launches": by_path[name][path_name_d],
                    **{k: at_d[-1][k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")},
                    "at": {k: at_d[-1][k] for k in at_d[-1]
                           if k in at_keys}}
        bucket = [r for r in timed if r.get("bucket")]
        if bucket:
            # the overlap pipelines' launch: one 25-MiB bucket
            kernels[-1]["at_one_bucket"] = {
                "launches": by_path[name]["overlap_buckets"],
                **{k: bucket[-1][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "device_ms")},
                "at": {k: bucket[-1][k] for k in bucket[-1] if k in at_keys}}
        standalone = {"exchange_send_cuda": "quantize_int8_cuda",
                      "exchange_receive_cuda": "dequant_accum_cuda"}
        if name in standalone:
            # kernel 4 or 5 with the TPU kernel's own contract, as the
            # parent's path launched it: at the chunk and one-bucket
            # shapes (kernel 4: the send side's rows, then the re-quantize
            # of a shard)
            kernels[-1]["standalone"] = [
                {"name": standalone[name], "one_bucket": bool(r.get(
                    "bucket")), **{k: r[k] for k in (
                        "ms", "device_ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")},
                 "at": {k: r[k] for k in r if k in at_keys}}
                for r in recs if r["kernel"] == standalone[name]
                and "ms" in r]
        if name == "exchange_send_cuda":
            # rank 0's three legs of one chunk and of one bucket as
            # core/buckets.py runs them: device time and launches
            kernels[-1]["exchange_legs"] = exchange_chunks
        long_window = [r for r in timed if r.get("window") == "long"]
        if long_window:
            kernels[-1]["at_long_window"] = {
                **{k: long_window[-1][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "device_ms", "library_device_ms")},
                "at": {k: long_window[-1][k] for k in long_window[-1]
                       if k in at_keys}}
        for r in (r for r in timed if "continuity" in r):
            kernels[-1][r["continuity"]] = {
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "device_ms",
                                     "library_device_ms",
                                     "device_ms_by_launch")},
                "at": {k: r[k] for k in r if k in at_keys}}
        check(kernels[-1]["launches"] > 0, f"{name} never launched on its "
              f"path")
    check(kernels[0]["at_d80"]["launches"] > 0,
          "the D=80 prefill never launched on the zamba2 path")
    check(len(kernels) == 17, f"{len(kernels)} kernels listed")
    for k in kernels:
        if k["name"] in LEG_NAMES:
            check(k["at_one_bucket"]["launches"] > 0,
                  f"{k['name']} never launched on the overlap path")
    for n in ("quantize_int8_cuda", "dequant_accum_cuda"):
        check(sum(by_n.get(n, 0) for by_n in (
            multi["launches"], *(r["launches"] for r in
                                 overlap["runs"].values()))) == 0,
              f"{n} launched on the exchange's path")

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "phase_seconds": phases, "sm90": sm90,
         "kernel_cases": recs,
         "path": path, "train": train, "multi_rank": multi,
         "mla_path": mla, "zamba_path": zamba, "xlstm_path": xlstm,
         "ckpt_path": ckpt, "overlap_path": overlap,
         "pipeline_path": pipeline, "archs_path": archs,
         "deepseek_train_path": deepseek, "zamba_train_path": zamba_train,
         "xlstm_train_path": xlstm_train, "kernels": kernels},
        indent=1,
        default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
