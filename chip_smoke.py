#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                # every phase; needs one CUDA card
    python3 chip_smoke.py --phases 1,2,3 # device, build, kernel checks only
    python3 chip_smoke.py --phases 1,2,9 # build, then the MoE slice
    python3 chip_smoke.py --phases 1,2,10 # build, then the prefill slice
    python3 chip_smoke.py --phases 1,2,11 # build, then 2PH and AllGather-matmul
    python3 chip_smoke.py --phases 1,2,12 # build, then hymba-1.5b served
    python3 chip_smoke.py --phases 1,2,13 # build, then the serving stack
    python3 chip_smoke.py --phases 1,2,14 # build, then the API and traces
    python3 chip_smoke.py --phases 1,2,15 # build, then faults and guardrails
    python3 chip_smoke.py --phases 1,2,16 # build, then the trainer
    python3 chip_smoke.py --phases 1,2,17 # build, then rwkv6-7b
    python3 chip_smoke.py --phases 1,2,18 # build, then FSDP and the dry run
    python3 chip_smoke.py --phases 1,2,19 # build, then channels and examples

Phases, each printing one JSON line (any failure raises, exit != 0):

1. device — the card's name, and name + power limit from nvidia-smi;
2. build — compiles every kernel of ``src/repro_torch/csrc`` into
   ``build/`` (one nvcc per source, started together), and fails unless
   the SASS (``cuobjdump -sass``) of the AllGather-matmul library and of
   the flash-attention library each holds wgmma (HGMMA) and TMA loads
   (UTMALDG) and no ``mma.sync`` (HMMA), and that of the 1PA library
   cluster barriers, the multicast bulk copy, the packet stores and PDL,
   with no cooperative launch in its source (ptxas's registers per 1PA
   kernel beside them);
3. kernel vs plain — the DSL-executor kernel against ``TorchExecutor``
   on the card, bit-equal in f32, bf16 and int32, over every registry
   entry ×
   n in {2, 4, 8} × O0-O3 at three sizes (the last several blocks a rank
   with a ragged last tile), and the decode plans of qwen3-1.7b, of
   phi3.5-moe (its ``moe_alltoall`` among them) and of hymba-1.5b at TP
   2/4; then each
   decode plan (every bucket) in f32 and bf16 captured once in a CUDA
   graph (one executor node, cooperative) and replayed 16 times on fresh
   inputs with an eager call of the same executor between replays, each
   bit-equal to ``TorchExecutor`` (the kernel keeps its epoch on the
   card);
4. main path — full-width qwen3-1.7b (28 layers, seeded random bf16
   weights), TP=4 stacked on the card: 8 requests of 16-token prompts,
   then 32 greedy tokens, in auto, explicit, auto with the int8 KV cache
   and explicit with it. The engine captures its step in a CUDA graph
   and serves by replaying it; the same engine then serves again from
   position 0 with the eager step: first-step logits bit-equal and
   every token equal. Explicit runs on the kernel: 58 launches captured
   (the wrapper's count over the engine's construction is the warm-up
   steps' and the capture's, none while replaying), 58 a step eager,
   and a profiler count of 58 executor kernels a replay over 4 replays.
   Explicit matches auto's first-step logits within the stated bf16
   tolerance, with the bf16 and with the int8 cache; the int8 cache's
   last prefill logits lie within the reference's bar of the bf16
   cache's (max abs error under 5 % of max abs, argmax agreement at
   least 0.5). Graph and eager ms/token, and the busy share under
   replay;
5. f32 at full width, 4 layers: explicit and auto greedy tokens equal
   over 16 steps (served by graph replay, each against its eager run);
6. kernel time at each decode shape (the AllReduce and AllGather plans
   of qwen3-1.7b and of phi3.5-moe, phi3.5-moe's all_to_all plans and
   hymba-1.5b's AllReduce plans)
   beside its HBM bound, the plain version and a one-call PyTorch
   yardstick, with the launch's blocks a rank and threads, and the same
   program's time on 8 elements a chunk (launch and flags, no copies);
7. (opt-in, ``--phases 7``) a ``torch.profiler`` breakdown of one
   decode step in each mode, for the main paths of phases 4, 9 and 12, by
   graph replay and eager, and of one prefill forward of each phase-10
   model: device busy share and the top kernels;
8. collective library — ``repro_torch.kernels.ops`` and its four
   kernels (1PA AllReduce LL/HB, all-pairs ReduceScatter and AllGather,
   ring AllGather): each op × algo × protocol bit-equal to its plain
   version over n in {2, 4, 8} × f32/bf16/int32 × the reference tests'
   shapes and an odd bf16 count, and at qwen3-1.7b's TP=4 serving sizes;
   the cluster 1PA, LL and HB, bit-equal to its plain version at n = 1..8
   × f32/bf16/f16/int32 × odd counts and 1 KiB–1 MiB a rank, over chains
   of 4 launches that alternate the protocols, and over 16 replays of
   each protocol captured in a CUDA graph;
   the ReduceScatter's LL and HB protocols each forced, and the op that
   picks one by bytes, bit-equal to the plain version on both sides of
   its threshold and at odd counts, n in {2, 4, 8}; the LL flag test (chained calls and a repeated ``step`` on one
   workspace); the main path — the collectives of serving qwen3-1.7b at
   TP=4 (a 57-AllReduce prefill of 8 × 16 tokens through 2PA, then
   decode steps of 57 1PA AllReduces and one ring logits AllGather),
   with every kernel's launches counted; and each kernel's device time
   at the serving sizes and over a per-rank size sweep at n=4, beside
   its HBM bound, its plain version and a one-call PyTorch yardstick
   (the ReduceScatter and the all-pairs AllGather each with both
   protocols forced, over a sweep that adds 64-512 KiB; the 1PA beside
   an empty kernel of its launch geometry, its own time without PDL and,
   at the decode size, its time behind qwen3-1.7b's o_proj matmul with
   and without PDL); the AllGather's
   LL and HB protocols each forced, and the op, bit-equal to the plain
   version on both sides of its threshold at odd counts, n in {2, 4, 8} x
   f32/bf16/f16/int32, and over back-to-back launches that alternate the
   protocols;
9. expert-parallel MoE — the all_to_all kernel (``csrc/alltoall.cu``)
   bit-equal to its plain version over n in {2, 4, 8} ×
   f32/bf16/int32 × the reference test's shapes, an odd count, the MoE
   dispatch sizes and back-to-back calls on one workspace; the main
   path — phi3.5-moe at full width, depth cut to 8 of its 32 layers
   (32 do not fit one 80 GB card), TP=EP=4 stacked on the card, 8
   requests of 16-token prompts then 32 greedy tokens in auto and
   explicit mode, by graph replay, each against the eager step on the
   same engine (first-step logits bit-equal, tokens equal): explicit
   runs on the executor kernel with exactly 3L + 2 = 26 launches per
   step (embedding and attention AllReduces, dispatch and combine
   all_to_all per layer, logits AllGather; captured, eager, and by the
   profiler over 4 replays) and
   matches auto's first-step logits within the bf16 tolerance with the
   routing pinned to auto's; unpinned, at most 2 of 8 rows route a
   token elsewhere, each first at a router near-tie that bf16 rounding
   explains, and the other rows hold the tolerance; f32 at
   full width, 2 layers: explicit and auto greedy tokens equal over 16
   steps; one full-width MoE layer through ``ops.all_to_all`` bit-equal
   to the same layer through the plan, then 4 decode steps' worth of
   those layers (64 kernel launches, counted); and the kernel's device
   time at the MoE sizes and over the per-rank sweep at n=4;
10. full-sequence prefill — the flash-attention kernel
   (``csrc/flash_attention.cu``) against its plain version within the
   reference's tolerances (f32 2e-5, bf16 3e-2) and a relative L2 error
   of 1e-5 (f32) or 1e-2 (bf16) over the reference tests' grid, ragged
   s, grouped KV heads, head dims 32, 80, 96 and 256 and the main path's
   shapes;
   the main path — ``make_prefill_step`` and ``forward`` of qwen3-1.7b
   (8 x 2048 tokens), gemma3-12b (2 x 4096, all 48 layers, 40 of them
   windowed), hubert-xlarge (4 x 1024 float frames) and hymba-1.5b (4 x
   2048, its published 25 query heads over 5 KV heads: a GQA group of 5
   at head dim 64, window 1024 on all 32 layers, each beside its SSM
   branch) at full width and
   depth on seeded random bf16 weights, each exactly one kernel launch
   per layer and no plain-core call, within a relative L2 error of 0.05
   of the same forward with the plain core, the first layer's core
   within 1e-2 on its own inputs, and two controls in plain torch (the
   kernel's rounding inside both limits, a skipped key tile past 1e-2);
   hymba-1.5b's first-layer SSM scan on the forward's own input against
   the sequential recurrence on the same (dA, dBx), the final state
   within 1e-5 and the output within 1e-2 (relative L2), and that
   layer's SSM branch, its scan alone and its flash launch timed side by
   side;
   qwen3-1.7b's fused prefill against the engine's token by token (8 x
   128 tokens, through its CUDA graph; bf16 within 0.05, f32 at 4 layers
   within 1e-4 with equal argmax); and the kernel's device and wall time
   at each main-path
   shape beside its bound, its plain version and
   ``scaled_dot_product_attention`` (and its factor against that);
11. hierarchical 2PH and AllGather-matmul — the 2PH AllReduce kernel
   (``csrc/allreduce_2ph.cu``) bit-equal to its plain version over
   (nodes, local) in {(2, 2), (2, 4), (4, 4)} x rows a chunk in {1, 8,
   37} x cols in {1, 128, 2048} x f32/bf16, and at 1031 x 2048 a chunk
   (several sub-tiles a block), each case two calls back to back;
   the AllGather-matmul kernel (``csrc/collective_matmul.cu``) within a
   relative L2 error of 1e-5 (f32 out) or 1e-2 (bf16 out) of its plain
   version over n in {2, 4, 8} x rows in {2, 64, 4096} x K in {128, 2048}
   x F in {128, 512, 1536} x shared and per-rank w x (bf16 -> f32, bf16
   -> bf16, f32 -> f32), at both sides of the bf16 regime threshold (n
   rows = 64) with K and F off the tile sizes, and two calls in a row;
   every bf16 -> bf16 result also bit-equal to the kernel's own f32 out
   rounded to bf16 (one main loop, two epilogues: a fault in the bf16
   epilogue's staging shows there, however few rows it touches); a
   fault control of each
   in plain torch, past its gate; on integer payloads at 2 x 4 and 4 x 4,
   the hierarchical plan replay loaded from its exported JSON, the 2PH
   kernel, the flat nn*L plan and the plain sum bit-equal; the main path
   — qwen3-1.7b's whole gradient as the explicit trainer hands it to the
   hierarchical AllReduce (14 leaves, bf16, 3.78 GiB a rank) on 2 nodes x
   4 local ranks, through the loaded plan set (3 executor launches a
   replay) and through ``ops.all_reduce(algo="2ph")`` (one launch a
   leaf), each within a relative L2 error of 1e-2 of the f64 sum, the
   plan replay bit-equal to the same plan files on ``TorchExecutor`` and
   the kernel to its plain version; then the AllGather-matmul at
   qwen3-1.7b's TP=4 projection shapes (prefill and decode into the
   w_gate and wq column shards, bf16 in, bf16 and f32 out, the bf16 out
   bit-equal to the f32 out rounded); and each
   kernel's device time per leaf or shape beside its bound, its plain
   version and a one-call PyTorch yardstick, the plan replay's time, the
   bytes the 2PH kernel moves by its own count and the rate they imply,
   the device memory one 2PH call allocates, and the main path's peak
   device memory.

12. hybrid attention+SSM — hymba-1.5b at full width and depth (32
   layers, d_model 1600, head_dim 64, SSM state 16, window 1024 on
   every layer, vocab 32001, seeded random bf16 weights) with its 25/5
   heads padded to 40/8 (``pad_heads_to``: 25 do not divide over 4
   ranks; 40 is the least count that does and keeps the group of 5),
   TP=4 stacked on the card: 8 requests of 16-token prompts then 32
   greedy tokens in auto, explicit, auto-int8 and explicit-int8, each by
   graph replay against the eager step on one engine (first-step logits
   bit-equal, tokens equal). Explicit runs 3 layer-AllReduce replays a
   layer (attention, SSM, MLP; 32001 divides no axis of 4, so the
   embedding and unembedding stay replicated): 96 executor launches
   captured, 96 a step eager and 96 a replay by the profiler over 4
   replays. Explicit against auto's first-step logits within the bf16
   tolerance with both caches; the int8 cache within the reference's bar
   of the bf16 cache; 4 layers in f32: explicit and auto greedy tokens
   equal over 16 steps; one temperature run (T 0.8, seed 7, explicit)
   drawing the same tokens by graph replay and eager, with the draw's
   device and wall time; auto on the published 25 heads beside the
   padded config; ms/token of every run and the peak device memory.

13. the serving stack — qwen3-1.7b at full width and depth, TP=4
   stacked on the card, served by the ``Scheduler`` (8 slots, chunks of
   4, fused prefill over ``prefill_seq_buckets=(16, 64, 256)``) in
   explicit and auto mode: trace A (32 requests, Poisson arrivals, Zipf
   prompts up to 512 tokens, every third at T = 0.8) and trace B (24
   requests over 2 shared 256-token prefixes, T = 0.8) through
   ``build_replicas(n_replicas=2)`` from one exported plan set, warm (a
   prefix cache a replica) and cold; phi3.5-moe (2 layers), hymba-1.5b
   (4 layers) and qwen3-1.7b in f32 (4 layers), 8 requests each. Every
   decode tick replays its slot bucket's CUDA graph (1, 2, 4, 8: 58
   executor launches each, cooperative, and 58 a replay by the
   profiler), every fused prefill micro-step runs eagerly and launches
   57. Gates: every request done, none dropped; each bucket's replay
   bit-equal to the eager step on one state, a row bit-equal at one
   bucket whatever its co-residents; streams against the sequential
   run (bf16: parting only where the top-2 gap is under the stated
   margin, at least twice the measured cross-bucket logit difference;
   f32: equal), warm against cold to the same bar, explicit against
   auto's first-tick logits within the bf16 bar, two runs of the f32
   trace through a 2-replica router with the same routing, streams and
   virtual metrics, plan hits advancing at every bucket used, nothing
   degraded. Wall tokens/s, TTFT by the wall
   and in virtual seconds, graph ms a tick by bucket, eager ms a fused
   prefill step by (b, S), the temperature draw's ms a tick, the prefix
   hit rate and micro-steps warm and cold, the busy share over a window
   of ticks, and the peak device memory.

14. the collective API and its tuning loop — (a) every
   ``repro_torch.core.api`` collective (all_reduce, all_gather,
   reduce_scatter, all_to_all, broadcast) at n in {2, 4, 8}, 1 KiB,
   256 KiB and 16 MiB a rank, f32, bf16 and int32, on the executor
   kernel bit-equal to ``backend="torch"`` on the card; a repeated call
   a plan hit with exactly one executor launch; ``torch_native`` equal
   (int32, the moving collectives) or within the fold bound (two folds'
   rounding, half an ulp an add), its device µs beside the plan's at n =
   4; (b) ``api.tree_all_reduce`` over qwen3-1.7b's whole parameter tree
   (bf16, 4 ranks stacked, seeded random leaves): one executor launch,
   every leaf within the fold bound of its f32 sum and equal on every
   rank, at 4 layers bit-equal to the plain version, its device ms beside
   its HBM bound and ``torch_native``'s, and the peak memory; (c) every
   registry candidate of all_reduce, all_gather and reduce_scatter at n
   = 4, O0 and O2, bf16, 4 KiB / 64 KiB / 1 MiB / 16 MiB a rank, traced
   on the card (``ExecutionPlan.capture_trace``: the executor kernel's
   traced instantiation stamps every op of every block): traced output
   bit-equal to the untraced, every event complete >= issue, every
   block's stamps forward, no wait ending more than one tick of
   ``%globaltimer`` before its puts; the timer's tick and the SM clock
   printed, and which of ``%globaltimer`` and ``clock64()`` each trace
   used; untraced and traced device µs by CUDA events; (d)
   ``selector.fit_from_traces`` over the three smaller sizes: the
   card's ``LinkModel`` (a degenerate fit fails the phase), each 16 MiB
   trace replayed under it and every other candidate predicted from it
   (``simulate.whatif``) beside its measured µs (reported, not gated);
   (e) at qwen3-1.7b's ``layer_allreduce`` and ``logits_allgather``,
   phi3.5-moe's top ``moe_alltoall`` bucket, hymba-1.5b's AllReduce and
   (c)'s points, the algorithm ``choose`` picks under ``UNFITTED``, under
   the fitted link, by ``TuningTable.from_traces`` (O2 traces), and the
   fastest candidate by CUDA events; (f) qwen3-1.7b explicit at full
   width, 4 layers, ``ServeConfig(trace=True)`` against ``trace=False``:
   a device trace for every plan in ``plan_report()["trace"]``, recorded
   at the warm-up steps before the capture; each graph holding only
   untraced executor nodes, each cooperative; tokens equal.

15. the robustness layer — qwen3-1.7b at full width and depth, TP=4
   stacked on the card, bf16: (a) an explicit engine with every guard
   armed (``guard_numerics=True, plan_timeout_s=30``), and each guard
   alone, against the same engine unguarded: explicit, every counter 0,
   the same graph (58 executor nodes, each cooperative, none traced),
   tokens equal and first-step logits bit-equal; ms/token of each over
   interleaved decode loops, and the guards' own host costs apart (the
   ``isfinite`` read over 8 x 151936 logits, the watchdog's handoff);
   (b) each runtime fault fired at the explicit engine's capture:
   ``fail_call`` once retried (explicit, tokens equal to the clean
   explicit run's), and ``fail_call`` persistent, ``corrupt_chunk``
   under the numeric guard and ``stall_rank`` (5 s) past a 1 s watchdog
   each falling back at step 0: tokens and first-step logits bit-equal
   to a clean auto engine's, no executor node left, the stalled worker
   ending void and the cache as it was when it woke; the fallback's peak
   memory; (c) a fault in an eager fused prefill step after 3 ticks of
   trace A's first 8 requests: one fallback, the router naming the
   replica, streams against the sequential run (f32 at 4 layers,
   qwen3-1.7b and hymba-1.5b: equal; bf16 at 28 layers: the stream bar
   at SERVE_TIE_MARGIN); (d) ``python -m repro_torch.launch.serve``
   in-process, explicit, 4 layers, the one-shot and the router path;
   (e) a planted build failure (a stand-in ``nvcc``), a launch the
   runtime refuses (more blocks a rank than the card keeps resident: a
   real non-zero ``cudaError_t``), a planted CUDA error and the
   capture's node check planted one short, each propagating out of the
   engine (and the first three out of a scheduler) with every counter
   at 0. Phases 4, 9, 12 and 13 also fail when a
   served engine or scheduler ends in another mode than it was asked
   for, or with a guardrail counter moved.

16. the data-parallel trainer — qwen3-1.7b at full width and depth (28
   layers, seeded random bf16 weights, 14 leaves, 2.03 G parameters)
   through ``train.loop.run`` on a fixed batch of 8 x 256 tokens from
   ``SyntheticLM``, 8 steps of AdamW (total 8, warmup 1), in auto,
   explicit on a 2 x 4 grid (every gradient leaf through the
   hierarchical 2PH plans: 3 executor launches a leaf) and explicit
   flat DP 4 (one AllReduce plan a leaf), each mode's state freed before
   the next. Gates: every loss finite; auto's loss falls by at least 0.5
   (a control at lr = 0 must not); each explicit mode within the stated
   bars of auto's losses and pre-clip gradient norms, step by step, with
   two fault controls in plain torch past them (rank 0's gradient
   dropped; the sum not divided by ndp); executor launches exactly 3 x
   14 and 14 a step, no library kernel (``kernels/ops``, flash
   attention) launched; step 0's reduced gradient leaf by leaf bit-equal
   to the same axes' plans on ``TorchExecutor`` on the card, every
   rank's copy bit-equal to rank 0's on the 2 x 4 grid (within the fold
   bound on DP 4, where a 1PA plan folds each rank's sum from its own
   buffer); at full width, 4 layers in f32 over 6 steps, each explicit
   mode's losses within ``rtol 2e-3, atol 1e-4`` of auto's; at full
   width, 4 layers, a checkpoint restart (4 steps saved, restored, run
   to 8) under
   ``torch.use_deterministic_algorithms(True, warn_only=True)``, params
   and optimizer state bit-equal to the uninterrupted run's; and ``python
   -m repro_torch.launch.train --arch qwen3-1.7b --reduced --mode
   explicit`` in-process. Printed: ms a step by part (forward+backward
   a rank, the step's whole reduction, its plan replays alone beside
   their bound, their plain and one-call yardsticks and phase 11's plan
   replays, the update), each part by its clock (device, or wall where
   the host held the device back) with the host syncs one call of it
   made, training tokens/s, the busy share of one profiled 2 x 4 step,
   the peak device memory of each mode.

17. the rwkv6 family in auto mode (the reference serves it so) —
   rwkv6-7b at full width (32 layers, d_model 4096, d_ff 14336, vocab
   65536, 64 heads of 64, untied, 7.5 G parameters, seeded random bf16
   weights): (a) an engine of 8 rows, 16-token prompts then 32 greedy
   tokens by graph replay and eagerly on the same engine (first-step
   logits bit-equal, tokens equal), no executor launch, ms/token by the
   stream's and the device's clock beside the step's byte bound (every
   weight read once, the recurrent state read and written once), the
   kernels a step and the busy share; (b) at full width, 4 layers, in
   f32, the graph's logits at every position of the prompts fed token
   by token within a relative L2 error of 1e-4 of ``forward``'s, (d)'s
   trace through the scheduler with streams equal to the sequential
   run's (a compaction that moves no state parting from them), and the
   same weights in bf16 within 0.05 of them; (c) at 4 layers, explicit
   asked for at TP=4: the warning "falling back to auto", the engine in
   auto with one fallback counted and its decode plans compiled, never
   replayed (as the reference's), tokens and
   first-step logits equal to an auto engine's (the one engine that ends
   in another mode than asked, on purpose); (d) the ``Scheduler`` over
   the full model, 8 slots, 8 requests (Poisson 4/s, prompts of 16 to
   128 tokens, every third at T = 0.8) prefilled token by token through
   the slot-bucket graphs, fused prefill asked for and off, a prefix
   cache given and none held: nothing dropped, each bucket's replay
   bit-equal to the eager step, a row bit-equal whatever its
   co-residents, wall tokens/s and TTFT, the streams against the
   sequential run reported beside the cross-bucket drift one prompt
   gathers in the recurrent state (bucket 1 against 8, in bf16 at 32
   and 4 layers and in f32), not gated in bf16;
   (e) ``forward`` at 2 x 1024 tokens, full depth, bf16: ms and tokens/s,
   and at 4 layers the WKV loop's share of the device time (profiled)
   and of the wall; (f) the trainer at full width, 4 layers, the fixed 8
   x 256 batch, 4 AdamW steps, auto and explicit DP 4: losses finite,
   auto's falling, DP 4 within phase 16's bars of auto's losses and grad
   norms, 24 executor launches a step (one a gradient leaf) and no
   library kernel, step 0's reduction bit-equal to the same plans on
   ``TorchExecutor``; ms a step by part and clock, tokens/s and the
   peak memory of each mode.
18. FSDP and the dry run. (a) The explicit FSDP trainer
   (``distributed/fsdp.py``) at full width: qwen3-1.7b, 28 layers, bf16,
   phase 16's fixed 8 x 256 batch, 4 AdamW steps on DP 8 (28 groups do
   not divide, so every large leaf's ``d_model`` is sharded: all-gathers
   and reduce-scatters) and on DP 4 (each rank owns 7 whole groups:
   broadcasts and all-reduces), beside auto's 4 steps. Gates: losses and
   grad norms within phase 16's bars of auto's (0.02, 2 %); every
   gathered group (each rank's copy) and the gathered embedding
   bit-equal to the unsharded leaves; every plan call of step 0 bit-equal
   to the same plan on ``TorchExecutor``; the executor's launches a step
   (counted from 0 just before the steps) equal to
   ``FsdpLayout.predicted_launches``; no library kernel. The step's ms by
   part, each by its clock (the wall; the gathers', reductions' and
   AdamW's device ms by CUDA events; the rank passes as the wall's
   residual), the device-busy ms of one more step under
   ``torch.profiler``, and the peak memory beside phase 16's DP 4. (b)
   The dry run held against the card, on phase 4's explicit decode step
   (TP 4, batch 8, at position 1023) and on (a)'s DP 8 step: the dry run
   (``roofline/op_stats.py`` on fake tensors, traced in this process on
   the CPU after the card's runs, about a minute and a half) traces the
   same step, every rank stacked as the card runs them; its peak's
   growth over the step's inputs against
   ``torch.cuda.max_memory_allocated``'s (within 1 %), its FLOPs beside
   ``model_flops``, and the larger of its compute and memory terms at
   the H100's datasheet rates over the measured device ms (the decode
   step's CUDA graph replay, behind a device sleep that must cover the
   enqueue; the train step's summed kernel time under the profiler),
   which must read at most 1.05 (one card has no NVLink: no collective
   term).
19. the channels and the examples. (a) The channel layer's device side
   (``csrc/channels.cuh`` through ``kernels/channels.py``): the
   ``PortChannel`` put (TMA bulk copies issued by one thread a block)
   and the ``FusedReduceChannel`` all-reduce, bit-equal to their plain
   models (``core/channels.py``) at n in {2, 4, 8} x f32/bf16/int32 x
   1 KiB, 64 KiB, 1 MiB and 16 MiB a rank (1 KiB and 1 MiB also one
   element short: odd counts, unaligned ranks); their path, 16 launches
   back to back alternating the two (counted from 0 just before, read
   just after), each held; each captured once in a CUDA graph and
   replayed 16 times on fresh inputs (f32, bf16), each replay held; µs a
   launch at every n and size (bf16) beside the HBM bound (input read
   once, output written once), one PyTorch call (``index_select`` into
   ``out``; ``x.sum(0)`` expanded) and the plain model; and, reported
   only, a bf16 8192^3 GEMM's µs on a second stream alone and beside a
   stream of 16 MiB-a-rank puts through the PortChannel and through the
   SM copy (``msccl::put``). (b) Every ``examples_torch/*.py`` in-process
   through its ``main(argv)`` at the reference's sizes (train_llm's step
   count cut): custom_collective, quickstart, communicator and
   hierarchical with the executor kernel bit-equal to the plain
   executor (communicator's reloaded plan bit-identical; hierarchical's
   integer sum exact in 3 launches a replay); profile_plan's three
   traced ring plans' event counts equal to the CPU capture's of the same
   plans (its 1PA serving-surface trace's counts reported: the kernel
   emits one put a peer, the plain executor one a fan-out round); serve_llm
   at 32 tokens in explicit and auto, f32 tokens equal, each by CUDA
   graph with its compiles flat across decode; prefix_serve (16
   requests) warm and cold bit-identical to the sequential baseline with
   prefix hits; train_llm (llama-100m, DP 2) 10 steps explicit and auto,
   losses falling, explicit within phase 16's bars of auto and one plan
   compile a gradient shape. Each example's executor and library
   launches are printed; each must have launched a kernel. The phase
   prints its seconds.

The last lines are the card's nvidia-smi line, one ``{"kernels": [...]}``
JSON object, and ``{"ok": true, "device": {...}}``. The whole record,
the kernels line among it, also goes to ``chiprun_out/chip_smoke.json``.
The kernels line holds one entry per kernel. The executor's times are
the launch-weighted mean of the main paths' decode mixes, each path's
own under ``by_path`` (qwen3-1.7b, phi3.5-moe and hymba-1.5b, and with
phase 13 the serving path, weighted by the kernels each of its buckets
ran; with phases 16 and 17 the trainers', each mode's plan replays a
step over its launches a step, kept out of the mean) and every shape's under ``per_shape``; its
``launches`` are the wrapper's over the main paths (the engines'
warm-up steps and captures), ``launches_profiled`` the executor kernels
that the profiler counted over ``replays_profiled`` later replays of
the same graphs; its group
view on phase 11's hierarchical replays is an entry of its own
(``dsl_executor_group_view``: the replays' times over their launches,
each leaf's replay under ``per_shape``); flash
attention's are the mean over the layers of one forward of each phase-10
model, every shape's under ``per_shape``; the channel entry points'
(phase 19, ``port_put`` and ``fused_reduce``, which replace no TPU
kernel: ``replaces`` names the reference class they carry) at n = 4,
16 MiB a rank, bf16, every timed shape under ``per_shape``, their
``launches`` those of phase 19's back-to-back chain; the other kernels'
per-shape times are in the phase lines.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100's datasheet rates (dense bf16 peak, device memory), one source
# for every phase's bound and the dry run's roofline
from repro_torch.roofline.analysis import (  # noqa: E402
    BF16_FLOPS_PER_S, HBM_BYTES_PER_S)
ARCH = "qwen3-1.7b"
TP = 4
BATCH, PROMPT, DECODE = 8, 16, 32
MAX_KV = 1024
# bf16 first-step logits, explicit vs auto: TP partials are rounded to
# bf16 and summed in the plan's order, auto accumulates each matmul once
BF16_REL_TOL = 0.05                # ||explicit - auto|| / ||auto||
# the int8 KV cache against the bf16 cache, the reference's bar
# (tests/test_kv_quant.py): max abs error over max abs, argmax agreement
INT8_REL_TOL, INT8_ARGMAX_AGREEMENT = 0.05, 0.5
# phase 3: replays of each decode plan's capture, eager calls between
GRAPH_REPLAYS = 16
# MoE in bf16: at most this many of the batch's rows may route a token
# to other experts than auto (each at a router near-tie, see
# _moe_first_step)
MAX_REROUTED_ROWS = BATCH // 4
KERNEL_SOURCE = "src/repro_torch/csrc/executor.cu"
REPLACES = "src/repro/core/executor.py:702"
# phase 8: the collective library's kernels -> (source, TPU kernel body)
COLLECTIVES = {
    "all_reduce_1pa": ("src/repro_torch/csrc/allreduce_1pa.cu",
                       "src/repro/kernels/allreduce_1pa.py:35"),
    "reduce_scatter_2pa": ("src/repro_torch/csrc/allpairs_2pa.cu",
                           "src/repro/kernels/reducescatter_2pa.py:33"),
    "all_gather_2pa": ("src/repro_torch/csrc/allpairs_2pa.cu",
                       "src/repro/kernels/reducescatter_2pa.py:65"),
    "all_gather_ring": ("src/repro_torch/csrc/allgather_ring.cu",
                        "src/repro/kernels/allgather_ring.py:27"),
}
# (op, kwargs, kernels it launches, whether a rank's input holds one
# chunk per rank: n times the chunk's rows)
COLLECTIVE_OPS = (
    ("all_reduce", dict(algo="1pa"), ("all_reduce_1pa",), False),
    ("all_reduce", dict(algo="1pa", use_ll=False), ("all_reduce_1pa",),
     False),
    ("all_reduce", dict(algo="2pa"), ("reduce_scatter_2pa",
                                      "all_gather_2pa"), True),
    ("reduce_scatter", {}, ("reduce_scatter_2pa",), True),
    ("all_gather", dict(algo="ring"), ("all_gather_ring",), False),
    ("all_gather", dict(algo="allpairs"), ("all_gather_2pa",), False),
)
# tests/test_kernels_collectives.py's shapes and an odd bf16 count
GRID_SHAPES = ((8, 128), (16, 256), (8, 384), (3, 129))
MAIN_DECODE_STEPS = 4
# profiles of a graph's replays taken at most until one holds every
# executor kernel (_profile_graph)
PROFILE_TRIES = 4
# per-rank input sizes of the timing sweep at n=4, bf16 (rows, cols); 1PA
# stops at 1 MiB, only the AllGathers go to 64 MiB
SWEEP = {"1KiB": (4, 128), "32KiB": (8, 2048), "1MiB": (256, 2048),
         "16MiB": (4096, 2048), "64MiB": (16384, 2048)}
# the ReduceScatter's and the all-pairs AllGather's sweeps add sizes around
# where their two protocols (kernels/reducescatter_2pa.py:rs_protocol,
# ag_protocol) cross, and time each forced
RS_SWEEP = {"64KiB": (16, 2048), "128KiB": (32, 2048),
            "256KiB": (64, 2048), "512KiB": (128, 2048)}
# phase 9: expert-parallel MoE decode. Full width; the depth is cut to
# 8 of phi3.5-moe's 32 layers: one layer holds about 1.30 G parameters
# (2.60 GB in bf16), so 32 layers and the embeddings (about 84 GB) do
# not fit one 80 GB card, and the auto and rank-stacked explicit copies
# of 8 layers take about 43 GB together
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS, MOE_F32_LAYERS = 8, 2
A2A_SOURCE = "src/repro_torch/csrc/alltoall.cu"
A2A_REPLACES = "src/repro/kernels/alltoall.py:26"
# phase 10: full-sequence prefill through the flash-attention kernel
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:37"
# kernel vs plain version: the reference test's tolerances (atol = rtol)
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# and a scale-free one, ||got - want|| / ||want||, at every case and on
# each model's own layer inputs: the late rows of a long softmax average
# many keys and are small, so an absolute tolerance sized for the early
# rows would pass a fault that touches only late rows
FA_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# the control fault: for the second half of the queries, the key tile of
# this many keys holding the first key in reach is skipped (a ``lo`` off
# by one tile, touching only late rows)
FAULT_TILE = 64
# arch -> (batch, tokens) of its prefill; full width and depth, bf16
PREFILL = {"qwen3-1.7b": (8, 2048), "gemma3-12b": (2, 4096),
           "hubert-xlarge": (4, 1024), "hymba-1.5b": (4, 2048)}
# the kernel's forward against the same forward with the plain attention
# core (the reference's chunked online softmax): bf16 activations, f32
# softmax in both, P rounded to bf16 only in the kernel
PREFILL_REL_TOL = 0.05
# models whose forward gates are held layer-pinned (_pinned_forward), their
# unpinned readings recorded: random-weight hymba-1.5b, where bf16 rounding
# alone (the rounding control in plain torch) read 0.250 end to end on an
# NVIDIA H100 80GB HBM3 at 700 W. Every other model is held unpinned
PREFILL_LAYER_PINNED = frozenset({"hymba-1.5b"})
# fused prefill against the engine's token by token (auto mode)
FUSED_BATCH, FUSED_TOKENS = 8, 128
FUSED_F32_LAYERS, FUSED_F32_TOL = 4, 1e-4
PREFILL_REPEATS = 3
# phase 11: the hierarchical 2PH AllReduce and the AllGather-matmul
AR2PH_SOURCE = "src/repro_torch/csrc/allreduce_2ph.cu"
AR2PH_REPLACES = "src/repro/kernels/allreduce_2ph.py:36"
AGMM_SOURCE = "src/repro_torch/csrc/collective_matmul.cu"
AGMM_REPLACES = "src/repro/kernels/collective_matmul.py:41"
# kernel vs plain grids: 2PH (nodes, local), rows a chunk, cols; the
# AllGather-matmul's n, rows a rank, K, F
HIER_GRIDS = ((2, 2), (2, 4), (4, 4))
HIER_ROWS, HIER_COLS = (1, 8, 37), (1, 128, 2048)
# and at each grid, 2PH chunks of this many rows of 2048 (odd) whose tile a
# block splits into several sub-tiles (phase 2 of one behind phase 1 of the
# next): the grid's chunks give each block one
HIER_SUBTILED_ROWS = 1031
AGMM_GRID = dict(n=(2, 4, 8), rows=(2, 64, 4096), k=(128, 2048),
                 f=(128, 512, 1536))
# the bf16 kernel's two regimes (kernels/collective_matmul.py:regime) on
# both sides of n * rows = 64, with K and F that are not multiples of the
# 64-deep k-tiles or the 64- and 256-wide column tiles: (n, rows, K, F)
AGMM_EDGES = ((4, 16, 136, 72), (4, 17, 136, 72), (2, 32, 200, 200),
              (2, 33, 200, 200), (8, 8, 2048, 1544), (8, 9, 2048, 1544))
HIER_NN, HIER_L = 2, 4                  # the main path: the reference's mesh2x4
# every leaf through the plan and the kernel, against the f64 sum: bf16
# wire values, each add rounded to bf16 in the fold
LEAF_REL_TOL = 1e-2
FAULT_LEAF = "ln_attn"
# kernel vs plain: the same f32 accumulation in another order (f32 out);
# and the f32 result rounded to bf16 (bf16 out)
AGMM_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
AGMM_PREFILL_TOKENS = 8 * 2048          # phase 10's qwen3-1.7b prefill
# phase 12: the hybrid attention+SSM family on the serving path, full
# width and depth. 25 query heads do not divide over 4 ranks: the
# reference's own answer is pad_heads_to (padded heads masked, exact
# math); 40 is the smallest count that divides over 4 and keeps the
# group of 5 (KV heads 5 -> 8). Every mode serves that one config, so
# explicit and auto compare the same weights; auto also serves the
# published 25 heads, which shows what the padding costs
HYBRID_ARCH = "hymba-1.5b"
HYBRID_PAD_HEADS = 40
HYBRID_F32_LAYERS = 4
# f32 at full depth: explicit vs auto first-step logits, relative L2
HYBRID_F32_TOL = 1e-3
SAMPLE_TEMPERATURE, SAMPLE_SEED = 0.8, 7
# phase 10's SSM scan on the first layer's inputs against the sequential
# recurrence on the same (dA, dBx): the final state in f32 (the scan's
# fold order alone differs), the bf16 output after the projections
SSM_STATE_REL_TOL, SSM_OUT_REL_TOL = 1e-5, 1e-2
# phase 13: the serving stack. qwen3-1.7b's serving config and traces
SERVE_SEQ_BUCKETS = (16, 64, 256)
SERVE_CHUNK = 4
# trace A, continuous batching (every third request at SERVE_HOT_T); trace
# B, shared prefixes, every request at a temperature
TRACE_A = dict(seed=0, n_requests=32, rate_rps=4.0, zipf_a=1.2,
               max_prompt=512, max_new=64, step_s=0.05)
TRACE_B = dict(seed=1, n_requests=24, prefix_pool=2, prefix_len=256,
               prefix_zipf_a=1.2, max_prompt=64, max_new=32,
               temperature=0.8)
SERVE_HOT_T = 0.8
# the other families' short runs (phi3.5-moe, hymba-1.5b, qwen3-1.7b f32)
TRACE_SHORT = dict(seed=2, n_requests=8, rate_rps=8.0, zipf_a=1.2,
                   max_prompt=128, max_new=16, step_s=0.05)
SERVE_SHORT_BUCKETS = (16, 64)
SERVE_MOE_LAYERS, SERVE_HYBRID_LAYERS, SERVE_F32_LAYERS = 2, 4, 4
# bf16 at full depth: a stream may part from the sequential run's only at
# a step whose top-2 logit gap (of the perturbed logits, at a
# temperature) is under this margin, just above twice the largest
# difference one row's logits show between slot buckets (0.0547 at
# buckets 1 and 2 against 8, 0 at 4, on the H100: PERF.md, PR 22); the
# run checks that bound on its own buckets
SERVE_TIE_MARGIN = 0.12
# the stream bar's planted control: trace A's first requests again, with
# a compaction that moves a slot without its cache row
SERVE_CONTROL_REQUESTS = 8
# rid offset of a second run of a trace on one scheduler
SERVE_RID = 100_000
# iterations of each executor timing in phase 13
SERVE_TIME_ITERS = 50
SERVE_PATH = f"{ARCH} serving"
# graph replays timed, and profiled, at each slot bucket
SERVE_REPLAYS, SERVE_PROFILED = 20, 2
# ticks of trace A's explicit run under the profiler (busy share)
SERVE_PROFILE_WINDOW = (40, 12)

# phase 14: the collective API and its tuning loop
API_N = (2, 4, 8)
API_SIZES = (1 << 10, 256 << 10, 16 << 20)         # bytes a rank
API_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
API_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter",
                   "all_to_all", "broadcast")
API_COLS = 256
API_TIME_ITERS = 20
TREE_TIME_ITERS = 3
TRACE_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter")
TRACE_SIZES = (4 << 10, 64 << 10, 1 << 20, 16 << 20)   # bytes a rank, bf16
TRACE_COLS = 512
TRACE_TIME_ITERS = 20
# phase 15: the robustness layer
CHAOS_COUNTERS = ("retries", "fallbacks", "faults_detected", "timeouts")
CHAOS_TIMEOUT_S = 30.0                  # the armed watchdog of (a), (e)
CHAOS_STALL = (1.0, 5.0)                # (b): watchdog timeout, stall (s)
CHAOS_TIME_ROUNDS, CHAOS_TIME_STEPS = 4, 32   # (a): timed decode loops
CHAOS_COST_ITERS = 200                  # the guards' own costs, apart
CHAOS_REQUESTS = 8                      # (c): trace A's first requests
CHAOS_FAULT_TICK = 3                    # (c): ticks before the fault
CHAOS_F32_LAYERS = 4                    # (c) f32, (d), (e) depth
CHAOS_LAUNCH_LAYERS = 4
CHAOS_REFUSED_BLOCKS = 4096             # (e): blocks a rank, never resident
# phase 16: the data-parallel trainer, qwen3-1.7b at full width and depth
# on a fixed batch of 8 x 256 tokens from SyntheticLM (seed 0), 8 steps
# of AdamW(total_steps=8, warmup_steps=1), in auto, explicit on a 2 x 4
# grid (hierarchical 2PH plans) and explicit flat DP 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 8
TRAIN_NODES, TRAIN_LOCAL, TRAIN_FLAT = 2, 4, 4
TRAIN_MODES = ("auto", "2x4", "flat4")
# auto's loss falls at least this much over the 8 steps (the reference
# test's bar over 20)
TRAIN_LOSS_DROP = 0.5
# explicit against auto, bf16: the largest |loss difference| over the 8
# steps, and the largest relative difference of the pre-clip gradient
# norm (clipping and Adam normalise the gradient's scale away, so a lost
# "/ ndp" shows in the norm, not in the loss). Measured on an NVIDIA H100
# 80GB HBM3 at 700 W: 0.0059 / 0.0070 (2 x 4), 0.0060 / 0.0080 (DP 4);
# the bars are over twice those, and the fault controls read 1.65 / 0.133
# (rank 0 dropped) and 0.0035 / 7.07 (no mean) (PERF.md §6)
TRAIN_LOSS_BAR = 0.02
TRAIN_GNORM_BAR = 0.02
# steps of each fault control (its step 0 already lands past a bar)
TRAIN_CONTROL_STEPS = 4
# f32 at full width, 4 layers, 6 steps: the reference test's bar
TRAIN_F32_LAYERS, TRAIN_F32_STEPS = 4, 6
TRAIN_F32_RTOL, TRAIN_F32_ATOL = 2e-3, 1e-4
# the checkpoint restart at full width, 4 layers: at 28 layers its three
# writes and one read of the 20 GB state took about 110 s of the phase
TRAIN_RESTART_AT, TRAIN_RESTART_LAYERS = 4, 4
TRAIN_TIME_ITERS = 2
TRAIN_PATH = "train"
# phase 17: the rwkv6 family in auto mode (the reference serves it so),
# rwkv6-7b at full width (32 layers, d 4096, d_ff 14336, vocab 65536, 64
# heads of 64, untied), seeded random bf16 weights
RWKV_ARCH = "rwkv6-7b"
# (b), (c) and (e)'s profile: the depth of the short runs
RWKV_SHORT_LAYERS = 4
# (b): f32 decode logits at every prompt position against forward's
# (the two order their matmul sums apart)
RWKV_F32_REL_TOL = 1e-4
# (d): 8 requests, Poisson 4/s, prompts uniform in 16..128 tokens, up to
# 16 new tokens, every third at SERVE_HOT_T
RWKV_TRACE = dict(seed=3, n_requests=8, rate_rps=4.0, zipf_a=1.2,
                  max_prompt=128, max_new=16, step_s=0.05)
RWKV_PROMPTS = (16, 128)
# (e): the forward's batch and sequence
RWKV_FORWARD = (2, 1024)
# (f): the trainer at full width, 4 of 32 layers, 4 steps, auto and DP 4
RWKV_TRAIN_LAYERS, RWKV_TRAIN_STEPS = 4, 4
RWKV_TRAIN_MODES = ("auto", "flat4")
# gradient leaves: 21 a layer, embed, ln_f, unembed
RWKV_LEAVES = 24
RWKV_TRAIN_PATH = f"{RWKV_ARCH} train"
# phase 18: the FSDP trainer (qwen3-1.7b at full width and depth, phase
# 16's fixed 8 x 256 batch, 4 AdamW steps) on DP 8, whose 28 groups do not
# divide so each leaf's d_model is sharded, and DP 4, where each rank owns
# 7 whole groups; the dry run held against the card on phase 4's explicit
# decode step and on the DP 8 step
FSDP_DP = (8, 4)
FSDP_STEPS = 4
FSDP_PATH = "fsdp train"
# a roofline time over the measured time past this is a wrong count
DRYRUN_SHARE_MAX = 1.05
# the dry run's peak growth over a step's inputs against the card's
# (torch.cuda.max_memory_allocated): the card adds the caching
# allocator's rounding and the plans' flag words
DRYRUN_PEAK_REL_TOL = 0.01

RECORD: dict = {}


def emit(phase: str, **kw) -> None:
    RECORD[phase] = kw
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------
def device_ms(fn, iters: int) -> tuple[float, bool]:
    """Device milliseconds per call of ``fn``: the calls are enqueued
    behind a device sleep long enough to cover the host's enqueue time,
    so the events between them see device execution only. Returns
    (ms per call, whether the sleep covered the enqueue)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    s0 = torch.cuda.Event(enable_timing=True)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    s0.record()
    torch.cuda._sleep(int(host_s * 3.0 * 2.0e9) + 2_000_000)
    e0.record()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t) * 1e3
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters, enqueue_ms < s0.elapsed_time(e0)


def wall_ms(fn, iters: int) -> float:
    """Milliseconds per call back to back (host enqueue included)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import build
    t = time.perf_counter()
    libs = build.build_all()
    build.executor_library()
    build.allreduce_1pa_library()
    build.allpairs_2pa_library()
    build.allgather_ring_library()
    build.alltoall_library()
    build.flash_attention_library()
    build.allreduce_2ph_library()
    build.collective_matmul_library()
    build.channels_library()
    build.spans_library()
    ptxas = [ln.strip() for b in build.last_build.values()
             for ln in b["log"].splitlines() if "registers" in ln]
    # the bf16 products of the AllGather-matmul and of flash attention:
    # wgmma (HGMMA) fed by TMA (UTMALDG), and no mma.sync (HMMA) left
    sass = {}
    for lib in ("collective_matmul", "flash_attention"):
        text = subprocess.run(
            [str(pathlib.Path(build.nvcc()).parent / "cuobjdump"), "-sass",
             str(libs[lib])], capture_output=True, text=True, check=True,
            timeout=300).stdout
        sass[lib] = {op: len(re.findall(rf"\b{op}\b", text))
                     for op in ("HGMMA", "UTMALDG", "HMMA")}
    # ptxas's notes where it serialises a library's wgmmas (C7510 a call,
    # C7513 a register a pending wgmma reads written early, C7520 a branch
    # it cannot prove warp-uniform); a cached library has no log
    serialized = {lib: sorted(set(re.findall(r"\((C75\d\d)\) Potential",
                                             b["log"])))
                  for lib, b in build.last_build.items() if b["log"] != "cached"}
    emit("build", seconds=round(time.perf_counter() - t, 3),
         libraries=sorted(str(p.relative_to(ROOT)) if p.is_relative_to(ROOT)
                          else str(p) for p in libs.values()),
         ptxas=ptxas, collective_matmul_sass=sass["collective_matmul"],
         flash_attention_sass=sass["flash_attention"],
         wgmma_serialized=serialized)
    for lib, ops in sass.items():
        check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0 and ops["HMMA"] == 0,
              f"{lib} SASS: {ops} (want HGMMA and UTMALDG, no HMMA)")
    _check_1pa_build(libs["allreduce_1pa"], build)
    _check_channels_build(libs["channels"], build)


# the cluster 1PA's SASS: cluster barriers (UCGABAR_*), the multicast bulk
# copy (UBLKCP.S.G.MULTICAST) and its mbarrier wait (SYNCS.PHASECHK), the
# packets' 8-byte stores into peers' shared memory (ST.E.64*), and PDL's
# griddepcontrol.wait / launch_dependents (ACQBULK / PREEXIT)
AR1PA_SASS = {"UCGABAR_ARV": r"UCGABAR_ARV", "UCGABAR_WAIT": r"UCGABAR_WAIT",
              "UBLKCP.S.G.MULTICAST": r"UBLKCP\.S\.G\.MULTICAST",
              "SYNCS.PHASECHK": r"SYNCS\.PHASECHK\S*",
              "ST.E.64": r"ST\.E\.64\S*", "ACQBULK": r"ACQBULK",
              "PREEXIT": r"PREEXIT"}


def _check_channels_build(path, build):
    """The channels library's PortChannel put is a TMA bulk copy: its
    SASS holds the bulk copies (UBLKCP, shared <-> global) and their
    mbarrier waits (SYNCS.PHASECHK)."""
    text = subprocess.run(
        [str(pathlib.Path(build.nvcc()).parent / "cuobjdump"), "-sass",
         str(path)], capture_output=True, text=True, check=True,
        timeout=300).stdout
    ops = {op: len(re.findall(pat, text))
           for op, pat in (("UBLKCP", r"UBLKCP\S*"),
                           ("SYNCS.PHASECHK", r"SYNCS\.PHASECHK\S*"))}
    emit("build_channels", sass=ops)
    check(all(ops.values()), f"channels SASS: {ops} (want bulk copies "
          f"and their mbarrier waits)")


def _check_1pa_build(path, build):
    """The 1PA library holds cluster barriers, the multicast bulk copy,
    the packet stores and PDL in SASS; its source makes no cooperative
    launch; ptxas's registers and stack for each of its kernels."""
    text = subprocess.run(
        [str(pathlib.Path(build.nvcc()).parent / "cuobjdump"), "-sass",
         str(path)], capture_output=True, text=True, check=True,
        timeout=300).stdout
    ops = {name: len(re.findall(rf"\b{rx}", text))
           for name, rx in AR1PA_SASS.items()}
    src = re.sub(r"//[^\n]*", "", (ROOT / COLLECTIVES["all_reduce_1pa"][0])
                 .read_text())
    cooperative = len(re.findall(r"launch_cooperative|"
                                 r"cudaLaunchCooperativeKernel", src))
    # "Compiling entry function 'name'" ... "Used N registers, ..." a kernel
    log = build.last_build["allreduce_1pa"]["log"]
    kernels = dict(re.findall(r"Compiling entry function '(\S+)'.*?"
                              r"ptxas info\s*: (Used [^\n]*)", log, re.S))
    emit("build_1pa", sass=ops, cooperative_launches_in_source=cooperative,
         ptxas=kernels)
    check(all(ops.values()) and cooperative == 0,
          f"1PA SASS {ops}, cooperative launches in its source "
          f"{cooperative} (want every op, no cooperative launch)")


def _decode_plans(device):
    """qwen3-1.7b's decode plans at TP 2 and 4 (batch_local 8), on the
    kernel backend."""
    from repro_torch import configs
    from repro_torch.core.comm import Communicator
    from repro_torch.distributed.step import compile_decode_plans
    cfg = configs.get_config(ARCH)
    out = {}
    for tp in (2, TP):
        comm = Communicator("model", n=tp, device=device)
        out[tp] = compile_decode_plans(cfg, comm, batch_local=BATCH, tp=tp)
    return out


def _moe_cfg(n_layers: int, dtype: str = "bfloat16"):
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(MOE_ARCH),
                               n_layers=n_layers, dtype=dtype)


def _moe_plans(device):
    """phi3.5-moe's decode plans at TP 2 and 4 (batch_local 8; the
    ``moe_alltoall`` family over capacity buckets of 2·b tokens per
    expert), on the kernel backend."""
    from repro_torch.core.comm import Communicator
    from repro_torch.distributed.step import compile_decode_plans
    cfg = _moe_cfg(MOE_LAYERS)
    return {tp: compile_decode_plans(
        cfg, Communicator("model", n=tp, device=device),
        batch_local=BATCH, tp=tp) for tp in (2, TP)}


def _hybrid_cfg(n_layers=None, dtype="bfloat16", pad=HYBRID_PAD_HEADS):
    """hymba-1.5b with its heads padded to ``pad`` (0: the published
    25), at ``n_layers`` (default: all 32) and ``dtype``."""
    from repro_torch import configs
    cfg = configs.get_config(HYBRID_ARCH)
    return dataclasses.replace(cfg, pad_heads_to=pad, dtype=dtype,
                               n_layers=n_layers or cfg.n_layers)


def _hybrid_plans(device):
    """hymba-1.5b's decode plans at TP 2 and 4 (batch_local 8): the layer
    AllReduce alone (its vocab of 32001 divides neither axis, so no
    logits AllGather), on the kernel backend."""
    from repro_torch.core.comm import Communicator
    from repro_torch.distributed.step import compile_decode_plans
    cfg = _hybrid_cfg()
    return {tp: compile_decode_plans(
        cfg, Communicator("model", n=tp, device=device),
        batch_local=BATCH, tp=tp) for tp in (2, TP)}


def phase_kernel_vs_plain(device, gen):
    from repro_torch.core import algorithms, passes
    from repro_torch.core.executor import (OPCODES, THREADS, CudaExecutor,
                                           TorchExecutor)
    cases, max_err, blocks = 0, 0.0, set()
    for name in sorted(algorithms.REGISTRY):
        for n in (2, 4, 8):
            for lvl in range(4):
                prog = passes.optimize(algorithms.REGISTRY[name](n), lvl, n)
                n_in = prog.chunks[prog.in_buffer]
                kern = CudaExecutor(prog).prepare(n)
                plain = TorchExecutor(prog, vectorize=lvl > 0).prepare(n)
                # (2, 40): aligned 16-byte vector path; (1, 13): odd
                # chunk sizes, so later chunks take the scalar path;
                # (37, 1003): several blocks a rank, the last tile ragged
                # (37111 elements a chunk, not a multiple of 8 nb)
                for rows, cols in ((2, 40), (1, 13), (37, 1003)):
                    for dtype in (torch.float32, torch.bfloat16,
                                  torch.int32):
                        x = _api_input((n, n_in * rows, cols), dtype, gen,
                                       device)
                        got, want = kern(x), plain(x)
                        torch.cuda.synchronize()
                        max_err = max(max_err, (got.float() - want.float())
                                      .abs().max().item())
                        check(torch.equal(got, want),
                              f"kernel != plain: {name} n={n} O{lvl} "
                              f"{dtype} ({rows}x{cols}, {kern.blocks} "
                              f"blocks a rank)")
                        check(rows < 37 or kern.blocks > 1,
                              f"{name} n={n} {rows}x{cols}: one block a rank")
                        blocks.add(kern.blocks)
                        cases += 1
    shapes = []
    families = [(ARCH, tp, pname, bp)
                for tp, plans in _decode_plans(device).items()
                for pname, bp in plans.items()]
    families += [(MOE_ARCH, tp, pname, bp)
                 for tp, plans in _moe_plans(device).items()
                 for pname, bp in plans.items()]
    families += [(HYBRID_ARCH, tp, pname, bp)
                 for tp, plans in _hybrid_plans(device).items()
                 for pname, bp in plans.items()]
    for arch, tp, pname, bp in families:
        for b, plan in bp.plans.items():
            plain = TorchExecutor(plan.program).prepare(tp)
            for rep in range(3):        # replays reuse flags + scratch
                x = torch.randn((tp,) + plan.shape, generator=gen,
                                device=device).to(plan.executor._bound[2])
                got, want = plan(x), plain(x)
                torch.cuda.synchronize()
                max_err = max(max_err, (got.float() - want.float())
                              .abs().max().item())
                check(torch.equal(got, want), f"kernel != plain: {arch} "
                      f"{pname} tp={tp} rows={b} rep={rep}")
                cases += 1
            enc = plan.executor.encoded
            shapes.append(dict(arch=arch, plan=pname, tp=tp, rows=b,
                               cols=plan.shape[1], dtype=plan.dtype,
                               algo=plan.algo, opt_level=plan.opt_level,
                               blocks_per_rank=plan.executor.blocks,
                               table=list(enc.ops.shape),
                               flag_slots=enc.n_flags,
                               puts_per_rank=int((enc.ops[0, :, 0]
                                                  == OPCODES["put"]).sum())))
    graphs = _plans_graph_replay(device, gen, families)
    max_err = max(max_err, graphs["max_abs_err"])
    emit("kernel_vs_plain", cases=cases, max_abs_err=max_err,
         blocks_per_rank=sorted(blocks), threads=THREADS,
         decode_shapes=shapes, graph_replay=graphs)
    return max_err


def _plans_graph_replay(device, gen, families):
    """Every decode plan's program (each bucket of each family), in f32
    and bf16, on an executor of its own: captured once in a CUDA graph,
    then replayed GRAPH_REPLAYS times on fresh inputs copied into the
    captured one, with an eager call of the same executor (same flags and
    epoch words) between replays. Each replay and each eager call is
    bit-equal to ``TorchExecutor``: the kernel's epoch lives on the card,
    so a replay does not reuse the epoch it captured, and the capture
    keeps the launch cooperative (its graph node says so)."""
    from repro_torch.core.executor import (CudaExecutor, TorchExecutor,
                                           graph_nodes)
    replays = eager = captures = 0
    err = 0.0
    for arch, tp, pname, bp in families:
        for b, plan in bp.plans.items():
            shape = (tp, plan.shape[0] + plan.pad, plan.shape[1])
            plain = TorchExecutor(plan.program).prepare(tp)
            for dtype in (torch.float32, torch.bfloat16):
                kern = CudaExecutor(plan.program).prepare(tp)
                x = torch.randn(shape, generator=gen, device=device).to(dtype)
                kern(x)                      # bind outside the capture
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.graph(graph):
                    y = kern(x)
                nodes, coop, traced = graph_nodes(graph)
                check(nodes == coop == 1 and traced == 0,
                      f"{arch} {pname} tp={tp} rows={b} {dtype}: {nodes} "
                      f"executor nodes, {coop} cooperative, {traced} traced")
                graph.instantiate()
                captures += 1
                for i in range(GRAPH_REPLAYS):
                    x.copy_(torch.randn(shape, generator=gen, device=device))
                    graph.replay()
                    torch.cuda.synchronize()
                    want = plain(x)
                    err = max(err, (y.float() - want.float()).abs().max()
                              .item())
                    check(torch.equal(y, want), f"graph replay {i} != plain: "
                          f"{arch} {pname} tp={tp} rows={b} {dtype}")
                    replays += 1
                    z = torch.randn(shape, generator=gen, device=device).to(
                        dtype)
                    got = kern(z)
                    torch.cuda.synchronize()
                    check(torch.equal(got, plain(z)), f"eager call after "
                          f"replay {i} != plain: {arch} {pname} tp={tp} "
                          f"rows={b} {dtype}")
                    eager += 1
                del graph, y
    return dict(captures=captures, replays=replays, eager_between=eager,
                max_abs_err=err)


def _serve(eng, prompts, n_decode, seed=0):
    """Serve ``prompts`` then ``n_decode`` tokens on ``eng`` from
    position 0 (greedy, or drawn from ``seed`` at the engine's
    temperature): the first step's logits, the last prefill logits, the
    tokens, ms/token of the decode loop and the executor launches the
    wrapper made in the first step."""
    from repro_torch.core.executor import CudaExecutor
    dev = eng.device
    # the stream's work, not the device's: a watchdog's abandoned worker
    # may still be capturing on another stream (phase 15)
    stream = torch.cuda.current_stream(dev)
    stream.synchronize()
    before = CudaExecutor.launches
    first = eng._run_step(torch.as_tensor(prompts[:, 0], dtype=torch.long,
                                          device=dev))
    eng.pos += 1
    stream.synchronize()
    first_step_launches = CudaExecutor.launches - before
    logits = eng.prefill(prompts[:, 1:])
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    toks = eng.decode(logits, num_tokens=n_decode, seed=seed)
    e1.record()
    stream.synchronize()
    return dict(first=first.float().cpu(), last=logits.float().cpu(),
                tokens=toks, ms_per_token=e0.elapsed_time(e1) / n_decode,
                first_step_launches=first_step_launches)


def _executor_kernels(prof):
    """Executor kernel launches in a profile (graph replays included)."""
    from torch.autograd import DeviceType
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "dsl_executor_kernel" in e.key)


def _profile_graph(run, steps, want):
    """Executor kernels over ``steps`` calls of ``run`` (graph replays)
    under the profiler, after one call in its warm-up (a session's first
    records can go missing: in full runs the head of a session's first
    replay did). CUPTI drops a graph's records now and then, never adds
    one (the benchmark's ``notes.executor_records_dropped`` counts how
    often in every traced run of ``portbench/``): profiles are
    taken until one holds ``want`` executor kernels (at most
    PROFILE_TRIES) and the most any held is returned, so a graph with a
    launch too many or too few shows in every profile. Returns (kernels,
    profiles taken, the kernels of the last profile whose counts are not
    a multiple of ``steps``, that profile)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    seen = []
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=steps,
                                       repeat=1)) as prof:
            for _ in range(steps + 1):
                run()
                torch.cuda.synchronize()
                prof.step()
        seen.append(_executor_kernels(prof))
        if seen[-1] >= want:
            break
    odd = {e.key[:80]: e.count for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.count % steps}
    return max(seen), len(seen), odd, prof


def _profile_replays(eng, steps, ms_per_token):
    """``steps`` replays of the engine's graph under the profiler
    (:func:`_profile_graph`, wanting the graph's captured launches a
    replay): the executor kernels they ran, device busy ms a step and the
    busy share of the graph's unprofiled ms/token."""
    tok = torch.zeros(eng.scfg.batch, dtype=torch.long, device=eng.device)

    def step():
        eng._run_step(tok)
        eng.pos += 1

    kernels, tries, _, prof = _profile_graph(step, steps,
                                             eng.graph.launches * steps)
    busy_ms = sum(r[0] for r in _device_rows(prof, steps)) / 1e3
    return dict(profiled_executor_kernels=kernels,
                profiled_replays=steps, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / ms_per_token,
                profiled_kernel_records=sum(r[1] for r in
                                            _device_rows(prof, 1)),
                profiles_taken=tries)


def _run_engine(cfg, params, prompts, mode, n_decode, count_launches,
                keep_params=False, kv_quant=False, profile_steps=0,
                temperature=0.0, seed=0, tp=TP):
    """One engine on the card (its step captured in a CUDA graph just
    after construction), driven twice from position 0 on the same state: by
    graph replay, then, with the cache zeroed, by the eager step. Returns
    the graph run's record (first-step logits, last prefill logits,
    tokens, ms/token) with the eager run's under ``eager``, the executor
    launches the capture recorded (``graph_launches``), the wrapper's
    launches over the main path (engine construction — warm-up and
    capture — and the graph-served tokens; set to 0 just before with
    ``count_launches``), the eager run's launches, and, with
    ``profile_steps``, a profiler count of the executor kernels over that
    many replays with the busy share under replay. With a
    ``temperature``, the tokens are drawn from ``seed`` in both runs.
    ``tp`` ranks stack on the card. Checks graph against eager:
    first-step logits bit-equal and every token equal."""
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.serve.engine import Engine, ServeConfig
    torch.cuda.synchronize()
    if count_launches:
        CudaExecutor.launches = 0           # just before the main path
    eng = Engine(cfg, params, ServeConfig(batch=prompts.shape[0],
                                          max_kv=MAX_KV, kv_quant=kv_quant,
                                          temperature=temperature),
                 tp=tp, mode=mode)
    eng.capture()
    check(eng.graph is not None, "the engine captured no graph")
    if mode == "explicit":
        backends = {p.backend for bp in eng.decode_plans.values()
                    for p in bp.plans.values()}
        check(backends == {"cuda"}, f"explicit plans on {backends}")
    out = _serve(eng, prompts, n_decode, seed)
    torch.cuda.synchronize()
    _healthy(eng, f"{cfg.name} {mode}")
    # read just after (an auto run does not count: it makes none)
    out["launches"] = CudaExecutor.launches if count_launches else None
    out["graph_launches"] = eng.graph.launches
    out["graph_replays"] = eng.graph.replays
    check(out["first_step_launches"] == 0,
          f"{out['first_step_launches']} eager launches in a graph step")
    # the eager step on the same engine state
    for leaves in eng.cache.values():
        for leaf in leaves:
            leaf.zero_()
    eng.pos, eng._step = 0, eng._eager
    before = CudaExecutor.launches
    eager = _serve(eng, prompts, n_decode, seed)
    eager["launches"] = CudaExecutor.launches - before
    _healthy(eng, f"{cfg.name} {mode} eager")
    out["eager"] = eager
    label = f"{cfg.name} {mode}{' int8' if kv_quant else ''}"
    check(torch.equal(out["first"], eager["first"]),
          f"{label}: graph and eager first-step logits differ: max abs "
          f"{(out['first'] - eager['first']).abs().max().item()}")
    check(np.array_equal(out["tokens"], eager["tokens"]),
          f"{label}: graph and eager tokens differ")
    if profile_steps:
        eng._step = eng.graph.run
        out.update(_profile_replays(eng, profile_steps, out["ms_per_token"]))
    out["plans"] = {k: {b: p.algo for b, p in bp.plans.items()}
                    for k, bp in eng.decode_plans.items()}
    if keep_params:
        out["params"] = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _graph_gates(r, per_step, steps, label):
    """The executor launches of an explicit graph-served run: the capture
    recorded ``per_step``; the wrapper launched them for each warm-up
    step and the capture and never while replaying; the eager run
    launched ``per_step`` a step; the profiler saw ``per_step`` a
    replay."""
    from repro_torch.distributed.step import WARMUP_STEPS
    check(r["graph_launches"] == per_step,
          f"{label}: {r['graph_launches']} launches captured")
    check(r["launches"] == (WARMUP_STEPS + 1) * per_step,
          f"{label}: {r['launches']} wrapper launches over construction "
          f"and {steps} replayed steps")
    check(r["graph_replays"] == steps,
          f"{label}: {r['graph_replays']} replays for {steps} steps")
    check(r["eager"]["first_step_launches"] == per_step,
          f"{label}: {r['eager']['first_step_launches']} launches in the "
          f"eager first step")
    check(r["eager"]["launches"] == per_step * steps,
          f"{label}: {r['eager']['launches']} eager launches in {steps} "
          f"steps")
    if "profiled_executor_kernels" in r:
        want = per_step * r["profiled_replays"]
        check(r["profiled_executor_kernels"] == want,
              f"{label}: profiler saw {r['profiled_executor_kernels']} "
              f"executor kernels over {r['profiled_replays']} replays, "
              f"want {want}")


def _counted(r) -> tuple:
    """(wrapper launches over the main path, executor kernels the
    profiler counted, over how many replays) of an explicit run."""
    return (r["launches"], r["profiled_executor_kernels"],
            r["profiled_replays"])


def _int8_vs_fp(q, fp) -> dict:
    """The reference's int8 bar (tests/test_kv_quant.py): max abs error
    over the fp logits' max abs, and argmax agreement."""
    rel = ((q - fp).abs().max() / fp.abs().max()).item()
    agree = float((q.argmax(-1) == fp.argmax(-1)).float().mean())
    return dict(rel_err=rel, argmax_agreement=agree)


def _run_record(r) -> dict:
    keep = ("ms_per_token", "graph_launches", "launches", "graph_replays",
            "profiled_executor_kernels", "profiled_replays",
            "profiled_kernel_records", "profiles_taken",
            "device_busy_ms", "device_busy_share")
    out = {k: r[k] for k in keep if k in r}
    out["eager_ms_per_token"] = r["eager"]["ms_per_token"]
    out["eager_launches"] = r["eager"]["launches"]
    return out


def _serve_four_modes(cfg, params, prompts, per_step, label,
                      keep_params=False):
    """:func:`_run_engine` in auto, explicit, auto-int8 and explicit-int8
    (with ``keep_params``, the explicit run keeps its rank-stacked
    params): each explicit run held to ``per_step`` executor launches
    (:func:`_graph_gates`), each auto run to none, every run's logits
    finite and its tokens of the served shape."""
    runs = {}
    for name, mode, quant in (("auto", "auto", False),
                              ("explicit", "explicit", False),
                              ("auto_int8", "auto", True),
                              ("explicit_int8", "explicit", True)):
        runs[name] = _run_engine(cfg, params, prompts, mode, DECODE,
                                 mode == "explicit", kv_quant=quant,
                                 keep_params=keep_params
                                 and name == "explicit",
                                 profile_steps=MAIN_DECODE_STEPS)
        if mode == "explicit":
            _graph_gates(runs[name], per_step, PROMPT + DECODE,
                         f"{label} {name}")
        else:
            check(runs[name]["graph_launches"] == 0
                  and runs[name]["profiled_executor_kernels"] == 0,
                  f"{label} {name}: executor launches in auto mode")
    for r in runs.values():
        check(bool(torch.isfinite(r["first"]).all()
                   and torch.isfinite(r["last"]).all()), "non-finite logits")
        check(r["tokens"].shape == (BATCH, DECODE), "token shape")
    return runs


def phase_main_path(device):
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(0)
    t = time.perf_counter()
    params = tf.init_params(cfg, gen, device=device)
    init_s = time.perf_counter() - t
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)
    per_step = 2 * cfg.n_layers + 2           # layers, embed, logits
    runs = _serve_four_modes(cfg, params, prompts, per_step, ARCH)
    auto, explicit = runs["auto"], runs["explicit"]
    diff = (explicit["first"] - auto["first"])
    rel = _rel(explicit["first"], auto["first"])
    check(rel <= BF16_REL_TOL, f"first-step logits differ: rel {rel}")
    rel_int8 = _rel(runs["explicit_int8"]["first"],
                         runs["auto_int8"]["first"])
    check(rel_int8 <= BF16_REL_TOL,
          f"int8 first-step logits, explicit vs auto: rel {rel_int8}")
    # int8 against the bf16 cache, 16 tokens into the cache
    int8_vs_bf16 = {m: _int8_vs_fp(runs[f"{m}_int8"]["last"], runs[m]["last"])
                    for m in ("auto", "explicit")}
    for m, v in int8_vs_bf16.items():
        check(v["rel_err"] < INT8_REL_TOL
              and v["argmax_agreement"] >= INT8_ARGMAX_AGREEMENT,
              f"int8 vs bf16 cache ({m}): {v}")
    agree = float((explicit["tokens"] == auto["tokens"]).mean())
    emit("main_path", arch=ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab, dtype=cfg.dtype, tp=TP, batch=BATCH, prompt=PROMPT,
         decode=DECODE, init_params_s=round(init_s, 3),
         ms_per_token_auto=auto["ms_per_token"],
         ms_per_token_explicit=explicit["ms_per_token"],
         ms_per_token_auto_eager=auto["eager"]["ms_per_token"],
         ms_per_token_explicit_eager=explicit["eager"]["ms_per_token"],
         runs={k: _run_record(r) for k, r in runs.items()},
         launches=explicit["launches"], launches_per_step=per_step,
         first_step_rel_err=rel, first_step_max_abs_err=diff.abs().max()
         .item(), int8_first_step_rel_err=rel_int8,
         int8_vs_bf16=int8_vs_bf16, int8_rel_tol=INT8_REL_TOL,
         bf16_rel_tol=BF16_REL_TOL, token_agreement=agree,
         plans=explicit["plans"])
    del params
    torch.cuda.empty_cache()
    return _counted(explicit)


def phase_f32_reduced_depth(device):
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config(ARCH), n_layers=4,
                              dtype="float32")
    gen = torch.Generator(device=device).manual_seed(1)
    params = tf.init_params(cfg, gen, device=device)
    prompts = np.random.RandomState(1).randint(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)
    auto = _run_engine(cfg, params, prompts, "auto", 16, False)
    explicit = _run_engine(cfg, params, prompts, "explicit", 16, False)
    equal = bool(np.array_equal(auto["tokens"], explicit["tokens"]))
    rel = ((explicit["last"] - auto["last"]).norm()
           / auto["last"].norm()).item()
    emit("f32_reduced_depth", n_layers=cfg.n_layers, tokens_equal=equal,
         steps=16, last_prefill_rel_err=rel, graph=True)
    check(equal, "f32 explicit and auto greedy tokens differ")
    del params
    torch.cuda.empty_cache()


def _plan_library(pname, x):
    """The one-call PyTorch yardstick of a decode plan's collective."""
    if pname == "layer_allreduce":
        return lambda: x.sum(0, keepdim=True).expand_as(x).contiguous()
    if pname == "logits_allgather":
        return lambda: x.reshape(1, -1, x.shape[-1]).expand(
            TP, TP * x.shape[1], x.shape[-1]).contiguous()
    return lambda: x.view(TP, TP, x.shape[1] // TP, x.shape[-1]
                          ).transpose(0, 1).contiguous()


def _time_plan(arch, pname, plan, b, gen, device, iters=200) -> dict:
    """One bucket's plan on the executor kernel: held bit-equal to the
    plain version on the timed input (its max abs error kept), then
    device ms a launch, its HBM bound (each input read once, each output
    written once), the plain version, the one-call yardstick, blocks a
    rank and threads, and the same program on 8 elements a chunk (launch
    and flags only)."""
    from repro_torch.core.executor import (THREADS, CudaExecutor,
                                           TorchExecutor)
    ex = plan.executor
    x = torch.randn((TP,) + plan.shape, generator=gen,
                    device=device).to(ex._bound[2])
    plain = TorchExecutor(plan.program).prepare(TP)
    prog = plan.program
    n_in, n_out = prog.chunks[prog.in_buffer], prog.chunks[prog.out_buffer]
    nbytes = x.numel() * x.element_size() * (1 + n_out / n_in)
    lib = _plan_library(pname, x)
    got, want = ex(x), plain(x)
    err = _max_abs_err(got, want)
    check(torch.equal(got, want), f"kernel != plain: {arch} {pname} "
          f"rows={b} (max abs {err})")
    del got, want
    k_ms, k_cov = device_ms(lambda: ex(x), iters)
    p_ms, p_cov = device_ms(lambda: plain(x), max(iters // 4, 10))
    l_ms, l_cov = device_ms(lib, iters)
    tiny = CudaExecutor(prog).prepare(TP)
    xt = torch.randn((TP, n_in, 8), generator=gen,
                     device=device).to(ex._bound[2])
    f_ms, f_cov = device_ms(lambda: tiny(xt), iters)
    return dict(
        arch=arch, plan=pname, algo=plan.algo, rows=b, cols=plan.shape[1],
        dtype=plan.dtype, max_abs_err=err, ms=k_ms,
        ms_wall=wall_ms(lambda: ex(x), iters),
        plain_ms=p_ms, library_ms=l_ms,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
        blocks_per_rank=ex.blocks, threads=THREADS, flags_only_ms=f_ms,
        sleep_covered=bool(k_cov and p_cov and l_cov and f_cov))


def phase_kernel_time(device, gen):
    """Per decode shape of the TP=4 main paths (qwen3-1.7b's AllReduce
    and AllGather plans; phi3.5-moe's, and its ``moe_alltoall`` plans,
    whose ``rows`` count rows per per-rank block): :func:`_time_plan`."""
    families = [(ARCH, pname, bp)
                for pname, bp in _decode_plans(device)[TP].items()]
    families += [(MOE_ARCH, pname, bp)
                 for pname, bp in _moe_plans(device)[TP].items()]
    families += [(HYBRID_ARCH, pname, bp)
                 for pname, bp in _hybrid_plans(device)[TP].items()]
    rows_out = [_time_plan(arch, pname, plan, b, gen, device)
                for arch, pname, bp in families
                for b, plan in bp.plans.items()]
    emit("kernel_time", shapes=rows_out)
    return rows_out


def _device_rows(prof, steps: int):
    """(device µs per step, launches per step, kernel name) of every
    device-side kernel in a profile, largest first: a CPU op's self
    device time repeats the kernels it launched, so only CUDA events."""
    from torch.autograd import DeviceType
    rows = [(e.self_device_time_total / steps, e.count // steps, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    return sorted(rows, reverse=True)


def _profile_prefill(device):
    """Where one prefill forward's time goes, for each phase-10 model:
    ``torch.profiler`` over one ``make_prefill_step`` call after a warm
    one; device busy share with and without the profiler, the flash
    kernel's share, and the kernels that take most of the time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.distributed.step import make_prefill_step
    from repro_torch.models import transformer as tf
    out = {}
    for i, (arch, (b, s)) in enumerate(PREFILL.items()):
        cfg = configs.get_config(arch)
        gen = torch.Generator(device=device).manual_seed(10 + i)
        params = tf.init_params(cfg, gen, device=device)
        tokens = (torch.randn((b, s, cfg.d_model), generator=gen,
                              device=device) if cfg.frontend != "none" else
                  torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                device=device))
        step = make_prefill_step(cfg)
        step(params, tokens)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(params, tokens)
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            step(params, tokens)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        rows = _device_rows(prof, 1)
        busy_ms = sum(r[0] for r in rows) / 1e3
        out[arch] = dict(
            batch=b, tokens=s, wall_ms=wall, wall_ms_unprofiled=bare_ms,
            device_busy_ms=busy_ms,
            device_busy_share_unprofiled=busy_ms / bare_ms,
            flash_ms=sum(r[0] for r in rows if "fa_" in r[2]) / 1e3,
            top_kernels=[dict(name=k[:90], us=us, launches=c)
                         for us, c, k in rows[:12]])
        del params, tokens, step
        torch.cuda.empty_cache()
    return out


def phase_profile(device):
    """Opt-in (``--phases 7``): where one decode step's time goes —
    ``torch.profiler`` over 4 steps of each mode at each main path's
    shape (qwen3-1.7b, phase 4; phi3.5-moe at 8 layers, phase 9;
    hymba-1.5b with its heads padded to 40, phase 12), served
    as the engine serves them, by replaying its CUDA graph, and the same
    steps eager beside them: device busy share = summed kernel time over
    the steps' wall time, with and without the profiler, and the kernels
    that take most of it. Then the same for one prefill forward of each
    phase-10 model."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Engine, ServeConfig
    tok = torch.zeros(BATCH, dtype=torch.long, device=device)
    steps = 4
    out = {}

    def measure(eng):
        for _ in range(PROMPT):                # warm, and fill the cache
            eng._run_step(tok)
            eng.pos += 1
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            eng._run_step(tok)
            eng.pos += 1
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(steps):
                eng._run_step(tok)
                eng.pos += 1
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3 / steps
        rows = _device_rows(prof, steps)
        busy_ms = sum(r[0] for r in rows) / 1e3
        return dict(
            step_wall_ms=wall_ms, step_wall_ms_unprofiled=bare_ms,
            device_busy_ms=busy_ms,
            device_busy_share=busy_ms / wall_ms if rows else None,
            device_busy_share_unprofiled=(busy_ms / bare_ms if rows
                                          else None),
            executor_kernels_per_step=_executor_kernels(prof) / steps,
            top_kernels=[dict(name=k[:90], us_per_step=us, launches=c)
                         for us, c, k in rows[:12]])

    for arch, cfg in ((ARCH, configs.get_config(ARCH)),
                      (MOE_ARCH, _moe_cfg(MOE_LAYERS)),
                      (HYBRID_ARCH, _hybrid_cfg())):
        params = tf.init_params(cfg, torch.Generator(device=device)
                                .manual_seed(0), device=device)
        out[arch] = {}
        for mode in ("auto", "explicit"):
            eng = Engine(cfg, params, ServeConfig(batch=BATCH,
                                                  max_kv=MAX_KV),
                         tp=TP, mode=mode)
            graph = measure(eng)
            eng.pos, eng._step = 0, eng._eager
            out[arch][mode] = dict(n_layers=cfg.n_layers, graph=graph,
                                   eager=measure(eng))
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    emit("profile", note="profiler on: times include its overhead",
         prefill=_profile_prefill(device), **out)


def _rand(shape, dtype, gen, device):
    if dtype == torch.int32:
        return torch.randint(-100, 100, shape, generator=gen, device=device,
                             dtype=torch.int32)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _serving_sizes():
    """qwen3-1.7b at TP=4, batch 8: (label, per-rank input, dtype) of the
    decode and prefill (8 x 16 tokens) AllReduces and the logits shard."""
    from repro_torch import configs
    cfg = configs.get_config(ARCH)
    return dict(decode=((BATCH, cfg.d_model), torch.bfloat16),
                prefill=((BATCH * PROMPT, cfg.d_model), torch.bfloat16),
                logits=((BATCH, cfg.vocab // TP), torch.float32))


def _collectives_vs_plain(device, gen):
    """Every op x algo x protocol against its plain version, bit-equal."""
    from repro_torch.kernels import ops
    errs = {k: 0.0 for k in COLLECTIVES}
    cases = 0

    def held(op, kw, kernels, x, what):
        nonlocal cases
        got = getattr(ops, op)(x, **kw)
        want = getattr(ops, op)(x, backend="torch", **kw)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        for k in kernels:
            errs[k] = max(errs[k], err)
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"kernel != plain: {op} {kw} {what} (max |err| {err})")
        cases += 1

    for n in (2, 4, 8):
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            for rows, cols in GRID_SHAPES:
                for op, kw, kernels, per_chunk in COLLECTIVE_OPS:
                    x = _rand((n, rows * (n if per_chunk else 1), cols),
                              dtype, gen, device)
                    held(op, kw, kernels, x, f"n={n} {dtype} {tuple(x.shape)}")
    sizes = _serving_sizes()
    for op, kw, kernels, _ in COLLECTIVE_OPS:
        labels = ("logits",) if op == "all_gather" else ("decode", "prefill")
        for label in labels:
            shape, dtype = sizes[label]
            x = _rand((TP,) + shape, dtype, gen, device)
            held(op, kw, kernels, x, f"{label} {dtype} {tuple(x.shape)}")

    # LL flag test: calls chained, then fresh data with the same step (the
    # card's test_all_reduce_1pa_distinct_steps; the kernel keeps no flags
    # between launches, it resets them in shared memory)
    shape, dtype = sizes["decode"]
    for use_ll in (True, False):
        x = _rand((TP,) + shape, dtype, gen, device)
        for step, fresh in ((0, False), (1, False), (1, True)):
            if fresh:
                x = _rand((TP,) + shape, dtype, gen, device)
            y = ops.all_reduce(x, algo="1pa", use_ll=use_ll, step=step)
            want = ops.all_reduce(x, algo="1pa", use_ll=use_ll, step=step,
                                  backend="torch")
            torch.cuda.synchronize()
            check(torch.equal(y, want), f"1PA use_ll={use_ll} step={step} "
                  f"fresh={fresh}: kernel != plain on chained calls")
            cases += 1
            x = y
    return cases, errs


def _1pa_shapes(esz):
    """(rows, cols) a rank of the 1PA grid: odd counts (1, 387, 5115 and
    260865 elements) and 1 KiB, 32 KiB and 1 MiB a rank."""
    return ((1, 1), (3, 129), (5, 1023), (255, 1023), (1, 1024 // esz),
            (8, 4096 // esz), (256, 4096 // esz))


def _1pa_vs_plain(device, gen):
    """The cluster 1PA kernel, LL and HB, bit-equal to its plain version
    at n = 1..8 (cluster shapes of 1 to 8 blocks, 3, 5, 6, 7 among them) x
    f32/bf16/f16/int32 x ``_1pa_shapes``; then, per n and type, chains of
    4 launches back to back on two inputs (an odd count and 32 KiB a rank)
    that alternate the protocols, each output held after one
    synchronisation."""
    from repro_torch.kernels import allreduce_1pa as ap
    cases, err = 0, 0.0

    def held(got, x, ll, what):
        nonlocal cases, err
        want = ap.all_reduce_1pa_plain(x, use_ll=ll)
        err = max(err, (got.double() - want.double()).abs().max().item())
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"1PA {'LL' if ll else 'HB'} {what} != plain: {x.dtype} "
              f"{tuple(x.shape)}")
        cases += 1

    for n in range(1, 9):
        for dtype in (torch.float32, torch.bfloat16, torch.float16,
                      torch.int32):
            esz = torch.empty((), dtype=dtype).element_size()
            for shape in _1pa_shapes(esz):
                x = _rand((n,) + shape, dtype, gen, device)
                for ll in (True, False):
                    got = ap.all_reduce_1pa(x, use_ll=ll)
                    torch.cuda.synchronize()
                    held(got, x, ll, f"n={n}")
            xs = [_rand((n, 3, 2047), dtype, gen, device),
                  _rand((n, 8, 4096 // esz), dtype, gen, device)]
            chain = [(xs[i], ll, ap.all_reduce_1pa(xs[i], use_ll=ll))
                     for i, ll in ((0, True), (1, False), (1, True),
                                   (0, False))]
            torch.cuda.synchronize()
            for i, (x, ll, got) in enumerate(chain):
                held(got, x, ll, f"alternating launch {i} n={n}")
    return dict(cases=cases, max_abs_err=err, n=list(range(1, 9)))


def _1pa_graph_replay(device, gen):
    """The LL and HB 1PA, each captured once in a CUDA graph at the decode
    size and replayed 16 times on fresh inputs copied into the captured
    one, each replay bit-equal to the plain version: the kernel takes no
    epoch and no workspace, so a replay needs nothing from the host."""
    from repro_torch.kernels import allreduce_1pa as ap
    shape, dtype = _serving_sizes()["decode"]
    replays, err = 0, 0.0
    for ll in (True, False):
        x = _rand((TP,) + shape, dtype, gen, device)
        ap.all_reduce_1pa(x, use_ll=ll)        # the cluster query, once
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = ap.all_reduce_1pa(x, use_ll=ll)
        for i in range(16):
            x.copy_(_rand((TP,) + shape, dtype, gen, device))
            graph.replay()
            torch.cuda.synchronize()
            want = ap.all_reduce_1pa_plain(x, use_ll=ll)
            err = max(err, (y.double() - want.double()).abs().max().item())
            check(torch.equal(y, want), f"1PA {'LL' if ll else 'HB'} graph "
                  f"replay {i} != plain")
            replays += 1
        del graph
    return dict(replays=replays, max_abs_err=err, shape=[TP, *shape])


def _threshold_shapes(n, esz, limit):
    """(rows a chunk, cols) of inputs around ``limit`` bytes a rank (n
    chunks of ``esz``-byte elements): a tiny odd count, the largest at or
    under the limit and the next over it with 512 columns, and the same
    with 511 columns and an odd row count (an odd element count a
    chunk)."""
    out = [(3, 129)]
    for cols, step in ((512, 1), (511, 2)):
        rows = limit // (n * cols * esz)
        if step == 2 and rows % 2 == 0:
            rows -= 1
        out += [(rows, cols), (rows + step, cols)]
    return out


def _rs_protocols_vs_plain(device, gen):
    """The ReduceScatter kernel with each protocol forced, and the public
    op (which picks by bytes), bit-equal to the plain version at n in {2,
    4, 8}, f32/bf16/int32, on both sides of LL_MAX_BYTES a rank and at odd
    element counts."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import reducescatter_2pa as rs
    cases, err = 0, 0.0
    chosen = {"ll": 0, "hb": 0}
    for n in (2, 4, 8):
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            esz = torch.empty((), dtype=dtype).element_size()
            for rows, cols in _threshold_shapes(n, esz, rs.LL_MAX_BYTES):
                x = _rand((n, n * rows, cols), dtype, gen, device)
                want = rs.reduce_scatter_2pa_plain(x)
                proto = rs.rs_protocol(x[0].numel() * esz)
                chosen[proto] += 1
                for name, got in (("ll", rs._launch_rs(x, "ll")),
                                  ("hb", rs._launch_rs(x, "hb")),
                                  (f"op ({proto})", ops.reduce_scatter(x))):
                    torch.cuda.synchronize()
                    err = max(err, (got.double() - want.double()).abs().max()
                              .item())
                    check(got.dtype == want.dtype and torch.equal(got, want),
                          f"reduce_scatter {name} != plain: n={n} {dtype} "
                          f"{tuple(x.shape)}")
                    cases += 1
    check(chosen["ll"] > 0 and chosen["hb"] > 0,
          f"the protocol sweep missed a side of the threshold: {chosen}")
    return dict(cases=cases, max_abs_err=err, chosen=chosen,
                ll_max_bytes=rs.LL_MAX_BYTES)


def _ag_protocols_vs_plain(device, gen):
    """The all-pairs AllGather kernel with each protocol forced, and the
    public op (which picks by bytes), bit-equal to the plain version at n
    in {2, 4, 8}, f32/bf16/f16/int32, on both sides of AG_LL_MAX_BYTES a
    rank and at odd element counts; then, per n and type, six launches
    back to back on two inputs (an odd count) that alternate the
    protocols, each output held after one synchronisation."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import reducescatter_2pa as rs
    cases, err = 0, 0.0
    chosen = {"ll": 0, "hb": 0}

    def held(got, x, what):
        nonlocal cases, err
        want = rs.all_gather_2pa_plain(x)
        err = max(err, (got.double() - want.double()).abs().max().item())
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"all_gather allpairs {what} != plain: {x.dtype} "
              f"{tuple(x.shape)}")
        cases += 1

    for n in (2, 4, 8):
        for dtype in (torch.float32, torch.bfloat16, torch.float16,
                      torch.int32):
            esz = torch.empty((), dtype=dtype).element_size()
            for rows, cols in _threshold_shapes(1, esz, rs.AG_LL_MAX_BYTES):
                x = _rand((n, rows, cols), dtype, gen, device)
                proto = rs.ag_protocol(x[0].numel() * esz)
                chosen[proto] += 1
                for name, got in (("ll", rs._launch_ag(x, "ll")),
                                  ("hb", rs._launch_ag(x, "hb")),
                                  (f"op ({proto})",
                                   ops.all_gather(x, algo="allpairs"))):
                    torch.cuda.synchronize()
                    held(got, x, f"{name} n={n}")
            xs = [_rand((n, 3, 2047), dtype, gen, device) for _ in range(2)]
            chain = [(xs[i], rs._launch_ag(xs[i], p)) for i, p in (
                (0, "ll"), (1, "hb"), (1, "ll"), (0, "hb"), (0, "ll"),
                (1, "ll"))]
            torch.cuda.synchronize()
            for i, (x, got) in enumerate(chain):
                held(got, x, f"alternating launch {i} n={n}")
    check(chosen["ll"] > 0 and chosen["hb"] > 0,
          f"the protocol sweep missed a side of the threshold: {chosen}")
    return dict(cases=cases, max_abs_err=err, chosen=chosen,
                ag_ll_max_bytes=rs.AG_LL_MAX_BYTES)


def _collectives_main_path(device, gen):
    """The collectives of serving qwen3-1.7b at TP=4 through ``ops``, with
    the kernels' launch counts set to 0 just before and read just after;
    every output is then checked bit-equal to the plain version."""
    from repro_torch import configs
    from repro_torch.kernels import comm_utils, ops
    n_ar = 2 * configs.get_config(ARCH).n_layers + 1   # per forward step
    sizes = _serving_sizes()
    pools = {k: [_rand((TP,) + shape, dtype, gen, device) for _ in range(2)]
             for k, (shape, dtype) in sizes.items()}
    calls = (("prefill", "all_reduce", {}),
             ("decode", "all_reduce", dict(algo="1pa")),
             ("logits", "all_gather", {}))
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def drive():
        outs = []
        events[0].record()
        for i in range(n_ar):                   # prefill of 8 x 16 tokens
            outs.append((0, i % 2, ops.all_reduce(pools["prefill"][i % 2])))
        events[1].record()
        for _ in range(MAIN_DECODE_STEPS):
            for i in range(n_ar):
                outs.append((1, i % 2, ops.all_reduce(pools["decode"][i % 2],
                                                      algo="1pa")))
            outs.append((2, 0, ops.all_gather(pools["logits"][0])))
        events[2].record()
        torch.cuda.synchronize()
        return outs

    drive()           # warm-up: the allocator's blocks for the outputs
    comm_utils.LAUNCHES.clear()                 # just before the main path
    outs = drive()
    launches = dict(comm_utils.LAUNCHES)        # read just after
    e0, e1, e2 = events
    want = {(c, j): getattr(ops, calls[c][1])(pools[calls[c][0]][j],
                                              backend="torch", **calls[c][2])
            for c in range(3) for j in range(2)}
    for c, j, got in outs:
        check(bool(torch.isfinite(got.float()).all())
              and torch.equal(got, want[(c, j)]),
              f"main path: {calls[c][1]} {calls[c][2]} output != plain")
    expect = {"all_reduce_1pa": n_ar * MAIN_DECODE_STEPS,
              "reduce_scatter_2pa": n_ar, "all_gather_2pa": n_ar,
              "all_gather_ring": MAIN_DECODE_STEPS}
    check(launches == expect, f"main-path launches {launches} != {expect}")
    return dict(launches=launches, allreduces_per_step=n_ar,
                decode_steps=MAIN_DECODE_STEPS,
                prefill_ms=e0.elapsed_time(e1),
                decode_ms_per_step=e1.elapsed_time(e2) / MAIN_DECODE_STEPS,
                outputs_checked=len(outs))


def _1pa_timing(x, ll, iters, label, gen, device):
    """The 1PA row's launch geometry, the device time of an empty kernel
    of the same grid, clusters, threads and shared memory back to back
    (its launch floor), its own time without PDL, and at the decode size
    its time behind qwen3-1.7b's TP=4 o_proj matmul, ``(8, 512) @ (512,
    2048)`` a rank: the pair's time minus the matmul's, with and without
    PDL."""
    from repro_torch import configs
    from repro_torch.kernels import allreduce_1pa as ap
    from repro_torch.kernels import build, comm_utils
    n = x.shape[0]
    geo = ap.geometry(n, x[0].numel(), x.element_size(), ll)
    lib = build.allreduce_1pa_library()
    stream = torch.cuda.current_stream(device).cuda_stream

    def empty():
        rc = lib.allreduce_1pa_empty_launch(n, geo.tiles, geo.smem_bytes,
                                            comm_utils.THREADS, stream)
        check(rc == 0, f"empty cluster launch: "
              f"{lib.allreduce_1pa_error_string(rc).decode()}")

    out = dict(tiles=geo.tiles, cluster=geo.cluster, grid=geo.grid,
               tile_bytes=geo.tile_bytes, smem_bytes=geo.smem_bytes,
               launch_floor_ms=device_ms(empty, iters)[0],
               ms_no_pdl=device_ms(lambda: ap._launch(x, ll, pdl=False),
                                   iters)[0])
    if label == "decode":
        cfg = configs.get_config(ARCH)
        k = cfg.n_heads * cfg.head_dim // TP
        a = _rand((n, x.shape[1], k), x.dtype, gen, device)
        w = _rand((n, k, x.shape[2]), x.dtype, gen, device)
        mm = device_ms(lambda: torch.bmm(a, w), iters)[0]
        for key, pdl in (("pair_ms", True), ("pair_ms_no_pdl", False)):
            out[key] = device_ms(lambda pdl=pdl: ap._launch(
                torch.bmm(a, w), ll, pdl=pdl), iters)[0] - mm
        out.update(matmul_ms=mm, matmul=[list(a.shape), list(w.shape)])
    return out


def _collectives_time(device, gen):
    """Device time of each kernel at the serving sizes and over a per-rank
    size sweep at n=4 (bf16), beside the HBM bound (each rank's input
    read once, each output written once, over all ranks), the plain
    version and a one-call PyTorch yardstick the port never calls."""
    from repro_torch.kernels import comm_utils, ops
    from repro_torch.kernels import reducescatter_2pa as rs
    n = TP
    sizes = _serving_sizes()
    d = sizes["decode"][0][1]
    # kernel -> (op, kwargs, [(label, per-rank input, dtype)])
    plan = {
        "all_reduce_1pa": [
            ("all_reduce", dict(algo="1pa", use_ll=ll),
             [("decode",) + sizes["decode"], ("prefill",) + sizes["prefill"]]
             + [(k, v, torch.bfloat16) for k, v in SWEEP.items()
                if k in ("1KiB", "32KiB", "1MiB")])
            for ll in (True, False)],
        "reduce_scatter_2pa": [
            ("reduce_scatter", {},
             [("decode",) + sizes["decode"], ("prefill",) + sizes["prefill"]]
             + [(k, v, torch.bfloat16)
                for k, v in sorted({**SWEEP, **RS_SWEEP}.items(),
                                   key=lambda kv: kv[1][0] * kv[1][1])
                if k != "64MiB"])],
        "all_gather_2pa": [
            ("all_gather", dict(algo="allpairs"),
             [("decode_2pa_half", (BATCH // n, d), torch.bfloat16),
              ("prefill_2pa_half", (BATCH * PROMPT // n, d), torch.bfloat16),
              ("logits",) + sizes["logits"]]
             + [(k, v, torch.bfloat16)
                for k, v in sorted({**SWEEP, **RS_SWEEP}.items(),
                                   key=lambda kv: kv[1][0] * kv[1][1])])],
        "all_gather_ring": [
            ("all_gather", dict(algo="ring"),
             [("logits",) + sizes["logits"]]
             + [(k, v, torch.bfloat16) for k, v in SWEEP.items()])],
    }
    rows_out = {}
    for kernel, variants in plan.items():
        rows_out[kernel] = []
        for op, kw, shapes in variants:
            for label, shape, dtype in shapes:
                x = _rand((n,) + tuple(shape), dtype, gen, device)
                fn = getattr(ops, op)

                def kern(x=x, fn=fn, kw=kw):
                    return fn(x, **kw)

                def plain(x=x, fn=fn, kw=kw):
                    return fn(x, backend="torch", **kw)

                out = kern()
                rows, cols = x.shape[1], x.shape[2]
                if op == "all_reduce":
                    def lib(x=x):
                        return x.sum(0, keepdim=True).expand_as(x).contiguous()
                elif op == "reduce_scatter":
                    def lib(x=x, rows=rows, cols=cols):
                        return x.view(n, n, rows // n, cols).sum(0)
                else:
                    def lib(x=x, rows=rows, cols=cols):
                        return x.reshape(1, -1, cols).expand(
                            n, n * rows, cols).contiguous()
                nbytes = (x.numel() + out.numel()) * x.element_size()
                del out
                rank_bytes = x[0].numel() * x.element_size()
                iters = max(3, min(200, int(4e9 // nbytes)))
                k_ms, k_cov = device_ms(kern, iters)
                p_ms, p_cov = device_ms(plain, max(3, iters // 4))
                l_ms, l_cov = device_ms(lib, iters)
                ws_name = kernel
                extra = {}
                if kernel == "all_reduce_1pa":
                    extra = _1pa_timing(x, kw.get("use_ll", True), iters,
                                        label, gen, device)
                elif kernel in ("reduce_scatter_2pa", "all_gather_2pa"):
                    # both protocols forced, beside the one the op picks
                    pick, launch = ((rs.rs_protocol, rs._launch_rs)
                                    if kernel == "reduce_scatter_2pa" else
                                    (rs.ag_protocol, rs._launch_ag))
                    extra["protocol"] = pick(rank_bytes)
                    ws_name += f"/{extra['protocol']}"
                    for proto in ("ll", "hb"):
                        extra[f"{proto}_ms"] = device_ms(
                            lambda x=x, proto=proto, launch=launch:
                            launch(x, proto), iters)[0]
                if kernel != "all_reduce_1pa":     # the 1PA keeps none
                    extra["blocks_per_rank"] = comm_utils.workspace(
                        ws_name, x).blocks
                rows_out[kernel].append(dict(
                    op=op, **kw, size=label, n=n, rows=rows, cols=cols,
                    dtype=str(dtype).replace("torch.", ""),
                    rank_bytes=rank_bytes,
                    ms=k_ms, ms_wall=wall_ms(kern, iters), plain_ms=p_ms,
                    library_ms=l_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bytes=nbytes, **extra, sleep_covered=dict(
                        kernel=k_cov, plain=p_cov, library=l_cov)))
                del x
                torch.cuda.empty_cache()
    return rows_out


def phase_collectives(device, gen):
    t = time.perf_counter()
    cases, errs = _collectives_vs_plain(device, gen)
    grid_1pa = _1pa_vs_plain(device, gen)
    graph_1pa = _1pa_graph_replay(device, gen)
    errs["all_reduce_1pa"] = max(errs["all_reduce_1pa"],
                                 grid_1pa["max_abs_err"],
                                 graph_1pa["max_abs_err"])
    protocols = _rs_protocols_vs_plain(device, gen)
    errs["reduce_scatter_2pa"] = max(errs["reduce_scatter_2pa"],
                                     protocols["max_abs_err"])
    ag_protocols = _ag_protocols_vs_plain(device, gen)
    errs["all_gather_2pa"] = max(errs["all_gather_2pa"],
                                 ag_protocols["max_abs_err"])
    main = _collectives_main_path(device, gen)
    timing = _collectives_time(device, gen)
    emit("collectives", cases=cases, max_abs_err=errs, ar_1pa=grid_1pa,
         ar_1pa_graph=graph_1pa,
         rs_protocols=protocols, ag_protocols=ag_protocols, main_path=main,
         shapes=timing,
         seconds=round(time.perf_counter() - t, 3))
    return errs, main["launches"], timing


def _moe_caps():
    """Rows per per-rank block of phi3.5-moe's ``moe_alltoall`` buckets at
    TP=4, batch 8: ``e_local * ep_capacity(b)`` for each slot bucket."""
    from repro_torch.distributed.moe_parallel import ep_capacity
    from repro_torch.distributed.step import slot_buckets
    cfg = _moe_cfg(MOE_LAYERS)
    e = cfg.moe.num_experts
    return [e // TP * ep_capacity(b, cfg.moe.top_k)
            for b in slot_buckets(BATCH)]


def _a2a_vs_plain(device, gen):
    """The all_to_all kernel against its plain version, bit-equal (a pure
    copy): n in {2, 4, 8} × f32/bf16/int32 × the grid shapes, the MoE
    dispatch sizes, and back-to-back calls on one workspace whose round
    trip must give the input back (the epoch test)."""
    from repro_torch.kernels import ops
    err, cases = 0.0, 0

    def held(x, what):
        nonlocal err, cases
        got = ops.all_to_all(x)
        want = ops.all_to_all(x, backend="torch")
        torch.cuda.synchronize()
        err = max(err, (got.double() - want.double()).abs().max().item())
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"all_to_all kernel != plain: {what}")
        cases += 1
        return got

    for n in (2, 4, 8):
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            for rows, cols in GRID_SHAPES:
                x = _rand((n, n * rows, cols), dtype, gen, device)
                held(x, f"n={n} {dtype} {tuple(x.shape)}")
    d = _moe_cfg(MOE_LAYERS).d_model
    for c in _moe_caps():
        held(_rand((TP, TP * c, d), torch.bfloat16, gen, device),
             f"MoE dispatch, {c} rows per block")
    shape = (TP, TP * _moe_caps()[-1], d)
    for _ in range(3):
        x = _rand(shape, torch.bfloat16, gen, device)
        back = held(held(x, "reused workspace"), "reused workspace, back")
        check(torch.equal(back, x), "all_to_all round trip != input")
    return cases, err


@contextlib.contextmanager
def _routing(pin=None):
    """Record every MoE layer's top-k routing (router logits and chosen
    experts) while the block is open. With ``pin`` (a recording of the
    auto path), each explicit rank's choices are replaced by auto's for
    the same layer call, weighted by the rank's own router logits: the
    routing is held equal and everything else computed as it is."""
    from repro_torch.distributed import moe_parallel
    from repro_torch.models import blocks
    orig = blocks.top_k
    rec = []

    def spy(x, k):
        vals, idx = orig(x, k)
        if pin is not None:       # auto's (b, s, k) onto (tp, b*s, k)
            idx = pin[len(rec)][1].to(x.device).reshape(1, -1, k).expand(
                idx.shape).contiguous()
            vals = x.gather(-1, idx)
        rec.append((x.float().cpu(), idx.cpu()))
        return vals, idx

    blocks.top_k = moe_parallel.top_k = spy
    try:
        yield rec
    finally:
        blocks.top_k = moe_parallel.top_k = orig


def _moe_first_step(cfg, params, eparams, prompts, device):
    """The first decode step of auto and of explicit mode on the same
    weights and token, their routing recorded. In bf16 a router near-tie
    can route a token to another expert in the two modes (their hidden
    states differ by bf16 rounding: TP partial sums, and each rank's
    own fold order in the 1PA AllReduce), which changes that token's
    logits by O(1) — so the bf16 tolerance is held with the routing
    pinned to auto's, and, unpinned, on the rows whose routing agreed
    on every rank in every layer. Each row that diverges is recorded at
    its first divergence with auto's top-k gap and the router shift
    there, which the caller holds to a near-tie."""
    from repro_torch.distributed.step import make_serve_step
    from repro_torch.mesh import RankAxis
    axis = RankAxis("model", TP, device)
    tok = torch.as_tensor(prompts[:, 0], dtype=torch.long, device=device)
    out = {}
    for mode, p in (("auto", params), ("explicit", eparams),
                    ("pinned", eparams)):
        step, layout = make_serve_step(
            cfg, axis, batch=BATCH, max_kv=MAX_KV,
            mode="auto" if mode == "auto" else "explicit")
        with torch.inference_mode(), _routing(
                out["auto"][1] if mode == "pinned" else None) as rec:
            logits = step(p, layout.cache(), tok, 0)[0].float().cpu()
        out[mode] = (logits, rec)
    auto = out["auto"][0]

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    # tokens whose top-k set agrees with auto on every explicit rank in
    # every layer
    agreed = torch.ones(BATCH, dtype=torch.bool)
    flips = []
    k = cfg.moe.top_k
    for layer, ((la, ia), (le, ie)) in enumerate(zip(out["auto"][1],
                                                     out["explicit"][1])):
        # auto's (b, s, .) as one rank's (1, b*s, .); explicit's is
        # (tp, b*s, .)
        la, ia = la.reshape(1, -1, la.shape[-1]), ia.reshape(1, -1, k)
        same = (ia.sort(-1).values == ie.sort(-1).values).all(-1)  # (tp, T)
        for r, t in (~same).nonzero().tolist():
            if agreed[t]:        # the token's first divergence
                top = la[0, t].sort(descending=True).values
                flips.append(dict(layer=layer, token=t, rank=r,
                                  auto=ia[0, t].tolist(),
                                  explicit=ie[r, t].tolist(),
                                  gap=(top[k - 1] - top[k]).item(),
                                  router_diff=(la[0, t] - le[r, t]).abs()
                                  .max().item()))
        agreed &= same.all(0)
    row_rel = ((out["explicit"][0] - auto).norm(dim=1)
               / auto.norm(dim=1))
    return dict(explicit_logits=out["explicit"][0],
                rel_err=rel(out["explicit"][0], auto),
                pinned_rel_err=rel(out["pinned"][0], auto),
                rows_routed_alike=int(agreed.sum()),
                rows_routed_alike_max_rel_err=(
                    row_rel[agreed].max().item() if agreed.any() else None),
                row_rel_err=row_rel.tolist(), first_divergences=flips)


def _moe_main_path(device):
    """Full-width phi3.5-moe (8 layers) served in auto and explicit mode;
    returns the record, the explicit engine's rank-stacked params and
    the executor launches of the explicit run."""
    from repro_torch.models import transformer as tf
    cfg = _moe_cfg(MOE_LAYERS)
    t = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(2),
                            device=device)
    init_s = time.perf_counter() - t
    prompts = np.random.RandomState(2).randint(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)
    auto = _run_engine(cfg, params, prompts, "auto", DECODE, False,
                       profile_steps=MAIN_DECODE_STEPS)
    explicit = _run_engine(cfg, params, prompts, "explicit", DECODE, True,
                           keep_params=True, profile_steps=MAIN_DECODE_STEPS)
    first = _moe_first_step(cfg, params, explicit["params"], prompts, device)
    del params
    torch.cuda.empty_cache()
    steps = PROMPT + DECODE
    # embedding + per layer (attention AllReduce, dispatch, combine) +
    # logits gather
    per_step = 3 * cfg.n_layers + 2
    _graph_gates(explicit, per_step, steps, f"{MOE_ARCH} explicit")
    check(auto["graph_launches"] == 0
          and auto["profiled_executor_kernels"] == 0,
          f"{MOE_ARCH} auto: executor launches in auto mode")
    for r in (auto, explicit):
        check(bool(torch.isfinite(r["first"]).all()
                   and torch.isfinite(r["last"]).all()), "non-finite logits")
        check(r["tokens"].shape == (BATCH, DECODE), "token shape")
    diff = explicit["first"] - auto["first"]
    rel = (diff.norm() / auto["first"].norm()).item()
    rerun = first.pop("explicit_logits")
    check(torch.equal(explicit["first"], rerun),
          "the served first step differs from its routing-recorded rerun")
    check(first["pinned_rel_err"] <= BF16_REL_TOL,
          f"MoE first-step logits with auto's routing differ: rel "
          f"{first['pinned_rel_err']}")
    check(BATCH - first["rows_routed_alike"] <= MAX_REROUTED_ROWS,
          f"MoE routing: {BATCH - first['rows_routed_alike']} of {BATCH} "
          f"rows routed unlike auto: {first['first_divergences']}")
    check(first["rows_routed_alike_max_rel_err"] <= BF16_REL_TOL,
          f"MoE first-step logits of the rows routed alike differ: {first}")
    # a top-k set changes under a router shift of at most `router_diff`
    # per expert only where auto's k-th and (k+1)-th logits lie within
    # 2 * router_diff: anything wider is not rounding
    for f in first["first_divergences"]:
        check(f["gap"] <= 2 * f["router_diff"],
              f"MoE routing flip that rounding does not explain: {f}")
    record = dict(
        arch=MOE_ARCH, n_layers=cfg.n_layers, n_layers_published=32,
        d_model=cfg.d_model, experts=cfg.moe.num_experts,
        top_k=cfg.moe.top_k, d_ff=cfg.d_ff, vocab=cfg.vocab,
        dtype=cfg.dtype, tp=TP, batch=BATCH, prompt=PROMPT, decode=DECODE,
        init_params_s=init_s, ms_per_token_auto=auto["ms_per_token"],
        ms_per_token_explicit=explicit["ms_per_token"],
        ms_per_token_auto_eager=auto["eager"]["ms_per_token"],
        ms_per_token_explicit_eager=explicit["eager"]["ms_per_token"],
        runs={"auto": _run_record(auto), "explicit": _run_record(explicit)},
        launches=explicit["launches"], launches_per_step=per_step,
        first_step_rel_err=rel, first_step_max_abs_err=diff.abs().max()
        .item(), first_step=first, bf16_rel_tol=BF16_REL_TOL,
        token_agreement=float((explicit["tokens"] == auto["tokens"]).mean()),
        plans=explicit["plans"])
    return record, explicit["params"], _counted(explicit)


def _moe_layer_through_kernel(device, gen, eparams):
    """One full-width MoE layer on a (4, 8, 1, 4096) bf16 hidden state,
    dispatched through the ``moe_alltoall`` plan (executor kernel) and
    through ``ops.all_to_all`` (the all_to_all kernel): bit-equal, as
    the all_to_all only copies. Then 4 decode steps' worth of the 8
    layers through the kernel, with its launch count set to 0 just
    before and read just after."""
    from repro_torch.distributed.moe_parallel import moe_layer_ep
    from repro_torch.kernels import comm_utils, ops
    cfg = _moe_cfg(MOE_LAYERS)
    plan = _moe_plans(device)[TP]["moe_alltoall"]
    moe = eparams["layers"][0]["moe"]                # (tp, groups, ...)
    layers = [{k: v[:, g] for k, v in moe.items()}
              for g in range(cfg.n_layers)]
    # every rank holds the same batch, as in explicit decode
    h = _rand((BATCH, 1, cfg.d_model), torch.bfloat16, gen, device)
    h = h.expand((TP,) + tuple(h.shape)).contiguous()

    def kernel(buf):
        return ops.all_to_all(buf)

    def layer(lp, a2a):
        return moe_layer_ep(lp, h, cfg, plan=a2a)

    want = [layer(lp, plan) for lp in layers]
    got = layer(layers[0], kernel)
    torch.cuda.synchronize()
    check(torch.equal(got, want[0]),
          "MoE layer through ops.all_to_all != through the plan")
    check(plan.hits[plan.buckets[-1]] == 2 * cfg.n_layers,
          f"moe_alltoall bucket hits {plan.hits}")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    comm_utils.LAUNCHES.clear()                 # just before the main path
    e0.record()
    outs = [(g, layer(lp, kernel)) for _ in range(MAIN_DECODE_STEPS)
            for g, lp in enumerate(layers)]
    e1.record()
    torch.cuda.synchronize()
    launches = dict(comm_utils.LAUNCHES)        # read just after
    expect = {"all_to_all": 2 * cfg.n_layers * MAIN_DECODE_STEPS}
    check(launches == expect, f"MoE-layer launches {launches} != {expect}")
    for g, y in outs:
        check(torch.equal(y, want[g]),
              f"layer {g} through the kernel != through the plan")
    return dict(launches=launches, layers=cfg.n_layers,
                decode_steps=MAIN_DECODE_STEPS, outputs_checked=len(outs) + 1,
                ms_per_layer=e0.elapsed_time(e1) / len(outs))


def _moe_f32(device):
    """f32 at full width, 2 layers: explicit and auto greedy tokens equal
    over 16 steps."""
    from repro_torch.models import transformer as tf
    cfg = _moe_cfg(MOE_F32_LAYERS, "float32")
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(3),
                            device=device)
    prompts = np.random.RandomState(3).randint(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)
    auto = _run_engine(cfg, params, prompts, "auto", 16, False)
    explicit = _run_engine(cfg, params, prompts, "explicit", 16, False)
    del params
    torch.cuda.empty_cache()
    equal = bool(np.array_equal(auto["tokens"], explicit["tokens"]))
    rel = ((explicit["last"] - auto["last"]).norm()
           / auto["last"].norm()).item()
    check(equal, "MoE f32 explicit and auto greedy tokens differ")
    return dict(n_layers=cfg.n_layers, tokens_equal=equal, steps=16,
                last_prefill_rel_err=rel)


def _a2a_time(device, gen):
    """The kernel's device time at the MoE dispatch sizes and over the
    per-rank sweep at n=4 (bf16), beside the HBM bound (each rank's input
    read once and its output written once: 2·n·per-rank bytes), the plain
    version and the one-call yardstick the port never calls."""
    from repro_torch.kernels import comm_utils, ops
    n = TP
    d = _moe_cfg(MOE_LAYERS).d_model
    sizes = [(f"moe_c{c}", (n * c, d)) for c in _moe_caps()]
    sizes += list(SWEEP.items())
    rows_out = []
    for label, (rows, cols) in sizes:
        x = _rand((n, rows, cols), torch.bfloat16, gen, device)

        def kern(x=x):
            return ops.all_to_all(x)

        def plain(x=x):
            return ops.all_to_all(x, backend="torch")

        def lib(x=x, rows=rows, cols=cols):
            return x.view(n, n, rows // n, cols).transpose(0, 1).contiguous()

        nbytes = 2 * x.numel() * x.element_size()
        iters = max(3, min(200, int(4e9 // nbytes)))
        k_ms, k_cov = device_ms(kern, iters)
        p_ms, p_cov = device_ms(plain, max(3, iters // 4))
        l_ms, l_cov = device_ms(lib, iters)
        rows_out.append(dict(
            size=label, n=n, rows=rows, cols=cols, dtype="bfloat16",
            rank_bytes=x[0].numel() * x.element_size(),
            blocks_per_rank=comm_utils.workspace("all_to_all", x).blocks,
            ms=k_ms, ms_wall=wall_ms(kern, iters), plain_ms=p_ms,
            library_ms=l_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bytes=nbytes, sleep_covered=dict(kernel=k_cov, plain=p_cov,
                                             library=l_cov)))
        del x
        torch.cuda.empty_cache()
    return rows_out


def phase_moe(device, gen):
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cases, err = _a2a_vs_plain(device, gen)
    main, eparams, exec_launches = _moe_main_path(device)
    layer = _moe_layer_through_kernel(device, gen, eparams)
    del eparams
    torch.cuda.empty_cache()
    f32 = _moe_f32(device)
    timing = _a2a_time(device, gen)
    emit("moe", cases=cases, max_abs_err=err, main_path=main, f32=f32,
         layer_through_kernel=layer, shapes=timing,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         seconds=round(time.perf_counter() - t, 3))
    return err, layer["launches"]["all_to_all"], exec_launches, timing


def _fa_cases():
    """(b, h, h_kv, s, hd, dtype, causal, window, label) of the
    kernel-vs-plain grid: the reference tests' grid, its windows and
    block-skip case, ragged s, KV-head groups, head dims 80 and 256, and
    32 and 96 causal, bidirectional and windowed over KV-head groups 1, 2
    and 4 at a ragged s (label None), and the main path's shapes
    (:func:`_fa_main_shapes`): every head dim of HEAD_DIMS in bf16."""
    f32, bf16 = torch.float32, torch.bfloat16
    out = [(1, 2, 2, s, hd, dt, causal, None)
           for s, hd in ((256, 64), (512, 128)) for dt in (f32, bf16)
           for causal in (True, False)]
    out += [(1, 2, 2, 512, 64, f32, True, w) for w in (128, 256)]
    out.append((2, 1, 1, 1024, 64, f32, True, 128))
    out += [(2, 4, 2, s, 64, dt, causal, w) for s in (12, 200)
            for dt in (f32, bf16)
            for causal, w in ((True, None), (False, None), (True, 64),
                              (False, 64))]
    out += [(2, 8, 8 // r, 300, 128, dt, True, None) for r in (1, 2, 4)
            for dt in (f32, bf16)]
    out += [(2, 4, hkv, 333, hd, dt, causal, w) for hd in (80, 256)
            for dt in (f32, bf16)
            for hkv, causal, w in ((2, True, None), (4, False, None),
                                   (2, True, 100))]
    out += [(2, h, hkv, s, hd, dt, causal, w) for hd in (32, 96)
            for dt in (f32, bf16)
            for h, hkv, s, causal, w in ((4, 4, 333, False, None),
                                         (4, 2, 333, True, None),
                                         (8, 2, 333, True, 100),
                                         (8, 2, 12, False, 64))]
    out = [case + (None,) for case in out]
    out += [shape[:9] for shape in _fa_main_shapes()]
    return out


def _fa_main_shapes():
    """The attention cores of phase 10's main path: (b, h, h_kv, s, hd,
    dtype, causal, window, label, layers per forward)."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    out = []
    for arch, (b, s) in PREFILL.items():
        cfg = configs.get_config(arch)
        wins = tf.layer_windows(cfg)
        for win in sorted(set(wins), key=lambda w: (w is None, w)):
            label = arch if len(set(wins)) == 1 else \
                f"{arch}-{'local' if win else 'global'}"
            out.append((b, cfg.n_heads, cfg.n_kv_heads, s, cfg.hd,
                        torch.bfloat16, cfg.causal, win, label,
                        wins.count(win) * cfg.n_layers // len(wins)))
    return out


def _fa_qkv(b, h, hkv, s, hd, dtype, gen, device):
    return (_rand((b, h, s, hd), dtype, gen, device),
            _rand((b, hkv, s, hd), dtype, gen, device),
            _rand((b, hkv, s, hd), dtype, gen, device))


def _fa_vs_plain(device, gen):
    """Every case of :func:`_fa_cases`, kernel against plain version on
    the same seeded inputs: within FA_TOL elementwise and FA_REL_TOL in
    relative L2. Returns the case count, the largest |err| and relative L2
    error of each dtype, and the relative L2 error of each main shape."""
    from repro_torch.kernels import flash_attention as fa
    errs = {"float32": 0.0, "bfloat16": 0.0}
    rels = dict(errs)
    main_rels = {}
    cases = _fa_cases()
    for b, h, hkv, s, hd, dt, causal, win, label in cases:
        q, k, v = _fa_qkv(b, h, hkv, s, hd, dt, gen, device)
        got = fa.flash_attention(q, k, v, causal=causal, window=win)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        name = str(dt).split(".")[-1]
        errs[name] = max(errs[name],
                         (got.float() - want.float()).abs().max().item())
        rel = _rel(got, want)
        rels[name] = max(rels[name], rel)
        if label is not None:
            main_rels[label] = rel
        tol = FA_TOL[dt]
        what = (f"b={b} h={h}/{hkv} s={s} hd={hd} {dt} causal={causal} "
                f"window={win}")
        check(got.dtype == dt and bool(torch.allclose(
            got.float(), want.float(), atol=tol, rtol=tol)),
            f"flash kernel != plain: {what}")
        check(rel <= FA_REL_TOL[dt],
              f"flash kernel != plain: relative L2 {rel} at {what}")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return len(cases), errs, rels, main_rels


@contextlib.contextmanager
def _plain_attention_calls():
    """Count calls of the plain attention cores (the flash kernel's plain
    version and the model's torch core) while the block runs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import blocks
    calls = {"flash_attention_plain": 0, "_plain_core": 0}
    saved = [(fa, "flash_attention_plain"), (blocks, "_plain_core")]
    originals = [getattr(mod, name) for mod, name in saved]

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for (mod, name), fn in zip(saved, originals):
        setattr(mod, name, counted(name, fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in zip(saved, originals):
            setattr(mod, name, fn)


@contextlib.contextmanager
def _first_cores():
    """Keep the q/k/v of the first kernel call of each window kind (layer
    0, and gemma3-12b's first global layer) while the block runs."""
    from repro_torch.models import blocks
    seen = {}
    launch = blocks.flash_attention

    def keep(q, k, v, *, causal, window, backend=None):
        seen.setdefault(window, (q, k, v, causal))
        return launch(q, k, v, causal=causal, window=window, backend=backend)

    blocks.flash_attention = keep
    try:
        yield seen
    finally:
        blocks.flash_attention = launch


@contextlib.contextmanager
def _first_ssm():
    """Keep the weights and input of the first SSM branch (layer 0 of a
    hybrid model) that a forward runs while the block runs."""
    from repro_torch.models import ssm
    seen = []
    forward = ssm.ssm_forward

    def keep(p, x, cfg, state=None):
        if not seen:
            seen.append((p, x))
        return forward(p, x, cfg, state)

    ssm.ssm_forward = keep
    try:
        yield seen
    finally:
        ssm.ssm_forward = forward


def _ssm_first_layer(cfg, first, cores):
    """The first layer's SSM scan on the forward's own input against the
    sequential recurrence ``h_t = dA_t h_{t-1} + dBx_t`` on the same
    ``(dA, dBx)``, through the same output tail: the final state (f32)
    and the output (bf16) in relative L2. Then device ms of that layer's
    SSM branch (``ssm_forward``), of its scan alone (the scan on copies
    of ``dA``/``dBx``, less the copies) and of its flash launch on its
    own q/k/v, side by side."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import ssm
    (p, x), = first
    with torch.inference_mode():
        out, final = ssm.ssm_forward(p, x, cfg)
        xin, z, dA, dBx, C = ssm.ssm_params(p, x, cfg)
        seq = torch.empty_like(dBx)
        h = torch.zeros_like(dBx[:, 0])
        for t in range(dBx.shape[1]):
            h = dA[:, t] * h + dBx[:, t]
            seq[:, t] = h
        y = ssm._gate(torch.einsum("bsdk,bsk->bsd", seq, C), xin, z, p)
        want = ssm._proj(y.to(x.dtype), p["w_out"])
        rec = dict(shape=list(dA.shape), state_rel_err=_rel(final, h),
                   out_rel_err=_rel(out, want),
                   state_rel_tol=SSM_STATE_REL_TOL,
                   out_rel_tol=SSM_OUT_REL_TOL)
        del seq, y, want, out
        work = (torch.empty_like(dA), torch.empty_like(dBx))

        def copies():
            work[0].copy_(dA)
            work[1].copy_(dBx)

        def scanned():
            copies()
            ssm.scan(*work)

        rec["ssm_forward_ms"] = device_ms(lambda: ssm.ssm_forward(p, x, cfg),
                                          5)[0]
        rec["scan_ms"] = device_ms(scanned, 5)[0] - device_ms(copies, 5)[0]
        q, k, v, causal = cores[cfg.window]
        rec["flash_ms"] = device_ms(lambda: fa.flash_attention(
            q, k, v, causal=causal, window=cfg.window), 5)[0]
        rec["ssm_forward_ms_per_forward"] = rec["ssm_forward_ms"] * \
            cfg.n_layers
        del work, dA, dBx
    torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def _plain_core_as(core):
    """The model's plain attention core replaced by ``core`` while the
    block runs."""
    from repro_torch.models import blocks
    plain = blocks._plain_core
    blocks._plain_core = core
    try:
        yield
    finally:
        blocks._plain_core = plain


def _fault_mask(s, window, device):
    """(s, s) True where the control fault skips a key: rows in the second
    half, in the FAULT_TILE-key tile holding the row's first key in reach
    (0, or the window's first)."""
    q_pos = torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(s, device=device)[None, :]
    lo = (q_pos - window + 1).clamp_min(0) if window else 0 * q_pos
    return (q_pos >= s // 2) & (k_pos // FAULT_TILE == lo // FAULT_TILE)


def _control_core(q, k, v, cfg, *, window, fault=False):
    """Controls for the model's plain attention core, in plain torch, one
    KV head at a time. The kernel's rounding: f32 logits and softmax, the
    unnormalised P rounded to q's dtype for P V, f32 accumulation, divided
    by the f32 row sum. With ``fault``, the same with the keys of
    :func:`_fault_mask` skipped. q (b, h, s, hd), k/v (b, h_kv, s, hd)."""
    from repro_torch.models import blocks
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    mask = blocks._attn_mask(s, s, causal=cfg.causal, window=window,
                             device=q.device)
    if fault:
        mask &= ~_fault_mask(s, window, q.device)
    out = torch.empty_like(q)
    for n in range(k.shape[1]):
        heads = slice(n * g, (n + 1) * g)
        logits = (q[:, heads].float() * hd ** -0.5) @ \
            k[:, n:n + 1].float().transpose(-1, -2)
        logits = torch.where(mask, logits, -1e30)
        pr = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        den = pr.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out[:, heads] = ((pr.to(q.dtype).float() @ v[:, n:n + 1].float())
                         / den).to(q.dtype)
    return out


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _core_controls(cfg, first):
    """On the inputs the forward gave the first layer of each window kind:
    the kernel, the rounding control and the fault control
    (:func:`_control_core`) against the plain version, in relative L2."""
    from repro_torch.kernels import flash_attention as fa
    out = {}
    for win, (q, k, v, causal) in first.items():
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=win)
        got = fa.flash_attention(q, k, v, causal=causal, window=win)
        out[f"window={win}"] = dict(
            shape=list(q.shape), kv_heads=k.shape[1],
            kernel_rel_err=_rel(got, want),
            rounding_rel_err=_rel(_control_core(q, k, v, cfg, window=win),
                                  want),
            fault_rel_err=_rel(_control_core(q, k, v, cfg, window=win,
                                             fault=True), want))
    return out


@contextlib.contextmanager
def _pinned_layers(n_layers, steps, pin=None):
    """Record the input of every ``rms_norm`` the decode step calls (per
    layer ``ln_attn`` and ``ln_mlp``, then ``ln_f``: 2L + 1 a step, step
    after step), and with ``pin`` (such a record, of another run) feed
    each layer's norms the recorded input instead of the run's own
    residual (broadcast over the ranks of an explicit run); ``ln_f``
    keeps the run's own. A pinned run computes every layer on the
    recorded run's layer inputs, so the difference of its logits is the
    sum of each layer's own, not compounded through the layers above.
    Checks that the run made ``steps`` (steps or forwards) of 2L + 1
    norms and that each pinned input has the trailing shape of the one
    it replaces, so a norm call more or less cannot misalign the runs."""
    from repro_torch.models import transformer as tf
    norm = tf.rms_norm
    seen = []
    per_step = 2 * n_layers + 1

    def hooked(x, scale, eps=1e-6):
        i = len(seen)
        seen.append(x)
        if pin is not None and i % per_step < 2 * n_layers:
            check(pin[i].shape == x.shape[x.dim() - pin[i].dim():],
                  f"pinned norm input {i}: {tuple(pin[i].shape)} for "
                  f"{tuple(x.shape)}")
            x = pin[i].expand(x.shape)
        return norm(x, scale, eps)

    tf.rms_norm = hooked
    try:
        yield seen
    finally:
        tf.rms_norm = norm
    check(len(seen) == steps * per_step,
          f"{len(seen)} norm calls in {steps} steps, want {per_step} each")


def _pinned_forward(params, cfg, tokens):
    """The kernel's forward, and the rounding and fault controls, each
    layer-pinned (:func:`_pinned_layers`) to the plain core's forward:
    every layer computed on the plain forward's layer inputs, so each
    reading is the sum of the layers' own differences, not their
    compounding. Relative L2 of the final hidden states (and of the last
    position's logits) against the plain forward's."""
    from repro_torch.models import transformer as tf
    out = {}
    with torch.inference_mode():
        with _pinned_layers(cfg.n_layers, 1) as record:
            plain = tf.forward(params, cfg, tokens, backend="torch")
        with _pinned_layers(cfg.n_layers, 1, record):
            hidden = tf.forward(params, cfg, tokens)
        out["hidden_rel_err"] = _rel(hidden, plain)
        out["last_logits_rel_err"] = _rel(
            tf.logits_fn(params, cfg, hidden[:, -1:]),
            tf.logits_fn(params, cfg, plain[:, -1:]))
        del hidden
        for name, fault in (("rounding", False), ("fault", True)):
            with _plain_core_as(functools.partial(_control_core,
                                                  fault=fault)), \
                    _pinned_layers(cfg.n_layers, 1, record):
                ctl = tf.forward(params, cfg, tokens, backend="torch")
            out[f"{name}_hidden_rel_err"] = _rel(ctl, plain)
            del ctl
    del record, plain
    torch.cuda.empty_cache()
    return out


def _prefill_main_path(device):
    """Each model at full width and depth on seeded random bf16 weights:
    ``make_prefill_step`` and ``forward`` each launch the kernel once per
    layer (counted from 0 around each) and never the plain core; the
    output within PREFILL_REL_TOL of the same forward with the plain core;
    the first layer's core within FA_REL_TOL on its own inputs; the
    controls (:func:`_control_core`): the kernel's rounding in plain torch
    within both limits, the fault past the core's (end to end, bf16
    rounding through the layers alone reads 0.02-0.03, so the fault's
    reading there is kept, not held); prefill ms per forward (median of
    PREFILL_REPEATS step calls). A model of PREFILL_LAYER_PINNED
    (random-weight hymba-1.5b amplifies bf16 rounding through its 32
    layers) has its forward gates held layer-pinned
    (:func:`_pinned_forward`) and its unpinned readings kept."""
    from repro_torch import configs
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.distributed.step import make_prefill_step
    from repro_torch.kernels import comm_utils
    from repro_torch.kernels.flash_attention import KERNEL
    from repro_torch.models import transformer as tf
    out, launches = {}, 0
    for i, (arch, (b, s)) in enumerate(PREFILL.items()):
        cfg = configs.get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=device).manual_seed(10 + i)
        params = tf.init_params(cfg, gen, device=device)
        if cfg.frontend != "none":
            tokens = torch.randn((b, s, cfg.d_model), generator=gen,
                                 device=device)
        else:
            tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                   device=device)
        step = make_prefill_step(cfg)
        torch.cuda.synchronize()
        counts = {}
        with _plain_attention_calls() as plain_calls, \
                _first_cores() as first, _first_ssm() as first_ssm:
            for name, run in (
                    ("step", lambda: step(params, tokens)),
                    ("forward", lambda: tf.forward(params, cfg, tokens))):
                comm_utils.LAUNCHES.clear()        # every count to 0
                CudaExecutor.launches = 0
                result = run()
                torch.cuda.synchronize()
                counts[name] = dict(comm_utils.LAUNCHES)   # read just after
                check(counts[name] == {KERNEL: cfg.n_layers},
                      f"{arch} {name}: launches {counts[name]}, want "
                      f"{cfg.n_layers} of {KERNEL}")
                check(CudaExecutor.launches == 0, "executor launched")
                if name == "step":
                    last = result
                else:
                    hidden = result
        check(not any(plain_calls.values()),
              f"{arch}: plain attention ran {plain_calls}")
        launches += sum(c[KERNEL] for c in counts.values())
        with torch.inference_mode():
            plain_hidden = tf.forward(params, cfg, tokens, backend="torch")
            plain_last = tf.logits_fn(params, cfg, plain_hidden[:, -1:])[:, 0]
        check(last.shape == (b, cfg.vocab) and last.dtype == torch.float32,
              f"{arch}: step output {tuple(last.shape)} {last.dtype}")
        check(hidden.shape == (b, s, cfg.d_model), f"{arch}: hidden shape")
        for t in (last, hidden):
            check(bool(torch.isfinite(t).all()), f"{arch}: non-finite")
        rec = dict(batch=b, tokens=s, n_layers=cfg.n_layers,
                   d_model=cfg.d_model, heads=cfg.n_heads,
                   kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                   causal=cfg.causal, window=cfg.window,
                   launches=counts, plain_calls=plain_calls,
                   hidden_rel_err=_rel(hidden, plain_hidden),
                   last_logits_rel_err=_rel(last, plain_last),
                   argmax_agree=float((last.argmax(-1)
                                       == plain_last.argmax(-1)).float()
                                      .mean()))
        if cfg.family == "encoder":     # the encoder's product: all frames
            with torch.inference_mode():
                logits = tf.logits_fn(params, cfg, hidden)
                plain_logits = tf.logits_fn(params, cfg, plain_hidden)
            check(bool(torch.isfinite(logits).all()), f"{arch}: logits")
            rec["logits_rel_err"] = _rel(logits, plain_logits)
            del logits, plain_logits
        rec["cores"] = _core_controls(cfg, first)
        if cfg.family == "hybrid":
            rec["ssm"] = _ssm_first_layer(cfg, first_ssm, first)
            check(rec["ssm"]["state_rel_err"] <= SSM_STATE_REL_TOL
                  and rec["ssm"]["out_rel_err"] <= SSM_OUT_REL_TOL,
                  f"{arch}: SSM scan vs the sequential recurrence "
                  f"{rec['ssm']}")
        del first, first_ssm
        with torch.inference_mode():
            for name, fault in (("rounding", False), ("fault", True)):
                with _plain_core_as(functools.partial(_control_core,
                                                      fault=fault)):
                    ctl = tf.forward(params, cfg, tokens, backend="torch")
                rec[f"{name}_hidden_rel_err"] = _rel(ctl, plain_hidden)
                if not fault:
                    rec["hidden_rel_err_vs_rounding"] = _rel(hidden, ctl)
                del ctl
        if arch in PREFILL_LAYER_PINNED:
            rec["pinned"] = _pinned_forward(params, cfg, tokens)
        print(json.dumps(dict(phase="prefill_model", arch=arch, **rec)),
              flush=True)
        held = rec.get("pinned", rec)
        for key in ("hidden_rel_err", "last_logits_rel_err",
                    "logits_rel_err", "rounding_hidden_rel_err"):
            if key in held:
                check(held[key] <= PREFILL_REL_TOL,
                      f"{arch}: {key} {held[key]} > {PREFILL_REL_TOL}"
                      f"{' (layer-pinned)' if held is not rec else ''}")
        for key, core in rec["cores"].items():
            check(core["kernel_rel_err"] <= FA_REL_TOL[torch.bfloat16],
                  f"{arch} {key}: kernel vs plain on the layer's own "
                  f"inputs, relative L2 {core['kernel_rel_err']}")
            check(core["fault_rel_err"] > FA_REL_TOL[torch.bfloat16],
                  f"{arch} {key}: the control fault reads "
                  f"{core['fault_rel_err']}")
        del plain_hidden, hidden
        times = []
        for _ in range(PREFILL_REPEATS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            step(params, tokens)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        ms = float(np.median(times))
        rec.update(prefill_ms=ms, prefill_ms_all=times,
                   tokens_per_s=b * s / ms * 1e3,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        out[arch] = rec
        del params, tokens, step
        torch.cuda.empty_cache()
    return out, launches


def _fused_vs_stepwise(device):
    """qwen3-1.7b, batch 8 x 128 tokens, auto mode: the fused step's
    last-position logits against ``Engine.prefill`` token by token, in
    bf16 at full depth and in f32 at FUSED_F32_LAYERS layers."""
    from repro_torch import configs
    from repro_torch.distributed.step import make_prefill_step
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Engine, ServeConfig
    out = {}
    for dtype, n_layers, tol in (("bfloat16", None, PREFILL_REL_TOL),
                                 ("float32", FUSED_F32_LAYERS,
                                  FUSED_F32_TOL)):
        cfg = configs.get_config(ARCH)
        cfg = dataclasses.replace(cfg, dtype=dtype,
                                  n_layers=n_layers or cfg.n_layers)
        params = tf.init_params(cfg, torch.Generator(device=device)
                                .manual_seed(20), device=device)
        prompts = np.random.RandomState(20).randint(
            0, cfg.vocab, (FUSED_BATCH, FUSED_TOKENS))
        fused = make_prefill_step(cfg)(params, prompts)
        eng = Engine(cfg, params, ServeConfig(batch=FUSED_BATCH,
                                              max_kv=2 * FUSED_TOKENS))
        stepwise = eng.prefill(prompts)
        torch.cuda.synchronize()
        check(eng.graph is not None and eng.graph.replays == FUSED_TOKENS,
              "token by token: not every step was a graph replay")
        rel = _rel(fused, stepwise)
        agree = bool(torch.equal(fused.argmax(-1), stepwise.argmax(-1)))
        out[dtype] = dict(n_layers=cfg.n_layers, rel_err=rel,
                          max_abs_err=(fused - stepwise.float()).abs().max()
                          .item(), argmax_equal=agree, tol=tol,
                          graph_replays=eng.graph.replays)
        check(rel <= tol, f"fused vs token by token, {dtype}: rel {rel}")
        if dtype == "float32":
            check(agree, "fused vs token by token, f32: argmax differs")
        del eng, params
        torch.cuda.empty_cache()
    return out


def _attention_pairs(s, causal, window) -> int:
    """Unmasked (query, key) pairs of one head."""
    q = np.arange(s)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    hi = q + 1 if causal else np.full_like(q, s)
    return int((hi - lo).sum())


def _fa_time(device, gen):
    """Per main-path shape: the kernel's device time per launch beside its
    bound (the larger of 4 * hd FLOPs per unmasked pair and head over the
    bf16 peak, and q, k, v read once and o written once over HBM), its
    wall time per call back to back (the host's tensor-map encoding
    included), the plain version, and the library yardstick the port
    never calls (``scaled_dot_product_attention``; a boolean mask for a
    window), with the kernel's factor against it."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import blocks
    rows = []
    for b, h, hkv, s, hd, dt, causal, win, label, layers in \
            _fa_main_shapes():
        q, k, v = _fa_qkv(b, h, hkv, s, hd, dt, gen, device)
        if win is None:
            def lib(q=q, k=k, v=v, causal=causal):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
        else:
            mask = blocks._attn_mask(s, s, causal=causal, window=win,
                                     device=device)

            def lib(q=q, k=k, v=v, mask=mask):
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
        def kern(q=q, k=k, v=v, causal=causal, win=win):
            return fa.flash_attention(q, k, v, causal=causal, window=win)

        k_ms, k_cov = device_ms(kern, 20)
        p_ms, p_cov = device_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal, window=win), 3)
        l_ms, l_cov = device_ms(lib, 20)
        pairs = _attention_pairs(s, causal, win)
        flops = 4 * b * h * hd * pairs
        nbytes = (2 * b * h + 2 * b * hkv) * s * hd * q.element_size()
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        rows.append(dict(
            shape=label, b=b, h=h, h_kv=hkv, s=s, hd=hd, causal=causal,
            window=win, layers_per_forward=layers, ms=k_ms,
            ms_wall=wall_ms(kern, 20), plain_ms=p_ms, library_ms=l_ms,
            vs_library=k_ms / l_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
            ops_ms=t_ops * 1e3, bytes_ms=t_bytes * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            flops=flops, bytes=nbytes, tflops_per_s=flops / k_ms / 1e9,
            sleep_covered=dict(kernel=k_cov, plain=p_cov, library=l_cov)))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def phase_prefill(device, gen):
    t = time.perf_counter()
    torch.cuda.empty_cache()
    cases, errs, rels, main_rels = _fa_vs_plain(device, gen)
    main, launches = _prefill_main_path(device)
    fused = _fused_vs_stepwise(device)
    timing = _fa_time(device, gen)
    emit("prefill", cases=cases, max_abs_err=errs, tol=
         {str(k).split(".")[-1]: v for k, v in FA_TOL.items()},
         max_rel_err=rels, main_shape_rel_err=main_rels, rel_tol=
         {str(k).split(".")[-1]: v for k, v in FA_REL_TOL.items()},
         main_path=main, launches=launches, fused_vs_stepwise=fused,
         shapes=timing, seconds=round(time.perf_counter() - t, 3))
    return max(errs.values()), launches, timing


# ---------------------------------------------------------------------------
# phase 11: hierarchical 2PH AllReduce and AllGather-matmul
# ---------------------------------------------------------------------------
def _rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in f64, a rank and 2^26 elements at a
    time (``want`` broadcasts: one reduced buffer for every rank)."""
    num = den = 0.0
    step = 1 << 26
    for r in range(got.shape[0]):
        g = got[r].reshape(-1)
        w = (want[r] if want.dim() == got.dim() else want).reshape(-1)
        for i in range(0, g.numel(), step):
            wi = w[i:i + step].double()
            num += float((g[i:i + step].double() - wi).square().sum())
            den += float(wi.square().sum())
    return (num / den) ** 0.5 if den else float(num > 0)


def _max_abs_err(got, want) -> float:
    """max |got - want| in f64, a rank at a time."""
    return max((got[r].double() - want[r].double()).abs().max().item()
               for r in range(got.shape[0]))


def _2ph_fault(x, nn):
    """Plain torch: 2PH with the other nodes dropped from rank 0's phase-2
    fold, so node 0's ranks hold chunk 0 with their own node's sum only
    (rank 0's phase-1 fold, in its rotated order)."""
    from repro_torch.kernels.allreduce_2ph import all_reduce_2ph_plain
    ranks, total, cols = x.shape
    ln = ranks // nn
    y = all_reduce_2ph_plain(x, node_size=nn).reshape(
        ranks, ln, total // ln, cols).clone()
    xs = x.reshape(ranks, ln, total // ln, cols)
    acc = xs[0, 0]
    for i in range(1, ln):
        acc = acc + xs[i, 0]
    y[:ln, 0] = acc
    return y.reshape(ranks, total, cols)


def _agmm_fault(x, w, out_dtype):
    """Plain torch: rank 0 multiplies the chunk of slot 1 into row block
    0 (a chunk taken from the wrong slot)."""
    from repro_torch.kernels.collective_matmul import allgather_matmul_plain
    n, rows, _ = x.shape
    y = allgather_matmul_plain(x, w, out_dtype=out_dtype).reshape(
        n, n, rows, w.shape[-1]).clone()
    w0 = w[0] if w.dim() == 3 else w
    y[0, 0] = (x[1].float() @ w0.float()).to(out_dtype)
    return y.reshape(n, n * rows, w.shape[-1])


def _2ph_vs_plain(gen, device):
    """The 2PH kernel against its plain version, bit-equal, over the grid
    and at chunks a block takes in several sub-tiles (each case two calls
    back to back against the plain version twice), and the fault
    control's reading on one case. Returns the grid's cases, the
    sub-tiled cases with their sub-tiles a block, the largest error and
    the fault's."""
    from repro_torch.kernels import comm_utils, ops
    from repro_torch.kernels.allreduce_2ph import scratch_geometry
    cases, err, subtiled = 0, 0.0, []

    def held(x, nn, what):
        nonlocal err
        y = ops.all_reduce(x, algo="2ph", node_size=nn)
        y2 = ops.all_reduce(y, algo="2ph", node_size=nn)
        p = ops.all_reduce(x, algo="2ph", node_size=nn, backend="torch")
        p2 = ops.all_reduce(p, algo="2ph", node_size=nn, backend="torch")
        torch.cuda.synchronize()
        e = (y.double() - p.double()).abs().max().item()
        err = max(err, e)
        check(torch.equal(y, p) and torch.equal(y2, p2),
              f"2PH kernel != plain: {what} {x.dtype} (max |err| {e})")

    for nn, ln in HIER_GRIDS:
        for rows in HIER_ROWS:
            for cols in HIER_COLS:
                for dtype in (torch.float32, torch.bfloat16):
                    x = _rand((nn * ln, ln * rows, cols), dtype, gen, device)
                    held(x, nn, f"{nn}x{ln} rows={rows} cols={cols}")
                    cases += 2
        for dtype in (torch.float32, torch.bfloat16):
            x = _rand((nn * ln, ln * HIER_SUBTILED_ROWS, 2048), dtype, gen,
                      device)
            held(x, nn, f"{nn}x{ln} rows={HIER_SUBTILED_ROWS} cols=2048")
            blocks = comm_utils.workspace(f"all_reduce_2ph/nodes{nn}",
                                          x).blocks
            geo = scratch_geometry(nn, ln, HIER_SUBTILED_ROWS * 2048,
                                   x.element_size(), blocks * nn * ln)
            subtiled.append(dict(grid=f"{nn}x{ln}", dtype=str(dtype)[6:],
                                 blocks_per_rank=blocks,
                                 subtiles=geo.subtiles, calls=2))
            check(geo.subtiles > 1, f"2PH sub-tiled case {subtiled[-1]} "
                  f"has one sub-tile a block")
            del x
        torch.cuda.empty_cache()
    x = _rand((8, 4 * 8, 128), torch.float32, gen, device)
    fault = (_2ph_fault(x, 2).double() - ops.all_reduce(
        x, algo="2ph", node_size=2).double()).abs().max().item()
    check(fault > 0, "2PH fault control reads bit-equal")
    return cases, subtiled, err, fault


def _agmm_vs_plain(gen, device):
    """The AllGather-matmul kernel against its plain version over the
    grid, rel. L2 within AGMM_REL_TOL of the output type, and bf16 out
    bit-equal to the kernel's f32 out rounded; two calls in a row (the
    second on every rank's first row block, K = F); the fault control's
    reading."""
    from repro_torch.kernels import ops
    cases, errs, rels = 0, {}, {}

    def held(x, w, odt, what):
        nonlocal cases
        y = ops.fused_allgather_matmul(x, w, out_dtype=odt)
        p = ops.fused_allgather_matmul(x, w, out_dtype=odt, backend="torch")
        y32 = (ops.fused_allgather_matmul(x, w, out_dtype=torch.float32)
               if (x.dtype, odt) == (torch.bfloat16,) * 2 else None)
        torch.cuda.synchronize()
        key = f"{str(x.dtype)[6:]}->{str(odt)[6:]}"
        rel = _rel_l2(y, p)
        errs[key] = max(errs.get(key, 0.0),
                        (y.double() - p.double()).abs().max().item())
        rels[key] = max(rels.get(key, 0.0), rel)
        check(y.shape == p.shape and y.dtype == p.dtype
              and rel <= AGMM_REL_TOL[odt],
              f"AllGather-matmul kernel vs plain: {what} {key} rel. L2 "
              f"{rel} > {AGMM_REL_TOL[odt]}")
        check(y32 is None or torch.equal(y, y32.to(odt)),
              f"AllGather-matmul bf16 out != its f32 out rounded: {what}")
        cases += 1
        return y, p

    pairs = ((torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.float32))
    for n in AGMM_GRID["n"]:
        for rows in AGMM_GRID["rows"]:
            for k in AGMM_GRID["k"]:
                for f in AGMM_GRID["f"]:
                    for per_rank in (False, True):
                        for dt, odt in pairs:
                            x = _rand((n, rows, k), dt, gen, device)
                            w = _rand(((n,) if per_rank else ()) + (k, f),
                                      dt, gen, device)
                            held(x, w, odt, f"n={n} rows={rows} K={k} F={f} "
                                 f"per_rank={per_rank}")
                            del x, w
        torch.cuda.empty_cache()
    for n in AGMM_GRID["n"]:
        for rows in AGMM_GRID["rows"][:2]:
            for per_rank in (False, True):
                for dt in (torch.bfloat16, torch.float32):
                    x = _rand((n, rows, 128), dt, gen, device)
                    w = _rand(((n,) if per_rank else ()) + (128, 128), dt,
                              gen, device)
                    y1, p1 = held(x, w, dt, f"twice, first n={n}")
                    held(y1[:, :rows].contiguous(), w, dt,
                         f"twice, second n={n}")
    from repro_torch.kernels.collective_matmul import regime
    edges = []
    for n, rows, k, f in AGMM_EDGES:
        for per_rank in (False, True):
            for dt, odt in pairs:
                x = _rand((n, rows, k), dt, gen, device)
                w = _rand(((n,) if per_rank else ()) + (k, f), dt, gen,
                          device)
                held(x, w, odt, f"edge n={n} rows={rows} K={k} F={f} "
                     f"per_rank={per_rank}")
        edges.append(dict(n=n, rows=rows, K=k, F=f, regime=regime(n, rows)))
    check({e["regime"] for e in edges} == {"decode", "prefill"},
          f"regime cases {edges}")
    x = _rand((4, 64, 2048), torch.bfloat16, gen, device)
    w = _rand((4, 2048, 512), torch.bfloat16, gen, device)
    p = ops.fused_allgather_matmul(x, w, backend="torch")
    fault = _rel_l2(_agmm_fault(x, w, torch.bfloat16), p)
    check(fault > AGMM_REL_TOL[torch.bfloat16],
          f"AllGather-matmul fault control reads {fault} inside the gate")
    return cases, errs, rels, fault, edges


def _hier_exact(device, tmp):
    """Integer-valued f32: the hierarchical plan replay loaded from its
    exported JSON, the 2PH kernel, the flat nn*L plan and the plain sum,
    bit-equal at 2 x 4 and 4 x 4."""
    from repro_torch.core.comm import (Communicator, HierarchicalCommunicator,
                                       export_plan_set, load_plan_set)
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.kernels import ops
    out = []
    for nn, ln in ((2, 4), (4, 4)):
        planner = HierarchicalCommunicator("local", "node", local_n=ln,
                                           node_n=nn, device=device,
                                           backend="torch")
        shapes = {f"r{ln * r}c{c}": (ln * r, c) for r, c in ((8, 128),
                                                             (37, 2048))}
        path = tmp / f"exact{nn}x{ln}"
        export_plan_set({k: planner.compile(s, torch.float32)
                         for k, s in shapes.items()}, path)
        loaded = load_plan_set(path, device=device)
        flat = Communicator("x", n=nn * ln, device=device)
        for name, (rows, cols) in shapes.items():
            g = torch.Generator(device=device).manual_seed(rows * cols)
            x = torch.randint(-8, 8, (nn * ln, rows, cols), generator=g,
                              device=device).float()
            c0 = CudaExecutor.launches
            hier = loaded[name](x)
            launches = CudaExecutor.launches - c0
            kern = ops.all_reduce(x, algo="2ph", node_size=nn)
            fl = flat.compile("all_reduce", (rows, cols), torch.float32)(x)
            want = x.sum(0, keepdim=True).expand_as(x)
            torch.cuda.synchronize()
            check(launches == 3, f"hierarchical replay took {launches} "
                  f"launches, not 3")
            check(torch.equal(hier, want) and torch.equal(kern, want)
                  and torch.equal(fl, want),
                  f"{nn}x{ln} {name}: plan, kernel, flat and sum differ")
            out.append(dict(grid=f"{nn}x{ln}", rows=rows, cols=cols,
                            algo=loaded[name].algo, flat_algo=flat.compile(
                                "all_reduce", (rows, cols),
                                torch.float32).algo, bit_equal=True))
    return out


def _grad_leaves():
    """qwen3-1.7b's gradient as the explicit trainer hands it to
    hierarchical_all_reduce: every leaf reshaped to (-1, last), a 1-D
    leaf to (-1, 1), in the bf16 wire type."""
    from repro_torch import configs
    cfg = configs.get_config(ARCH)
    d, nl, hd = cfg.d_model, cfg.n_layers, cfg.head_dim
    return {"embed": (cfg.vocab, d), "unembed": (d, cfg.vocab),
            "ln_f": (d, 1), "ln_attn": (nl, d), "ln_mlp": (nl, d),
            "wq": (nl * d * cfg.n_heads, hd),
            "wk": (nl * d * cfg.n_kv_heads, hd),
            "wv": (nl * d * cfg.n_kv_heads, hd),
            "wo": (nl * cfg.n_heads * hd, d), "q_norm": (nl, hd),
            "k_norm": (nl, hd), "w_gate": (nl * d, cfg.d_ff),
            "w_up": (nl * d, cfg.d_ff), "w_down": (nl * cfg.d_ff, d)}


def _leaf(name, shape, device):
    """A leaf's seeded bf16 payload on every rank of the grid."""
    g = torch.Generator(device=device).manual_seed(
        sorted(_grad_leaves()).index(name))
    return torch.randn((HIER_NN * HIER_L,) + shape, generator=g,
                       device=device).to(torch.bfloat16)


def _f64_sum(x):
    s = x[0].double()
    for r in range(1, x.shape[0]):
        s += x[r]
    return s


def _agmm_main_shapes():
    """(label, n, rows a rank, K, F) of qwen3-1.7b's TP=4 projections:
    prefill (8 x 2048 tokens, sequence-sharded) and decode (batch 8) into
    the column shards of w_gate and wq."""
    from repro_torch import configs
    cfg = configs.get_config(ARCH)
    f_gate, f_q = cfg.d_ff // TP, cfg.n_heads * cfg.head_dim // TP
    pre, dec = AGMM_PREFILL_TOKENS // TP, BATCH // TP
    return [("prefill_w_gate", TP, pre, cfg.d_model, f_gate),
            ("prefill_wq", TP, pre, cfg.d_model, f_q),
            ("decode_w_gate", TP, dec, cfg.d_model, f_gate),
            ("decode_wq", TP, dec, cfg.d_model, f_q)]


def _hier_main_path(device, tmp):
    """The slice's main path with the launch counts set to 0 just before
    and read just after: the 14 gradient leaves through their loaded plan
    sets (three executor launches a replay) and through ops.all_reduce
    (algo '2ph', one launch each), then the AllGather-matmul at its four
    main shapes in both output types. Every output is checked here: each
    leaf's plan replay bit-equal to the same plan file replayed by the
    plain executor (the same groups and stride), the kernel bit-equal to
    its plain version, both within LEAF_REL_TOL of the f64 sum.

    The plans are compiled on the plain backend (no device state) and
    exported one leaf to a plan set, as a planner ships them; each set is
    loaded, which allocates its executors' scratch, just before its leaf
    runs and dropped after: all 14 at once would hold about 49 GB."""
    from repro_torch.core.comm import (HierarchicalCommunicator,
                                       export_plan_set, load_plan_set)
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.kernels import comm_utils, ops
    leaves = _grad_leaves()
    planner = HierarchicalCommunicator("local", "node", local_n=HIER_L,
                                       node_n=HIER_NN, device=device,
                                       backend="torch")
    for k, shape in leaves.items():
        export_plan_set({k: planner.compile(shape, torch.bfloat16)},
                        tmp / "grad_plans" / k)
    mm_inputs = {}
    for label, n, rows, k, f in _agmm_main_shapes():
        g = torch.Generator(device=device).manual_seed(rows * f)
        mm_inputs[label] = (
            torch.randn((n, rows, k), generator=g, device=device).to(
                torch.bfloat16),
            (torch.randn((n, k, f), generator=g, device=device)
             / k ** 0.5).to(torch.bfloat16))
    recs, mm_recs = [], []
    torch.cuda.synchronize()
    CudaExecutor.launches = 0                   # just before the main path
    comm_utils.LAUNCHES.clear()
    for name, shape in leaves.items():
        plan = load_plan_set(tmp / "grad_plans" / name, device=device)[name]
        x = _leaf(name, shape, device)
        y_plan = plan(x)
        y_kern = ops.all_reduce(x, algo="2ph", node_size=HIER_NN)
        torch.cuda.synchronize()
        # checks (no kernel launches: the plain version and f64 sums)
        want = _f64_sum(x)
        rec = dict(leaf=name, rows=shape[0], cols=shape[1],
                   rank_bytes=x[0].numel() * x.element_size(),
                   algo=plan.algo, pad=plan.pad,
                   plan_rel_l2=_rel_l2(y_plan, want),
                   kernel_rel_l2=_rel_l2(y_kern, want))
        del plan
        torch.cuda.empty_cache()
        y_torch = load_plan_set(tmp / "grad_plans" / name, device=device,
                                backend="torch")[name](x)
        rec["plan_max_abs_err_plain"] = _max_abs_err(y_plan, y_torch)
        rec["plan_bit_equal_plain"] = torch.equal(y_plan, y_torch)
        del y_plan, y_torch
        torch.cuda.empty_cache()
        rec["kernel_bit_equal_plain"] = torch.equal(
            y_kern, ops.all_reduce(x, algo="2ph", node_size=HIER_NN,
                                   backend="torch"))
        if name == FAULT_LEAF:
            rec["fault_rel_l2"] = _rel_l2(_2ph_fault(x, HIER_NN), want)
        check(rec["kernel_bit_equal_plain"],
              f"2PH kernel != plain on leaf {name}")
        check(rec["plan_bit_equal_plain"],
              f"hierarchical plan replay != plain executor on leaf {name} "
              f"(max |err| {rec['plan_max_abs_err_plain']})")
        check(rec["plan_rel_l2"] <= LEAF_REL_TOL
              and rec["kernel_rel_l2"] <= LEAF_REL_TOL,
              f"leaf {name}: rel. L2 to the f64 sum {rec}")
        recs.append(rec)
        del x, y_kern, want
        torch.cuda.empty_cache()
    for label, n, rows, k, f in _agmm_main_shapes():
        x, w = mm_inputs[label]
        ys = {}
        for odt in (torch.bfloat16, torch.float32):
            y = ys[odt] = ops.fused_allgather_matmul(x, w, out_dtype=odt)
            p = ops.fused_allgather_matmul(x, w, out_dtype=odt,
                                           backend="torch")
            rel = _rel_l2(y, p)
            mm_recs.append(dict(shape=label, out=str(odt)[6:], rel_l2=rel,
                                max_abs_err=(y.double() - p.double()).abs()
                                .max().item()))
            check(bool(torch.isfinite(y.float()).all())
                  and rel <= AGMM_REL_TOL[odt],
                  f"AllGather-matmul {label} {odt}: rel. L2 {rel}")
        rounded = torch.equal(ys[torch.bfloat16],
                              ys[torch.float32].to(torch.bfloat16))
        mm_recs[-2]["equals_f32_out_rounded"] = rounded
        check(rounded, f"AllGather-matmul {label}: bf16 out != its f32 out "
              f"rounded")
        del ys
    torch.cuda.synchronize()
    launches = dict(comm_utils.LAUNCHES)        # read just after
    executor = CudaExecutor.launches
    expect = {"all_reduce_2ph": len(leaves),
              "allgather_matmul": 2 * len(mm_inputs)}
    check(launches == expect, f"main-path launches {launches} != {expect}")
    check(executor == 3 * len(leaves),
          f"{executor} executor launches for {len(leaves)} hierarchical "
          f"replays, not 3 each")
    fault = next(r["fault_rel_l2"] for r in recs if "fault_rel_l2" in r)
    check(fault > LEAF_REL_TOL, f"2PH fault control reads {fault}")
    return recs, mm_recs, dict(launches, executor=executor)


def _hier_time(device, tmp):
    """Per gradient leaf: the 2PH kernel's device time and wall time, the
    plan replay's (three executor launches) and the same plan's on the
    plain executor, the plain 2PH version's and the yardstick's (x.sum(0)
    expanded, which the port never calls), beside the bound: every
    rank's input read once and output written once over HBM. Beside it,
    the bytes the kernel moves by its own count
    (kernels/allreduce_2ph.py:traffic_bytes, over all ranks) and the rate
    they imply, and the device memory one kernel call allocates beyond
    its input (its output, the partials and, at the first call, the
    flags)."""
    from repro_torch.core.comm import load_plan_set
    from repro_torch.core.executor import THREADS
    from repro_torch.kernels import comm_utils, ops
    from repro_torch.kernels.allreduce_2ph import traffic_bytes
    rows_out = []
    for name, shape in _grad_leaves().items():
        x = _leaf(name, shape, device)
        plan = load_plan_set(tmp / "grad_plans" / name, device=device)[name]
        nbytes = 2 * x.numel() * x.element_size()
        rank_bytes = x[0].numel() * x.element_size()
        moved = x.shape[0] * sum(traffic_bytes(HIER_NN, HIER_L, rank_bytes))
        iters = max(2, min(50, int(2e9 // nbytes)))

        def kern(x=x):
            return ops.all_reduce(x, algo="2ph", node_size=HIER_NN)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
        kern()
        torch.cuda.synchronize()
        call_gb = (torch.cuda.max_memory_allocated(device) - before) / 1e9

        def plain(x=x):
            return ops.all_reduce(x, algo="2ph", node_size=HIER_NN,
                                  backend="torch")

        def lib(x=x):
            return x.sum(0, keepdim=True).expand_as(x).contiguous()

        k_ms, k_cov = device_ms(kern, iters)
        k_wall = wall_ms(kern, iters)
        r_ms, r_cov = device_ms(lambda: plan(x), max(1, iters // 4))
        # blocks a rank and threads of the RS, AR and AG launches
        phases = [p.executor for p in (plan.rs_plan, plan.ar_plan,
                                       plan.ag_plan)]
        plan_blocks = [e.blocks for e in phases]
        plan_threads = [THREADS] * len(phases)
        del plan, phases
        torch.cuda.empty_cache()
        plan = load_plan_set(tmp / "grad_plans" / name, device=device,
                             backend="torch")[name]
        rp_ms, rp_cov = device_ms(lambda: plan(x), max(1, iters // 4))
        del plan
        torch.cuda.empty_cache()
        p_ms, p_cov = device_ms(plain, max(1, iters // 4))
        l_ms, l_cov = device_ms(lib, iters)
        rows_out.append(dict(
            leaf=name, rows=shape[0], cols=shape[1], ranks=x.shape[0],
            rank_bytes=rank_bytes,
            blocks_per_rank=comm_utils.workspace(
                f"all_reduce_2ph/nodes{HIER_NN}", x).blocks,
            ms=k_ms, ms_wall=k_wall, plan_ms=r_ms, plan_plain_ms=rp_ms,
            plan_blocks_per_rank=plan_blocks, plan_threads=plan_threads,
            plain_ms=p_ms, library_ms=l_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
            moved_bytes=moved, moved_per_bound=moved / nbytes,
            moved_tb_per_s=moved / k_ms / 1e9, call_alloc_gb=call_gb,
            sleep_covered=dict(kernel=k_cov, plan=r_cov, plan_plain=rp_cov,
                               plain=p_cov, library=l_cov)))
        del x
        torch.cuda.empty_cache()
    return rows_out


def _agmm_time(device, gen):
    """Per main shape and output type: the AllGather-matmul kernel's
    device and wall time, the plain version's, and the yardstick's (one
    torch.matmul of the gathered rows by every rank's w, bf16 out, which
    the port never calls), beside the bound: the larger of 2 n (n rows) K
    F FLOP over the bf16 peak and x, w, out bytes over HBM."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.collective_matmul import decode_splits, regime
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows_out = []
    for label, n, rows, k, f in _agmm_main_shapes():
        x = _rand((n, rows, k), torch.bfloat16, gen, device)
        w = _rand((n, k, f), torch.bfloat16, gen, device)
        mode = regime(n, rows)
        splits = decode_splits(n, k, f, sms)[0] if mode == "decode" else None

        def lib(x=x, w=w):
            return torch.matmul(x.reshape(1, n * rows, k), w)

        l_ms, l_cov = device_ms(lib, 20)
        for odt in (torch.bfloat16, torch.float32):
            def kern(x=x, w=w, odt=odt):
                return ops.fused_allgather_matmul(x, w, out_dtype=odt)

            def plain(x=x, w=w, odt=odt):
                return ops.fused_allgather_matmul(x, w, out_dtype=odt,
                                                  backend="torch")

            k_ms, k_cov = device_ms(kern, 20)
            k_wall = wall_ms(kern, 20)
            p_ms, p_cov = device_ms(plain, 5)
            flops = 2 * n * (n * rows) * k * f
            out_bytes = n * n * rows * f * (4 if odt == torch.float32 else 2)
            nbytes = (x.numel() + w.numel()) * 2 + out_bytes
            t_ops = flops / BF16_FLOPS_PER_S
            t_bytes = nbytes / HBM_BYTES_PER_S
            rows_out.append(dict(
                shape=label, n=n, rows=rows, K=k, F=f, out=str(odt)[6:],
                regime=mode, k_splits=splits, ms=k_ms, ms_wall=k_wall, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=max(t_ops, t_bytes) * 1e3, ops_ms=t_ops * 1e3,
                bytes_ms=t_bytes * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes, tflops_per_s=flops / k_ms / 1e9,
                sleep_covered=dict(kernel=k_cov, plain=p_cov,
                                   library=l_cov)))
        del x, w
        torch.cuda.empty_cache()
    return rows_out


def phase_hierarchical(device, gen):
    import tempfile
    t = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        tmp = pathlib.Path(d)
        cases_2ph, subtiled_2ph, err_2ph, fault_2ph_grid = _2ph_vs_plain(
            gen, device)
        cases_mm, errs_mm, rels_mm, fault_mm, edges_mm = _agmm_vs_plain(
            gen, device)
        exact = _hier_exact(device, tmp)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        # what earlier phases still hold (the kernels' cached workspaces)
        # is in the peak; the main path's own share is the difference
        held_gb = torch.cuda.memory_allocated(device) / 1e9
        leaves, mm_main, launches = _hier_main_path(device, tmp)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        hier_timing = _hier_time(device, tmp)
        mm_timing = _agmm_time(device, gen)
    total = {k: sum(r[k] for r in hier_timing)
             for k in ("ms", "ms_wall", "plan_ms", "plan_plain_ms",
                       "plain_ms", "library_ms", "bound_ms", "bytes",
                       "moved_bytes")}
    emit("hierarchical", grid=f"{HIER_NN}x{HIER_L}", cases_2ph=cases_2ph,
         subtiled_2ph=subtiled_2ph,
         max_abs_err_2ph=err_2ph, fault_2ph_grid_max_abs_err=fault_2ph_grid,
         cases_agmm=cases_mm, max_abs_err_agmm=errs_mm,
         max_rel_l2_agmm=rels_mm, fault_agmm_rel_l2=fault_mm,
         agmm_regime_edges=edges_mm,
         agmm_rel_tol={str(k)[6:]: v for k, v in AGMM_REL_TOL.items()},
         leaf_rel_tol=LEAF_REL_TOL, exact=exact, leaves=leaves,
         agmm_main=mm_main, launches=launches, peak_gb_main_path=peak_gb,
         held_gb_before_main_path=held_gb,
         gradient_total=total, leaf_shapes=hier_timing,
         agmm_shapes=mm_timing, seconds=round(time.perf_counter() - t, 3))
    return dict(err_2ph=err_2ph, errs_mm=errs_mm, mm_main=mm_main,
                launches=launches, hier_timing=hier_timing,
                mm_timing=mm_timing,
                err_plan=max(r["plan_max_abs_err_plain"] for r in leaves))


# ---------------------------------------------------------------------------
# phase 12: the hybrid attention+SSM family (hymba-1.5b) on the serving path
# ---------------------------------------------------------------------------
def _draw_time(logits, device):
    """Device and wall (host dispatch included) ms of one temperature
    draw, ``sampling.categorical`` at the engine's temperature on the
    batch's (b, vocab) f32 logits, the key split on the host before it
    as ``Engine.decode`` does."""
    from repro_torch.serve import sampling
    logits = logits.to(device)
    key = sampling.key(SAMPLE_SEED)

    def draw():
        _, sub = sampling.split(key)
        return sampling.categorical(sub, logits / SAMPLE_TEMPERATURE)

    ms, covered = device_ms(draw, 50)
    return dict(ms=ms, ms_wall=wall_ms(draw, 50), sleep_covered=covered)


@contextlib.contextmanager
def _explicit_fault(kind):
    """A deliberately wrong explicit hybrid step, for the pinned gate's
    fault controls: ``"ssm_replay"`` skips the SSM out-proj partial's
    AllReduce replay (the first of a layer's three ``comms.hidden``
    calls), so each rank averages attention with its own partial;
    ``"ssm_rows"`` gives rank r the ``xin``/``z`` rows of rank r - 1 (a
    wrong ``d_offset`` row block)."""
    from repro_torch.distributed import step as st
    from repro_torch.models import ssm
    hidden, local = st.TPDecodeComms.hidden, ssm._local_rows
    calls = []

    def skip_ssm(self, x):
        calls.append(None)
        return x if len(calls) % 3 == 1 else hidden(self, x)

    if kind == "ssm_replay":
        st.TPDecodeComms.hidden = skip_ssm
    else:
        ssm._local_rows = lambda t, off, d: local(t, off, d).roll(1, 0)
    try:
        yield
    finally:
        st.TPDecodeComms.hidden, ssm._local_rows = hidden, local


def _eager_steps(cfg, mode, params, toks, device, quant=False, pin=None,
                 steps=PROMPT):
    """``steps`` prompt tokens through ``make_serve_step`` eagerly, from
    position 0 on a fresh cache, norms recorded (and with ``pin``,
    layer-pinned: :func:`_pinned_layers`): the first-step and last-step
    logits and the record."""
    from repro_torch.distributed.step import make_serve_step
    from repro_torch.mesh import RankAxis
    step, layout = make_serve_step(cfg, RankAxis("model", TP, device),
                                   batch=BATCH, max_kv=MAX_KV, mode=mode,
                                   kv_quant=quant)
    cache = layout.cache()
    with torch.inference_mode(), _pinned_layers(cfg.n_layers, steps,
                                                pin) as seen:
        for t in range(steps):
            logits = step(params, cache, toks[:, t], t)[0].float().cpu()
            if t == 0:
                first = logits
    return dict(first=first, last=logits), seen


def _hybrid_pinned(cfg, params, eparams, prompts, device):
    """The prompts' 16 steps, eager, from position 0 on fresh caches, in
    auto (recorded; and with the token's embedding rows moved by one
    bf16 step, the control), explicit, and layer-pinned to auto's record
    (:func:`_pinned_layers`): explicit, auto-int8, explicit-int8 and the
    first step of each explicit fault (:func:`_explicit_fault`). The
    first-step and last-step logits of each."""
    toks = torch.as_tensor(prompts, dtype=torch.long, device=device)
    out = {}
    out["auto"], record = _eager_steps(cfg, "auto", params, toks, device)
    out["explicit"], _ = _eager_steps(cfg, "explicit", eparams, toks, device)
    for name, mode, p, quant in (
            ("explicit_pinned", "explicit", eparams, False),
            ("auto_int8_pinned", "auto", params, True),
            ("explicit_int8_pinned", "explicit", eparams, True)):
        out[name], _ = _eager_steps(cfg, mode, p, toks, device, quant=quant,
                                    pin=record)
    for kind in ("ssm_replay", "ssm_rows"):
        with _explicit_fault(kind):
            out[f"fault_{kind}"], _ = _eager_steps(
                cfg, "explicit", eparams, toks, device, pin=record, steps=1)
    del record
    # the control: auto's own first step with the token's embedding rows
    # one bf16 step off (each element times 1 +- 2**-7)
    embed = params["embed"].clone()
    rows = embed[toks[:, 0]].float()
    sign = torch.randint(0, 2, rows.shape, generator=torch.Generator(
        device=device).manual_seed(14), device=device) * 2 - 1
    embed[toks[:, 0]] = (rows * (1 + sign * 2.0 ** -7)).to(embed.dtype)
    out["auto_one_step_off"], _ = _eager_steps(
        cfg, "auto", dict(params, embed=embed), toks, device, steps=1)
    del embed
    torch.cuda.empty_cache()
    return out


def phase_hybrid(device):
    """hymba-1.5b at full width and depth (32 layers, d_model 1600, 25/5
    heads padded to 40/8, head_dim 64, window 1024 on every layer, SSM
    state 16, vocab 32001, seeded random bf16 weights), TP=4 stacked on
    the card: 8 requests of 16-token prompts then 32 greedy tokens in
    auto, explicit, auto-int8 and explicit-int8, each by graph replay
    against the eager step on one engine (first-step logits bit-equal,
    tokens equal). Explicit makes 3 layer-AllReduce replays a layer
    (attention, SSM, MLP; the vocab divides no axis of 4, so no
    embedding replay and no logits AllGather): 96 executor launches
    captured, 96 a step eager, 96 a replay by the profiler over 4
    replays.

    A random-weight hymba is chaotic in bf16 at full depth: one bf16 step
    on auto's own input moves auto's first-step logits by more than the
    bf16 bar (the control, below). So explicit against auto is held to
    the bf16 bar (first-step logits, both caches) and int8 against bf16
    to the reference's bar (after the 16 prompt tokens) layer-pinned:
    every layer computed on auto's bf16 layer inputs
    (:func:`_pinned_layers`), eagerly, the unpinned explicit step first
    checked bit-equal to the served graph's first step; two wrong
    explicit steps (:func:`_explicit_fault`), pinned the same way, must
    read past the bf16 bar; the served (unpinned) differences and the
    control are recorded beside them. In f32: at 4 layers, explicit and
    auto greedy tokens equal over 16 steps; at all 32, explicit against
    auto first-step logits within HYBRID_F32_TOL unpinned (the served
    bf16 gap is rounding, not a fault that grows with depth). One
    temperature run (T 0.8, seed 7) drawing the same tokens by graph
    replay and eager, and the draw's time; auto on the published 25
    heads beside the padded config."""
    from repro_torch.distributed.sharding import explicit_decode_params
    from repro_torch.mesh import RankAxis
    from repro_torch.models import transformer as tf
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = _hybrid_cfg()
    t = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(12), device=device)
    init_s = time.perf_counter() - t
    prompts = np.random.RandomState(12).randint(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)
    per_step = 3 * cfg.n_layers
    runs = _serve_four_modes(cfg, params, prompts, per_step, HYBRID_ARCH,
                             keep_params=True)
    check(set(runs["explicit"]["plans"]) == {"layer_allreduce"},
          f"{HYBRID_ARCH} plans: {sorted(runs['explicit']['plans'])}")
    # served, unpinned: recorded
    rel = {name: _rel(runs[f"explicit{name}"]["first"],
                      runs[f"auto{name}"]["first"]) for name in ("", "_int8")}
    int8_vs_bf16 = {m: _int8_vs_fp(runs[f"{m}_int8"]["last"], runs[m]["last"])
                    for m in ("auto", "explicit")}
    # layer-pinned: held
    pinned = _hybrid_pinned(cfg, params, runs["explicit"].pop("params"),
                            prompts, device)
    check(torch.equal(pinned["explicit"]["first"],
                      runs["explicit"]["first"]),
          f"{HYBRID_ARCH}: the eager explicit first step differs from the "
          f"served graph's")
    check(torch.equal(pinned["auto"]["first"], runs["auto"]["first"]),
          f"{HYBRID_ARCH}: the eager auto first step differs from the "
          f"served graph's")
    rel_pinned = {
        "": _rel(pinned["explicit_pinned"]["first"],
                 pinned["auto"]["first"]),
        "_int8": _rel(pinned["explicit_int8_pinned"]["first"],
                      pinned["auto_int8_pinned"]["first"])}
    for name, v in rel_pinned.items():
        check(v <= BF16_REL_TOL, f"{HYBRID_ARCH}{name} first-step logits, "
              f"explicit vs auto, layer-pinned: rel {v}")
    # the same comparison fails a wrong explicit path
    faults = {kind: _rel(pinned[f"fault_{kind}"]["first"],
                         pinned["auto"]["first"])
              for kind in ("ssm_replay", "ssm_rows")}
    for kind, v in faults.items():
        check(v > BF16_REL_TOL, f"{HYBRID_ARCH}: the layer-pinned fault "
              f"control {kind} reads rel {v}, within the bar")
    int8_vs_bf16_pinned = {
        "auto": _int8_vs_fp(pinned["auto_int8_pinned"]["last"],
                            pinned["auto"]["last"]),
        "explicit": _int8_vs_fp(pinned["explicit_int8_pinned"]["last"],
                                pinned["explicit_pinned"]["last"])}
    for m, v in int8_vs_bf16_pinned.items():
        check(v["rel_err"] < INT8_REL_TOL
              and v["argmax_agreement"] >= INT8_ARGMAX_AGREEMENT,
              f"{HYBRID_ARCH} int8 vs bf16 cache ({m}), layer-pinned: {v}")
    control = _rel(pinned["auto_one_step_off"]["first"],
                   pinned["auto"]["first"])
    del pinned
    # one temperature run, explicit: graph and eager draw the same tokens
    sampled = _run_engine(cfg, params, prompts, "explicit", DECODE, False,
                          temperature=SAMPLE_TEMPERATURE, seed=SAMPLE_SEED)
    check(not np.array_equal(sampled["tokens"], runs["explicit"]["tokens"]),
          f"{HYBRID_ARCH}: T={SAMPLE_TEMPERATURE} drew the greedy tokens")
    draw = _draw_time(sampled["last"], device)
    del params
    torch.cuda.empty_cache()
    # the published 25 heads, auto: what the padding costs
    cfg25 = _hybrid_cfg(pad=0)
    params = tf.init_params(cfg25, torch.Generator(device=device)
                            .manual_seed(12), device=device)
    published = _run_engine(cfg25, params, prompts, "auto", DECODE, False)
    del params
    torch.cuda.empty_cache()
    # f32 at reduced depth: explicit and auto greedy tokens equal
    cfg32 = _hybrid_cfg(HYBRID_F32_LAYERS, "float32")
    params = tf.init_params(cfg32, torch.Generator(device=device)
                            .manual_seed(13), device=device)
    f32 = {mode: _run_engine(cfg32, params, prompts, mode, 16, False)
           for mode in ("auto", "explicit")}
    f32_equal = bool(np.array_equal(f32["auto"]["tokens"],
                                    f32["explicit"]["tokens"]))
    del params
    torch.cuda.empty_cache()
    check(f32_equal, f"{HYBRID_ARCH} f32: explicit and auto greedy tokens "
          f"differ")
    # f32 at full depth, unpinned: explicit vs auto first-step logits. A
    # fault that grows with depth reads as the served bf16 gap does; f32
    # rounding, amplified as bf16's is, reads far below HYBRID_F32_TOL
    cfg32 = _hybrid_cfg(dtype="float32")
    params = tf.init_params(cfg32, torch.Generator(device=device)
                            .manual_seed(13), device=device)
    toks = torch.as_tensor(prompts, dtype=torch.long, device=device)
    eparams = explicit_decode_params(params, cfg32,
                                     RankAxis("model", TP, device))
    first32 = {mode: _eager_steps(cfg32, mode, p, toks, device,
                                  steps=1)[0]["first"]
               for mode, p in (("auto", params), ("explicit", eparams))}
    f32_full_rel = _rel(first32["explicit"], first32["auto"])
    del params, eparams, first32
    torch.cuda.empty_cache()
    check(f32_full_rel <= HYBRID_F32_TOL, f"{HYBRID_ARCH} f32, "
          f"{cfg32.n_layers} layers: explicit vs auto first-step rel "
          f"{f32_full_rel}")
    emit("hybrid", arch=HYBRID_ARCH, n_layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         pad_heads_to=cfg.pad_heads_to, head_dim=cfg.hd, d_ff=cfg.d_ff,
         vocab=cfg.vocab, ssm_state=cfg.ssm.state_dim, window=cfg.window,
         dtype=cfg.dtype, tp=TP, batch=BATCH, prompt=PROMPT, decode=DECODE,
         init_params_s=init_s,
         ms_per_token={k: r["ms_per_token"] for k, r in runs.items()},
         ms_per_token_eager={k: r["eager"]["ms_per_token"]
                             for k, r in runs.items()},
         ms_per_token_auto_published_heads=published["ms_per_token"],
         ms_per_token_auto_published_heads_eager=published["eager"][
             "ms_per_token"],
         runs={k: _run_record(r) for k, r in runs.items()},
         launches=runs["explicit"]["launches"], launches_per_step=per_step,
         first_step_rel_err_pinned=rel_pinned[""],
         int8_first_step_rel_err_pinned=rel_pinned["_int8"],
         int8_vs_bf16_pinned=int8_vs_bf16_pinned,
         bf16_rel_tol=BF16_REL_TOL, int8_rel_tol=INT8_REL_TOL,
         int8_argmax_agreement_min=INT8_ARGMAX_AGREEMENT,
         served_unpinned=dict(first_step_rel_err=rel[""],
                              int8_first_step_rel_err=rel["_int8"],
                              int8_vs_bf16=int8_vs_bf16),
         control_one_bf16_step_on_auto_input=control,
         token_agreement=float((runs["explicit"]["tokens"]
                                == runs["auto"]["tokens"]).mean()),
         fault_first_step_rel_err_pinned=faults,
         f32=dict(n_layers=HYBRID_F32_LAYERS, steps=16,
                  tokens_equal=f32_equal,
                  last_prefill_rel_err=_rel(f32["explicit"]["last"],
                                            f32["auto"]["last"])),
         f32_full_depth=dict(n_layers=cfg32.n_layers,
                             first_step_rel_err=f32_full_rel,
                             tol=HYBRID_F32_TOL),
         temperature=dict(temperature=SAMPLE_TEMPERATURE, seed=SAMPLE_SEED,
                          graph_equals_eager=True,
                          ms_per_token=sampled["ms_per_token"],
                          eager_ms_per_token=sampled["eager"]["ms_per_token"],
                          draw=draw),
         plans=runs["explicit"]["plans"],
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         seconds=time.perf_counter() - t0)
    return _counted(runs["explicit"])


# ---------------------------------------------------------------------------
# phase 13: the serving stack
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _serve_scheduler():
    """The port's Scheduler, recording beside its own work: each fused
    prefill micro-step's (b, S), executor launches and CUDA-event span
    (no sync), the first combined step's inputs and logits, and, with
    ``gaps``, each sampled row's top-2 gap — of its logits, or at a
    temperature of its perturbed logits (``sampling.perturbed_rows``,
    the draw's own values) — by (rid, tokens emitted before it)."""
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.serve import sampling
    from repro_torch.serve.scheduler import Scheduler

    class Recording(Scheduler):
        def __init__(self, *args, gaps=False, **kw):
            self.prefill_log = []
            self.first = None
            self.gaps = {} if gaps else None
            super().__init__(*args, **kw)

        def run_prefill(self, b, S, inputs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            before = CudaExecutor.launches
            e0.record()
            super().run_prefill(b, S, inputs)
            e1.record()
            self.prefill_log.append((b, S, CudaExecutor.launches - before,
                                     e0, e1))

        def run_step(self, b, inputs, *, graph=None):
            logits = super().run_step(b, inputs, graph=graph)
            if self.first is None:
                self.first = (inputs.clone(), logits.float().cpu())
            return logits

        def _sample(self, logits, rows):
            if self.gaps is not None:
                vals = []
                for i, s in rows:
                    row = logits[i:i + 1]
                    if s.req.temperature > 0:
                        key = sampling.fold_in(sampling.key(s.req.seed),
                                               s.emitted)
                        t = torch.tensor([[s.req.temperature]],
                                         dtype=torch.float32,
                                         device=row.device)
                        row = sampling.perturbed_rows([key], row / t)
                    top = torch.topk(row[0], 2).values
                    vals.append(top[0] - top[1])
                for (_, s), g in zip(rows, torch.stack(vals).tolist()):
                    self.gaps[(s.req.rid, s.emitted)] = g
            return super()._sample(logits, rows)

    return Recording


def _serve_trace(tcfg, vocab, hot=True):
    from repro_torch.serve import loadgen
    trace = loadgen.synth_trace(loadgen.TrafficConfig(**tcfg), vocab)
    if hot:
        trace = [dataclasses.replace(r, temperature=SERVE_HOT_T)
                 if i % 3 == 2 else r for i, r in enumerate(trace)]
    return trace


def _pct(vals, q):
    from repro_torch.serve.scheduler import _pct as pct
    return pct(sorted(vals), q)


def _drive(target, trace, step_s, window=None):
    """``loadgen.run_load`` with the wall's stamps: each request's TTFT by
    the wall (from its submission, once the virtual clock passed its
    arrival, to the tick that emitted its first token; a tick that
    samples ends on the host), each tick's wall ms beside its bucket and
    micro-steps, and the drained run's wall ms between CUDA events. With
    ``window=(first tick, ticks)``, those ticks run under the profiler:
    the card's busy share over them (kernel time over their wall), read
    after the run; the bucket means leave those ticks out, and the run's
    wall and TTFTs leave out the profiler's start and stop (seconds on
    the host while the card idles: the clock stops)."""
    from collections import deque
    from torch.profiler import ProfilerActivity, profile
    pending = deque(sorted(trace, key=lambda r: (r.arrival_s, r.rid)))
    infos, submitted, first, ticks = [], {}, {}, []
    prof, busy, paused = None, None, 0.0

    def clock():
        return time.perf_counter() - paused

    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    while pending or target.outstanding():
        while pending and pending[0].arrival_s <= target.now:
            req = pending.popleft()
            target.submit(req)
            submitted[req.rid] = clock()
        if target.n_active == 0 and target.outstanding() == 0 and pending:
            target.advance_to(pending[0].arrival_s)
            continue
        if window and len(infos) == window[0]:
            torch.cuda.synchronize()
            p0 = time.perf_counter()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            paused += time.perf_counter() - p0
            w0 = clock()
        t = clock()
        info = target.tick()
        now = clock()
        ticks.append((info.bucket, info.micro_steps, (now - t) * 1e3))
        for em in info.emissions:
            first.setdefault(em.rid, now)
        infos.append(info)
        target.advance(step_s * (1 + info.micro_steps))
        if prof is not None and len(infos) == window[0] + window[1]:
            torch.cuda.synchronize()
            w_ms = (clock() - w0) * 1e3
            p0 = time.perf_counter()
            prof.stop()
            done, prof = prof, None
            paused += time.perf_counter() - p0
    e1.record()
    torch.cuda.synchronize()
    if window and len(infos) >= sum(window):
        # read after the run: reading a profile takes seconds
        busy_ms = sum(r[0] for r in _device_rows(done, 1)) / 1e3
        busy = dict(ticks=list(window), wall_ms=w_ms, device_ms=busy_ms,
                    share=busy_ms / w_ms,
                    tick_wall_ms=[round(ms, 3) for _, _, ms in
                                  ticks[window[0]:sum(window)]])
    ttft = [first[r] - submitted[r] for r in submitted]
    tokens = sum(len(e.emissions) for e in infos)
    wall = e0.elapsed_time(e1) - paused * 1e3
    # decode ticks' wall by bucket, outside the profiled window
    by_bucket = {}
    skip = range(window[0], sum(window)) if window else range(0)
    for i, (b, micro, ms) in enumerate(ticks):
        if b and not micro and i not in skip:
            by_bucket.setdefault(b, []).append(ms)
    return dict(infos=infos, wall_ms=wall, profiler_pause_ms=paused * 1e3,
                tokens=tokens,
                tokens_per_s=tokens / wall * 1e3,
                ttft_wall_s={"p50": _pct(ttft, 0.5), "p99": _pct(ttft, 0.99),
                             "max": max(ttft)},
                decode_tick_wall_ms={b: dict(mean=sum(v) / len(v), ticks=len(v))
                                     for b, v in sorted(by_bucket.items())},
                busy=busy)


def _prefill_record(sched, per_step, label):
    """Each fused prefill micro-step launched ``per_step`` executor
    kernels: the steps, and their eager ms, by (b, S) — the first call of
    a shape apart (it binds the executor at a new row bucket and meets
    new GEMM shapes), the mean of the later ones."""
    out = {}
    for b, S, launches, e0, e1 in sched.prefill_log:
        check(launches == per_step, f"{label}: a fused prefill step at "
              f"{b}x{S} launched {launches} executor kernels, want "
              f"{per_step}")
        out.setdefault(f"{b}x{S}", []).append(e0.elapsed_time(e1))
    return {k: dict(steps=len(v), first_ms=v[0],
                    mean_ms=sum(v[1:]) / (len(v) - 1) if len(v) > 1
                    else None)
            for k, v in sorted(out.items())}


def _stream_bar(got, base, gaps, offset, margin, label, hold=True):
    """Streams against the sequential run's: equal, or parted at a step
    whose top-2 gap in the sequential run is under ``margin`` (0: none
    may part). Counts the streams that reached such a step at all, and
    those that parted past the margin (``past_margin``; with ``hold``,
    one fails the check)."""
    res = dict(streams=len(got), equal=0, parted_at_near_tie=0,
               reached_near_tie=0, parting_gaps=[], past_margin=0,
               past_margin_gaps=[])
    for rid, toks in got.items():
        want = base[rid]
        g = [gaps[(rid + offset, t)] for t in range(len(want))]
        res["reached_near_tie"] += any(x < margin for x in g)
        if toks == want:
            res["equal"] += 1
            continue
        t = next((i for i, (a, b) in enumerate(zip(toks, want)) if a != b),
                 min(len(toks), len(want)))
        gap = g[t] if t < len(g) else None
        if gap is not None and gap < margin:
            res["parted_at_near_tie"] += 1
            res["parting_gaps"].append(gap)
            continue
        check(not hold, f"{label}: request {rid} parts from the sequential "
              f"run at token {t}, top-2 gap {gap} (margin {margin})")
        res["past_margin"] += 1
        res["past_margin_gaps"].append(gap)
    return res


def _compaction_control(sched, trace, base, step_s,
                        margin=SERVE_TIE_MARGIN):
    """The stream bar's planted control: trace A's first
    SERVE_CONTROL_REQUESTS requests again on ``sched`` (rids offset by
    2 x SERVE_RID), its compaction moving a slot without copying its
    cache row (the moved request then reads the freed one's entries).
    Their streams go through :func:`_stream_bar` against the sequential
    run at ``margin``: a compaction must have happened, and a stream must
    part past the margin."""
    from repro_torch.serve import loadgen
    moved = []

    def release(i):
        last = len(sched._slots) - 1
        if i != last:
            moved.append(i)
            sched._slots[i] = sched._slots[last]     # the row stays
        sched._slots.pop()

    sub = [dataclasses.replace(r, rid=r.rid + 2 * SERVE_RID)
           for r in trace[:SERVE_CONTROL_REQUESTS]]
    sched._release = release
    try:
        loadgen.run_load(sched, sub, step_s=step_s)
    finally:
        del sched._release
    got = {r.rid - 2 * SERVE_RID: sched.streams[r.rid] for r in sub}
    bar = _stream_bar(got, base, sched.gaps, SERVE_RID, margin,
                      "control", hold=False)
    check(len(moved) > 0, "the compaction control moved no slot")
    check(bar["past_margin"] > 0, f"the compaction control passed the "
          f"stream bar at margin {margin}: {bar}")
    return dict(bar, compactions=len(moved))


def _sequential(sched, trace, step_s):
    """The trace's requests one at a time on ``sched`` (rids offset by
    SERVE_RID), each with the batch to itself: rid -> stream."""
    from repro_torch.serve import loadgen
    base = loadgen.sequential_baseline(
        sched, [dataclasses.replace(r, rid=r.rid + SERVE_RID) for r in trace],
        step_s=step_s)
    return {rid - SERVE_RID: toks for rid, toks in base.items()}


def _snapshot(cache):
    return {k: [leaf.clone() for leaf in v] for k, v in cache.items()}


def _restore(cache, saved):
    for k, v in cache.items():
        for leaf, old in zip(v, saved[k]):
            leaf.copy_(old)


def _bucket_checks(sched, per_tick, label):
    """At each slot bucket b, on one state of the scheduler's cache (rows
    at positions 100 + 37 i, restored before every step): the replay
    bit-equal to the eager step (logits and every cache leaf); the
    profiler's executor kernels over SERVE_PROFILED replays; the graph's
    ms a tick (all rows inactive, so the state stays); and each bucket's
    rows' logits against the same rows at the top bucket (max abs: the
    cross-bucket difference). At the top bucket, row 0's logits
    bit-equal whatever its co-residents' tokens."""
    rng = np.random.RandomState(13)
    top = sched.max_slots
    vocab = sched.eng.cfg.vocab
    tokens = rng.randint(0, vocab, top)
    pos = 100 + 37 * np.arange(top)

    def inputs(b, active=1, toks=tokens):
        return torch.from_numpy(np.stack([toks[:b], pos[:b],
                                          np.full(b, active)]).astype(
            np.int64))

    saved = _snapshot(sched.cache)
    out, logits_top = {}, None
    for b in sorted(sched.graphs, reverse=True):
        g = sched.run_step(b, inputs(b), graph=True).clone()
        after_g = _snapshot(sched.cache)
        _restore(sched.cache, saved)
        e = sched.run_step(b, inputs(b), graph=False).clone()
        check(torch.equal(g, e), f"{label}: bucket {b} replay and eager "
              f"logits differ: max abs {(g - e).abs().max().item()}")
        for k, v in sched.cache.items():
            for leaf, want in zip(v, after_g[k]):
                check(torch.equal(leaf, want), f"{label}: bucket {b} replay "
                      f"and eager {k} caches differ")
        del after_g
        _restore(sched.cache, saved)
        rec = dict(launches=sched.graphs[b].launches)
        check(rec["launches"] == per_tick, f"{label}: bucket {b} graph "
              f"captured {rec['launches']} executor launches")
        if b == top:
            logits_top = g
            other = tokens.copy()
            other[1:] = rng.randint(0, vocab, top - 1)
            g2 = sched.run_step(b, inputs(b, toks=other), graph=True)
            check(torch.equal(g2[0], g[0]), f"{label}: row 0's logits at "
                  f"bucket {b} moved with its co-residents' tokens")
            _restore(sched.cache, saved)
        else:
            rec["max_abs_vs_top"] = (g - logits_top[:b]).abs().max().item()
        quiet = inputs(b, active=0)
        graph = sched.graphs[b]
        want = per_tick * SERVE_PROFILED
        kernels, tries, odd, _ = _profile_graph(lambda: graph.run(quiet),
                                                SERVE_PROFILED, want)
        check(kernels == want, f"{label}: the profiler saw {kernels} "
              f"executor kernels over {SERVE_PROFILED} replays at bucket "
              f"{b} (the most of {tries} profiles), want {want}; kernels "
              f"not a multiple of the replays: {odd}")
        rec["profiled_executor_kernels"] = kernels
        rec["profiles_taken"] = tries
        rec["graph_ms"] = wall_ms(lambda: graph.run(quiet), SERVE_REPLAYS)
        graph.inputs.copy_(quiet)
        rec["graph_device_ms"], _ = device_ms(graph.graph.replay,
                                             SERVE_REPLAYS)
        out[b] = rec
    for k, v in sched.cache.items():
        for leaf, want in zip(v, saved[k]):
            check(torch.equal(leaf, want), f"{label}: an inactive replay "
                  f"moved the {k} cache")
    return out


def _draw_ms(sched):
    """Wall ms of a tick's sampling over the top bucket's rows: every row
    at SERVE_HOT_T (one vectorised draw), and every row greedy."""
    from repro_torch.serve.scheduler import Request, _Slot
    top = sched.max_slots
    logits = torch.randn((top, sched.eng.cfg.vocab), device=sched.device)

    def rows(t):
        return [(i, _Slot(Request(rid=i, prompt=np.ones(1, np.int32),
                                  max_new_tokens=1, temperature=t, seed=i),
                          0.0)) for i in range(top)]

    hot, greedy = rows(SERVE_HOT_T), rows(0.0)
    return dict(hot_ms=wall_ms(lambda: sched._sample(logits, hot), 20),
                greedy_ms=wall_ms(lambda: sched._sample(logits, greedy), 20))


def _serve_engine(cfg, params, mode, seq_buckets=SERVE_SEQ_BUCKETS):
    from repro_torch.serve.engine import Engine, ServeConfig
    eng = Engine(cfg, params, ServeConfig(
        batch=BATCH, max_kv=MAX_KV, mode=mode,
        prefill_seq_buckets=seq_buckets), tp=TP, mode=mode)
    if mode == "explicit":
        backends = {p.backend for bp in eng.decode_plans.values()
                    for p in bp.plans.values()}
        check(backends == {"cuda"}, f"explicit plans on {backends}")
    return eng


def _trace_a(cfg, params, device, gen):
    """qwen3-1.7b, trace A: explicit (the main path, its executor
    launches counted from 0 before the engine is built, a window of its
    ticks under the profiler), its bucket checks and the sequential run
    on the same scheduler; then auto."""
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.distributed.step import WARMUP_STEPS
    Sched = _serve_scheduler()
    per_tick, per_prefill = 2 * cfg.n_layers + 2, 2 * cfg.n_layers + 1
    trace = _serve_trace(TRACE_A, cfg.vocab)
    step_s = TRACE_A["step_s"]
    out, t0 = {}, time.perf_counter()
    torch.cuda.synchronize()
    CudaExecutor.launches = 0                 # just before the main path
    eng = _serve_engine(cfg, params, "explicit")
    fam = eng.decode_plans["layer_allreduce"]
    hits0_all = {p: dict(bp.hits) for p, bp in eng.decode_plans.items()}
    hits0 = hits0_all["layer_allreduce"]
    t = time.perf_counter()
    sched = Sched(eng, max_slots=BATCH, prefill_chunk=SERVE_CHUNK,
                  fused_prefill=True)
    capture_s = time.perf_counter() - t
    hits1 = dict(fam.hits)
    run = _drive(sched, trace, step_s, window=SERVE_PROFILE_WINDOW)
    torch.cuda.synchronize()
    launches = CudaExecutor.launches          # read just after
    hits2 = dict(fam.hits)
    m = sched.metrics()
    check(m["completed"] == len(trace) and m["dropped"] == 0
          and m["outstanding"] == 0, f"trace A explicit: {m}")
    check(run["busy"] is not None, "trace A explicit: the profiled window "
          "of ticks was not reached")
    for b in sched.graphs:
        check(hits1[b] > hits0[b], f"bucket {b}'s plan hits did not advance "
              f"at its capture: {hits0} -> {hits1}")
    prefill = _prefill_record(sched, per_prefill, "trace A explicit")
    rows_used = {fam.bucket_for(int(k.split("x")[0]) * int(k.split("x")[1]))
                 for k in prefill}
    for r in rows_used:
        check(hits2[r] > hits1[r], f"row bucket {r}'s plan hits did not "
              f"advance under fused prefill: {hits1} -> {hits2}")
    rep = sched.plan_report()
    check(rep["degraded"] is False and rep["mode"] == "explicit",
          "the explicit scheduler degraded")
    _healthy(sched, "trace A explicit")
    out["explicit"] = dict(
        {k: run[k] for k in ("wall_ms", "profiler_pause_ms", "tokens",
                             "tokens_per_s", "ttft_wall_s",
                             "decode_tick_wall_ms")},
        metrics=m, prefill=prefill, capture_s=capture_s,
        launches=launches, hits_after_capture=hits1, hits_after_run=hits2,
        graphs=rep["scheduler"]["graphs"])
    out["busy"] = run["busy"]
    streams, first = dict(sched.streams), sched.first
    # the wrapper's launches over the main path, each accounted for: the
    # bucket graphs' warm-up steps and captures, and the prefill steps
    # (the engine steps, and captures, nothing of its own)
    graphs = rep["scheduler"]["graphs"]
    captured = sum((WARMUP_STEPS + 1) * g["launches"]
                   for g in graphs.values())
    prefill_launches = sum(n for _, _, n, _, _ in sched.prefill_log)
    check(launches == captured + prefill_launches, f"trace A explicit: "
          f"{launches} executor launches, want {captured} into the bucket "
          f"graphs' warm-ups and captures and {prefill_launches} by the "
          f"prefill steps")
    # weights of the path's times (not launch counts): each plan's
    # dispatches into one capture (its hits there over the warm-ups and
    # the capture) times the bucket graph's replays, and each prefill
    # step's counted launches at its row bucket
    weights = {}
    for pname, bp in eng.decode_plans.items():
        for b, g in graphs.items():
            per_capture = (bp.hits[b] - hits0_all[pname][b]) // (
                WARMUP_STEPS + 1)
            if per_capture:
                weights[f"{pname}@{b}"] = g["replays"] * per_capture
    for b, S, n, _, _ in sched.prefill_log:
        key = f"layer_allreduce@{fam.bucket_for(b * S)}"
        weights[key] = weights.get(key, 0) + n
    out["executor"] = dict(
        launches=launches, captured_launches=captured,
        prefill_launches=prefill_launches,
        graph_launches={b: g["launches"] for b, g in graphs.items()},
        graph_replays={b: g["replays"] for b, g in graphs.items()},
        prefill_steps={k: v["steps"] for k, v in prefill.items()},
        time_weights=weights)
    out["seconds_run"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["buckets"] = _bucket_checks(sched, per_tick, "trace A explicit")
    out["draw"] = _draw_ms(sched)
    # the executor at every fused prefill row bucket, held bit-equal to
    # the plain version and timed (the slot buckets' rows are phase 6's)
    out["executor_time"] = [_time_plan(ARCH, "layer_allreduce", plan, b, gen,
                                       device, SERVE_TIME_ITERS)
                            for b, plan in sorted(fam.plans.items())
                            if b > BATCH]
    out["seconds_checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the sequential run on the same scheduler, recording each row's gap
    sched.gaps = {}
    base = _sequential(sched, trace, step_s)
    out["vs_sequential"] = _stream_bar(streams, base, sched.gaps, SERVE_RID,
                                       SERVE_TIE_MARGIN, "trace A explicit")
    out["control"] = _compaction_control(sched, trace, base, step_s)
    tops = [v["max_abs_vs_top"] for v in out["buckets"].values()
            if "max_abs_vs_top" in v]
    check(2 * max(tops) <= SERVE_TIE_MARGIN, f"the cross-bucket logit "
          f"difference {max(tops)} is past half the margin "
          f"{SERVE_TIE_MARGIN}")
    out["peak_memory_gb_explicit"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds_sequential"] = time.perf_counter() - t0
    del sched, eng
    gc.collect()
    torch.cuda.empty_cache()
    # auto
    t0 = time.perf_counter()
    eng = _serve_engine(cfg, params, "auto")
    sched = Sched(eng, max_slots=BATCH, prefill_chunk=SERVE_CHUNK,
                  fused_prefill=True)
    run = _drive(sched, trace, step_s)
    m = sched.metrics()
    check(m["completed"] == len(trace) and m["dropped"] == 0,
          f"trace A auto: {m}")
    _healthy(sched, "trace A auto")
    check(torch.equal(sched.first[0], first[0]), "the first tick's inputs "
          "differ between explicit and auto")
    act = first[0][2].bool()
    rel = _rel(first[1][act], sched.first[1][act])
    check(rel <= BF16_REL_TOL, f"first-tick logits, explicit vs auto: rel "
          f"{rel}")
    out["auto"] = dict(
        {k: run[k] for k in ("wall_ms", "tokens", "tokens_per_s",
                             "ttft_wall_s", "decode_tick_wall_ms")},
        metrics=m, prefill=_prefill_record(sched, 0, "trace A auto"),
        first_tick_rel_err=rel,
        buckets={b: dict(graph_ms=wall_ms(lambda: g.run(torch.zeros(
            (3, b), dtype=torch.long)), SERVE_REPLAYS))
            for b, g in sched.graphs.items()},
        tokens_equal_explicit=sum(sched.streams[r] == streams[r]
                                  for r in streams),
        seconds=time.perf_counter() - t0)
    del sched, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _router_twice(cfg, params):
    """``cfg`` (f32, exact) explicit through ``build_replicas(n_replicas=
    2)``, the short trace twice (the second on fresh schedulers over the
    same engines): the same routing, streams and virtual-time metrics;
    then each request alone, token-equal."""
    import repro_torch.serve.router as router_mod
    Sched = _serve_scheduler()
    from repro_torch.serve.engine import ServeConfig
    trace = _serve_trace(TRACE_SHORT, cfg.vocab)
    step_s = TRACE_SHORT["step_s"]
    kw = dict(max_slots=BATCH, prefill_chunk=SERVE_CHUNK, fused_prefill=True)
    router = router_mod.build_replicas(
        cfg, ServeConfig(batch=BATCH, max_kv=MAX_KV, mode="explicit",
                         prefill_seq_buckets=SERVE_SHORT_BUCKETS),
        n_replicas=2, tp=TP, plan_dir=ROOT / "build" / "serve_plan_set_f32",
        params=params, mode="explicit", **kw)
    engines = [r.eng for r in router.replicas]
    runs = []
    for i in range(2):
        if i:
            router = router_mod.Router([Sched(e, **kw) for e in engines])
        _drive(router, trace, step_s)
        m = router.metrics()
        check(m["completed"] == len(trace) and m["dropped"] == 0,
              f"{cfg.name} f32 router: {m}")
        for i, r in enumerate(router.replicas):
            _healthy(r, f"{cfg.name} f32 router replica {i}")
        runs.append(dict(routed=dict(router.routed),
                         streams=dict(router.streams),
                         virtual={k: m[k] for k in (
                             "tokens", "tokens_per_vs", "ttft_vs",
                             "wait_vs", "bucket_steps")}))
        del router
        gc.collect()
        torch.cuda.empty_cache()
    check(runs[0] == runs[1], f"{cfg.name} f32: two runs of the trace "
          f"through the router routed, emitted or timed differently")
    sched = Sched(engines[0], gaps=True, **kw)
    base = _sequential(sched, trace, step_s)
    bar = _stream_bar(runs[0]["streams"], base, sched.gaps, SERVE_RID, 0.0,
                      f"{cfg.name} f32")
    del sched, engines
    gc.collect()
    torch.cuda.empty_cache()
    return dict(routed=sorted(runs[0]["routed"].items()),
                virtual=runs[0]["virtual"], vs_sequential=bar)


def _trace_b(cfg, params, device):
    """qwen3-1.7b explicit, trace B through ``build_replicas(n_replicas=2)``
    from one exported plan set: warm (a prefix cache a replica), then
    cold (none), the engines of one freed before the other's are built.
    Warm streams against cold ones to the bar, the hit rate, and the
    prefill micro-steps of each."""
    import repro_torch.serve.router as router_mod
    plan_dir = ROOT / "build" / "serve_plan_set"
    trace = _serve_trace(TRACE_B, cfg.vocab, hot=False)
    step_s = TRACE_B.get("step_s", 0.05)
    scfg_kw = dict(batch=BATCH, max_kv=MAX_KV, mode="explicit",
                   prefill_seq_buckets=SERVE_SEQ_BUCKETS)
    from repro_torch.serve.engine import ServeConfig
    out = {}
    Sched = _serve_scheduler()
    for name, tokens in (("warm", 0), ("cold", None)):
        saved = router_mod.Scheduler
        router_mod.Scheduler = functools.partial(Sched, gaps=True)
        try:
            router = router_mod.build_replicas(
                cfg, ServeConfig(**scfg_kw), n_replicas=2, tp=TP,
                plan_dir=plan_dir, params=params, mode="explicit",
                prefill_chunk=SERVE_CHUNK, fused_prefill=True,
                prefix_cache_tokens=tokens)
        finally:
            router_mod.Scheduler = saved
        run = _drive(router, trace, step_s)
        m = router.metrics()
        rep = router.plan_report()
        check(m["completed"] == len(trace) and m["dropped"] == 0,
              f"trace B {name}: {m}")
        check(rep["degraded"] == [], f"trace B {name}: degraded replicas "
              f"{rep['degraded']}")
        for i, r in enumerate(router.replicas):
            _healthy(r, f"trace B {name} replica {i}")
        out[name] = dict(
            {k: run[k] for k in ("wall_ms", "tokens", "tokens_per_s",
                                 "ttft_wall_s")},
            prefix_hit_rate=m["prefix_hit_rate"],
            prefix_tokens_reused=m["prefix_tokens_reused"],
            micro_steps=sum(p["micro_steps"] for p in m["per_replica"]),
            routed=sorted(router.routed.items()),
            streams=dict(router.streams),
            gaps={k: v for r in router.replicas for k, v in r.gaps.items()})
        del router, rep
        gc.collect()
        torch.cuda.empty_cache()
    check(out["warm"]["prefix_hit_rate"] > 0, "trace B: no prefix hit")
    out["warm_vs_cold"] = _stream_bar(
        out["warm"]["streams"], out["cold"]["streams"], out["cold"]["gaps"],
        0, SERVE_TIE_MARGIN, "trace B warm vs cold")
    for name in ("warm", "cold"):
        out[name].pop("streams")
        out[name].pop("gaps")
        out[name].pop("routed")
    return out


def _serve_short(cfg, params, label, per_tick, per_prefill, margin):
    """A short run (8 requests, every third at a temperature) of ``cfg``
    explicit through the scheduler, then sequential on the same
    scheduler: the streams' bar (``margin`` 0: token-equal), executor
    launches a replay and a fused prefill step."""
    Sched = _serve_scheduler()
    eng = _serve_engine(cfg, params, "explicit", SERVE_SHORT_BUCKETS)
    sched = Sched(eng, max_slots=BATCH, prefill_chunk=SERVE_CHUNK,
                  fused_prefill=True, gaps=True)
    for b, g in sched.graphs.items():
        check(g.launches == per_tick, f"{label}: bucket {b} captured "
              f"{g.launches} executor launches, want {per_tick}")
    trace = _serve_trace(TRACE_SHORT, cfg.vocab)
    run = _drive(sched, trace, TRACE_SHORT["step_s"])
    m = sched.metrics()
    check(m["completed"] == len(trace) and m["dropped"] == 0,
          f"{label}: {m}")
    _healthy(sched, label)
    streams = dict(sched.streams)
    prefill = _prefill_record(sched, per_prefill, label)
    base = _sequential(sched, trace, TRACE_SHORT["step_s"])
    bar = _stream_bar(streams, base, sched.gaps, SERVE_RID, margin, label)
    if not margin:
        check(bar["equal"] == len(trace), f"{label}: streams differ from "
              f"the sequential run")
    out = dict(tokens_per_s=run["tokens_per_s"], metrics=m, prefill=prefill,
               vs_sequential=bar, launches_per_tick=per_tick,
               launches_per_prefill_step=per_prefill)
    del sched, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve(device, gen):
    """The serving stack on the card: qwen3-1.7b at full width and depth
    (28 layers, bf16), TP=4 stacked on the card, served by a Scheduler of
    8 slots over ServeConfig(batch=8, max_kv=1024,
    prefill_seq_buckets=(16, 64, 256)), chunks of 4, fused prefill, in
    explicit and auto mode: trace A (32 requests, Poisson 4/s, Zipf 1.2
    prompts up to 512, up to 64 new tokens, every third at T = 0.8) and,
    explicit through 2 replicas from one exported plan set, trace B (24
    requests over 2 shared 256-token prefixes, T = 0.8) warm (a prefix
    cache a replica) and cold; then phi3.5-moe (2 layers) and hymba-1.5b
    (4 layers, heads padded to 40), 8 requests each, and qwen3-1.7b in
    f32 (4 layers) through a 2-replica router, twice, each against the
    sequential run.

    Every decode tick replays its slot bucket's graph (58 executor
    launches at every bucket, each cooperative, and 58 a replay by the
    profiler); every fused prefill micro-step runs eagerly and launches
    57 (the embedding's gather-reduce and 2 per layer; no logits
    gather). Gates: nothing dropped, every request done; each bucket's
    replay bit-equal to the eager step on the same state, and a row
    bit-equal at one bucket whatever its co-residents; streams against
    the sequential run (bf16: parting only at a step whose top-2 gap is
    under SERVE_TIE_MARGIN, itself at least twice the measured
    cross-bucket difference; f32: equal); warm streams against cold to
    the same bar; explicit against auto's first-tick logits within the
    bf16 bar; two runs of the f32 trace through the router route, emit
    and time alike; plan hits advance at every bucket used; nothing
    degraded."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = configs.get_config(ARCH)
    params = tf.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(21), device=device)
    a = _trace_a(cfg, params, device, gen)
    t = time.perf_counter()
    b = _trace_b(cfg, params, device)
    b["seconds"] = time.perf_counter() - t
    del params
    torch.cuda.empty_cache()
    short = {}
    moe = _moe_cfg(SERVE_MOE_LAYERS)
    p = tf.init_params(moe, torch.Generator(device=device).manual_seed(22),
                       device=device)
    t = time.perf_counter()
    short[MOE_ARCH] = _serve_short(moe, p, MOE_ARCH, 3 * moe.n_layers + 2,
                                   3 * moe.n_layers + 1, SERVE_TIE_MARGIN)
    short[MOE_ARCH]["seconds"] = time.perf_counter() - t
    del p
    torch.cuda.empty_cache()
    hyb = _hybrid_cfg(SERVE_HYBRID_LAYERS)
    p = tf.init_params(hyb, torch.Generator(device=device).manual_seed(23),
                       device=device)
    t = time.perf_counter()
    short[HYBRID_ARCH] = _serve_short(hyb, p, HYBRID_ARCH, 3 * hyb.n_layers,
                                      3 * hyb.n_layers, SERVE_TIE_MARGIN)
    short[HYBRID_ARCH]["seconds"] = time.perf_counter() - t
    del p
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, n_layers=SERVE_F32_LAYERS,
                              dtype="float32")
    p = tf.init_params(f32, torch.Generator(device=device).manual_seed(24),
                       device=device)
    t = time.perf_counter()
    short[f"{ARCH} f32 router"] = _router_twice(f32, p)
    short[f"{ARCH} f32 router"]["seconds"] = time.perf_counter() - t
    del p
    torch.cuda.empty_cache()
    emit("serve", card=RECORD["device"]["nvidia_smi"], arch=ARCH,
         n_layers=cfg.n_layers, tp=TP, slots=BATCH,
         max_kv=MAX_KV, seq_buckets=list(SERVE_SEQ_BUCKETS),
         prefill_chunk=SERVE_CHUNK, trace_a=TRACE_A, trace_b=TRACE_B,
         hot_temperature=SERVE_HOT_T, tie_margin=SERVE_TIE_MARGIN,
         trace_a_runs=a, trace_b_runs=b, short=short,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         seconds=time.perf_counter() - t0)
    return a


# ---------------------------------------------------------------------------
# phase 14: the collective API and its tuning loop
# ---------------------------------------------------------------------------
def _api_shape(collective, n, nbytes, esize):
    """A rank-stacked input of ``nbytes`` a rank: 256 columns (fewer for a
    block collective's 1 KiB), n row blocks for reduce_scatter and
    all_to_all."""
    elems = nbytes // esize
    per = n if collective in ("reduce_scatter", "all_to_all") else 1
    cols = min(API_COLS, elems // per)
    return (n, elems // cols, cols)


def _api_input(shape, dtype, gen, device):
    x = torch.randn(shape, generator=gen, device=device)
    return (x * 1000).to(dtype) if dtype == torch.int32 else x.to(dtype)


def _fold_bound(x, dtype) -> float:
    """How far two left-to-right folds of x's ranks in different orders
    (or one fold and torch's sum) can part: a rounding of at most half an
    ulp at each of the n - 1 adds of the partial sums, bounded by the sum
    of |x| over the ranks."""
    eps = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -24}[dtype]
    acc = x[0].float().abs()
    for r in range(1, x.shape[0]):          # rank by rank: one rank in f32
        acc += x[r].float().abs()
    return (x.shape[0] - 1) * eps * acc.max().item() * 2


def _api_calls(device, gen):
    """(a): every collective of ``api`` at each n, size and type on the
    executor kernel, bit-equal to ``backend="torch"`` on the card; a
    repeated call a plan hit with one executor launch; ``torch_native``
    within the fold bound (int32 and the moving collectives exactly),
    with its device µs beside the plan's at n = 4."""
    from repro_torch.core import api, comm
    from repro_torch.core.executor import CudaExecutor
    comm.reset_default_communicators()
    c = api.communicator("model")
    cases, rows = 0, []
    for n in API_N:
        for nbytes in API_SIZES:
            for dtype in API_DTYPES:
                for coll in API_COLLECTIVES:
                    esize = torch.empty((), dtype=dtype).element_size()
                    x = _api_input(_api_shape(coll, n, nbytes, esize), dtype,
                                   gen, device)
                    call = functools.partial(
                        getattr(api, coll), x, "model",
                        **({"root": n - 1} if coll == "broadcast" else {}))
                    got, want = call(), call(backend="torch")
                    label = f"api.{coll} n={n} {nbytes} B {dtype}"
                    check(torch.equal(got, want), f"{label}: kernel != plain")
                    hits, launches = c.stats["hits"], CudaExecutor.launches
                    again = call()
                    check(c.stats["hits"] == hits + 1
                          and CudaExecutor.launches == launches + 1,
                          f"{label}: a repeated call made "
                          f"{CudaExecutor.launches - launches} launches, "
                          f"{c.stats['hits'] - hits} hits")
                    check(torch.equal(again, want), f"{label}: replay")
                    native = call(backend="torch_native")
                    if dtype == torch.int32 or coll in (
                            "all_gather", "all_to_all", "broadcast"):
                        check(torch.equal(native, want),
                              f"{label}: torch_native != plan")
                        err, bound = 0.0, 0.0
                    else:
                        err = (native.float() - want.float()).abs().max()\
                            .item()
                        bound = _fold_bound(x, dtype)
                        check(err <= bound, f"{label}: torch_native parts "
                              f"from the plan by {err} > {bound}")
                    cases += 1
                    if n == TP:
                        plan = c.compile(coll, tuple(x.shape[1:]), dtype,
                                         n=n, device=device, root=n - 1)
                        ms, cov = device_ms(call, API_TIME_ITERS)
                        nat_ms, nat_cov = device_ms(
                            lambda: call(backend="torch_native")
                            .contiguous(), API_TIME_ITERS)
                        rows.append(dict(
                            collective=coll, n=n, bytes_per_rank=nbytes,
                            dtype=str(dtype).replace("torch.", ""),
                            algo=plan.algo, blocks_per_rank=plan.executor
                            .blocks, us=ms * 1e3, native_us=nat_ms * 1e3,
                            native_max_abs_err=err, fold_bound=bound,
                            sleep_covered=bool(cov and nat_cov)))
                    del x, got, want, again, native
    stats = dict(c.stats)
    comm.reset_default_communicators()
    torch.cuda.empty_cache()
    return dict(cases=cases, stats=stats, timing=rows)


def _stacked_tree(cfg, n, gen, device):
    """``cfg``'s parameter tree (the nesting of ``init_params``), every
    leaf rank-stacked ``(n, ...)``: seeded random bf16, leaf by leaf."""
    from repro_torch.models import transformer as tf
    base = tf.init_params(cfg, gen, device=device)

    def stack(t):
        if isinstance(t, dict):
            return {k: stack(t.pop(k)) for k in list(t)}
        if isinstance(t, (list, tuple)):
            return [stack(v) for v in t]
        return torch.randn((n,) + tuple(t.shape), generator=gen,
                           device=device, dtype=torch.bfloat16)

    return stack(base)


def _tree_call(device, gen):
    """(b): ``api.tree_all_reduce`` over qwen3-1.7b's whole parameter
    tree, bf16, TP ranks stacked: one executor launch, every leaf within
    the fold bound of its f32 sum; at 4 layers bit-equal to the plain
    version; device ms beside the HBM bound (every rank's leaves read
    once, written once) and ``torch_native``'s; the peak memory."""
    from repro_torch import configs
    from repro_torch.core import api, comm
    from repro_torch.tree import leaves as tree_leaves
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.kernels import comm_utils
    comm.reset_default_communicators()
    # the tree, its flat buffer, the reduced buffer and the plan's scratch
    # take 65 GB: drop the library kernels' cached workspaces that earlier
    # phases left (made again at their next call)
    comm_utils._WORKSPACES.clear()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_config(ARCH)
    small = _stacked_tree(dataclasses.replace(cfg, n_layers=4), TP, gen,
                          device)
    got = api.tree_all_reduce(small, "model")
    want = api.tree_all_reduce(small, "model", backend="torch")
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        check(torch.equal(g, w), "tree_all_reduce at 4 layers != plain")
    del small, got, want, g, w     # the leaves are views of the outputs
    comm.reset_default_communicators()
    torch.cuda.empty_cache()
    tree = _stacked_tree(cfg, TP, gen, device)
    leaves = tree_leaves(tree)
    elems = sum(leaf[0].numel() for leaf in leaves)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()   # the tree and any leftovers
    torch.cuda.reset_peak_memory_stats()
    before = CudaExecutor.launches
    out = api.tree_all_reduce(tree, "model")
    torch.cuda.synchronize()
    launches = CudaExecutor.launches - before
    check(launches == 1, f"tree_all_reduce made {launches} launches")
    peak = torch.cuda.max_memory_allocated()
    worst = 0.0
    for x, y in zip(leaves, tree_leaves(out)):
        want = x[0].float()
        for r in range(1, TP):
            want += x[r].float()
        err = (y[0].float() - want).abs().max().item()
        del want
        bound = _fold_bound(x, torch.bfloat16)
        worst = max(worst, err / bound)
        check(err <= bound, f"tree leaf {tuple(x.shape)}: {err} > {bound}")
        check(torch.equal(y, y[:1].expand_as(y)), "ranks disagree")
    del out, x, y          # the leaves are views of one reduced buffer
    plan = next(iter(api.communicator("model").plans().values()))
    ms, cov = device_ms(lambda: api.tree_all_reduce(tree, "model"),
                        TREE_TIME_ITERS)
    nat_ms, nat_cov = device_ms(
        lambda: api.tree_all_reduce(tree, "model", backend="torch_native"),
        TREE_TIME_ITERS)
    nbytes = 2 * TP * elems * 2
    rec = dict(arch=ARCH, n_layers=cfg.n_layers, leaves=len(leaves),
               elements_per_rank=elems, ranks=TP, dtype="bfloat16",
               algo=plan.algo, rows=plan.shape[0], cols=plan.shape[1],
               launches=launches, ms=ms, native_ms=nat_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               worst_err_over_bound=worst, peak_gb=peak / 1e9,
               resident_before_gb=resident / 1e9,
               sleep_covered=bool(cov and nat_cov))
    del tree, leaves
    comm.reset_default_communicators()
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _trace_shape(collective, nbytes):
    """(rows, cols) a rank of ``nbytes`` bf16 at TRACE_COLS columns."""
    return (nbytes // 2 // TRACE_COLS, TRACE_COLS)


def _stamp_checks(tr) -> dict:
    """(c)'s gates on one device trace: every event completes at or after
    its issue; each block's raw stamps run forward (start <= end <= next
    start) on both timers; on the raw best run, no wait ends more than
    one tick before the latest end of the puts it waits for."""
    from repro_torch.core.trace import _stamp_times
    dev = tr.device
    st = dev["stamps"]
    check(all(ev.complete_us >= ev.issue_us for ev in tr.events),
          f"{tr.algo}: an event completes before its issue")
    for g in ((0, 1), (2, 3)):
        seq = st[:, :, g].reshape(st.shape[0], -1)
        check(bool((np.diff(seq, axis=1) >= 0).all()),
              f"{tr.algo}: a block's stamps run backwards")
    start, end = _stamp_times(st, dev["timer"], dev["cycles_per_ns"])
    nb = dev["blocks"]
    ends = {}
    for e, ev in enumerate(tr.events):
        r, i = dev["index"][e]
        ends[(ev.iid, ev.sub, ev.rank)] = end[r * nb:(r + 1) * nb, i].max()
    worst = 0.0
    for e, ev in enumerate(tr.events):
        if ev.op == "wait" and ev.deps:
            r, i = dev["index"][e]
            early = max(ends[tuple(d)] for d in ev.deps) - \
                end[r * nb:(r + 1) * nb, i].max()
            worst = max(worst, early)
    check(worst <= dev["tick_ns"], f"{tr.algo}: a wait ended {worst} ns "
          f"before its puts (tick {dev['tick_ns']} ns)")
    return dict(wait_before_put_ns=worst, tick_ns=dev["tick_ns"],
                stamp_tick_ns=dev["stamp_tick_ns"])


def _traces(device, gen):
    """(c): every registry candidate of all_reduce, all_gather and
    reduce_scatter at n = 4, O0 and O2, bf16, at each TRACE_SIZES: the
    traced kernel's output bit-equal to the untraced one, the stamp
    gates, and the plan's untraced and traced device µs."""
    from repro_torch.core import selector as sel
    from repro_torch.core import trace
    from repro_torch.core.comm import Communicator
    from repro_torch.core.executor import device_timer
    timer = device_timer(device)
    c = Communicator("model", n=TP, device=device)
    traces, rows = [], []
    for coll in TRACE_COLLECTIVES:
        for algo in sel.CANDIDATES[coll]:
            for lvl in (0, 2):
                for nbytes in TRACE_SIZES:
                    shape = _trace_shape(coll, nbytes)
                    plan = c.compile(coll, shape, torch.bfloat16, algo=algo,
                                     opt_level=lvl)
                    check(plan.pad == 0, f"{algo}: padded trace shape")
                    x = torch.randn((TP,) + shape, generator=gen,
                                    device=device).to(torch.bfloat16)
                    tr = plan.capture_trace(x)
                    out_t, _ = plan.executor.launch_traced(x)
                    check(torch.equal(out_t, plan(x)),
                          f"{algo} O{lvl} {nbytes} B: traced != untraced")
                    gates = _stamp_checks(tr)
                    us, cov = device_ms(lambda: plan(x), TRACE_TIME_ITERS)
                    t_us, t_cov = device_ms(
                        lambda: plan.executor.launch_traced(x),
                        TRACE_TIME_ITERS)
                    traces.append(tr)
                    rows.append(dict(
                        collective=coll, algo=algo, opt_level=lvl,
                        bytes_per_rank=nbytes, events=len(tr.events),
                        span_us=tr.span_us, us=us * 1e3, traced_us=t_us * 1e3,
                        overhead=t_us / us, timer=tr.device["timer"],
                        median_op_ns=tr.device["median_op_ns"],
                        blocks_per_rank=plan.executor.blocks,
                        traced_blocks_per_rank=tr.device["blocks"],
                        sleep_covered=bool(cov and t_cov), **gates))
                    del x, out_t
    return traces, rows, timer


def _fit_and_predict(traces, rows):
    """(d): the card's link from the three smaller sizes' traces; each
    16 MiB trace replayed under it, and every other candidate of its
    collective and level predicted from it, beside the measured µs."""
    from repro_torch.core import selector as sel
    from repro_torch.core import simulate
    big = max(TRACE_SIZES)
    fit_on = [t for t, r in zip(traces, rows) if r["bytes_per_rank"] < big]
    link = sel.fit_from_traces(fit_on)      # a degenerate fit raises
    measured = {(r["collective"], r["algo"], r["opt_level"],
                 r["bytes_per_rank"]): r for r in rows}
    preds = []
    for t, r in zip(traces, rows):
        if r["bytes_per_rank"] != big:
            continue
        rep = simulate.replay(t, link=link)
        entry = dict(collective=r["collective"], algo=r["algo"],
                     opt_level=r["opt_level"], measured_us=r["us"],
                     span_us=t.span_us, replay_us=rep.predicted_us,
                     replay_rel_err=abs(rep.predicted_us - r["us"]) / r["us"],
                     whatif={})
        for other in sel.CANDIDATES[r["collective"]]:
            if other == r["algo"]:
                continue
            w = simulate.whatif(t, algo=other, link=link)
            m = measured[(r["collective"], other, r["opt_level"], big)]["us"]
            entry["whatif"][other] = dict(
                predicted_us=w.predicted_us, measured_us=m,
                rel_err=abs(w.predicted_us - m) / m)
        preds.append(entry)
    return link, preds


def _selection(device, gen, link, traces, rows):
    """(e): at each decode plan shape and at (c)'s sizes, the algorithm
    ``choose`` picks under UNFITTED and under the fitted link, the one
    the table from the O2 traces picks, and the fastest candidate by
    CUDA events (O2)."""
    from repro_torch.core import selector as sel
    from repro_torch.core.comm import Communicator
    o2 = [t for t, r in zip(traces, rows) if r["opt_level"] == 2]
    table = sel.TuningTable.from_traces(o2, link=link)
    c = Communicator("model", n=TP, device=device)
    moe = _moe_cfg(MOE_LAYERS)
    from repro_torch import configs
    from repro_torch.distributed.moe_parallel import ep_capacity
    qwen = configs.get_config(ARCH)
    cap = moe.moe.num_experts // TP * ep_capacity(BATCH, moe.moe.top_k)
    points = [("qwen3-1.7b layer_allreduce", "all_reduce",
               (BATCH, qwen.d_model), torch.bfloat16),
              ("qwen3-1.7b logits_allgather", "all_gather",
               (BATCH, qwen.vocab // TP), torch.float32),
              ("phi3.5-moe moe_alltoall", "all_to_all",
               (TP * cap, moe.d_model), torch.bfloat16),
              ("hymba-1.5b layer_allreduce", "all_reduce",
               (BATCH, _hybrid_cfg().d_model), torch.bfloat16)]
    points += [(f"{coll} {nbytes} B", coll, _trace_shape(coll, nbytes),
                torch.bfloat16) for coll in TRACE_COLLECTIVES
               for nbytes in TRACE_SIZES]
    out = []
    for label, coll, shape, dtype in points:
        esize = torch.empty((), dtype=dtype).element_size()
        nbytes = shape[0] * shape[1] * esize * (TP if coll == "all_gather"
                                                else 1)
        x = torch.randn((TP,) + shape, generator=gen,
                        device=device).to(dtype)
        measured = {}
        for algo in sel.CANDIDATES[coll]:
            if not sel.supports(algo, TP):
                continue
            plan = c.compile(coll, shape, dtype, algo=algo, opt_level=2)
            ms, _ = device_ms(lambda: plan(x), TRACE_TIME_ITERS)
            measured[algo] = ms * 1e3
        out.append(dict(
            point=label, collective=coll, shape=list(shape),
            dtype=str(dtype).replace("torch.", ""), nbytes=nbytes,
            unfitted=sel.choose(coll, n=TP, nbytes=nbytes),
            fitted=sel.choose(coll, n=TP, nbytes=nbytes, link=link),
            table=sel.choose(coll, n=TP, nbytes=nbytes, link=link,
                             table=table),
            fastest=min(measured, key=measured.get), measured_us=measured))
        del x
    return table, out


def _traced_engine(device):
    """(f): qwen3-1.7b explicit at full width, 4 layers, with
    ``ServeConfig(trace=True)``: one device trace per plan, recorded
    before the capture; the graph holds untraced executor nodes only,
    each cooperative; tokens equal to the untraced engine's."""
    from repro_torch import configs
    from repro_torch.core.executor import CudaExecutor, graph_nodes
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = dataclasses.replace(configs.get_config(ARCH), n_layers=4)
    gen = torch.Generator(device=device).manual_seed(14)
    params = tf.init_params(cfg, gen, device=device)
    prompts = np.random.RandomState(14).randint(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)
    runs = {}
    for traced in (False, True):
        eng = Engine(cfg, params, ServeConfig(batch=BATCH, max_kv=MAX_KV,
                                              trace=traced),
                     tp=TP, mode="explicit")
        t0 = CudaExecutor.traced_launches
        eng.capture()
        nodes, coop, traced_nodes = graph_nodes(eng.graph.graph)
        report = eng.plan_report()
        out = _serve(eng, prompts, 16)
        runs[traced] = dict(
            tokens=out["tokens"], nodes=nodes, cooperative=coop,
            traced_nodes=traced_nodes, launches=eng.graph.launches,
            traced_launches=CudaExecutor.traced_launches - t0,
            trace={k: v for k, v in report["trace"].items()},
            ms_per_token=out["ms_per_token"])
        check(nodes == coop == eng.graph.launches and traced_nodes == 0,
              f"traced={traced}: graph nodes {nodes}, cooperative {coop}, "
              f"traced {traced_nodes}, launches {eng.graph.launches}")
        del eng
        gc.collect()
    on, off = runs[True], runs[False]
    check(all(v is not None and v["backend"] == "cuda" and v["events"] > 0
              for v in on["trace"].values()),
          f"plan_report()['trace'] without a device trace a plan: "
          f"{on['trace']}")
    check(all(v is None for v in off["trace"].values()),
          "an untraced engine recorded traces")
    check(np.array_equal(on["tokens"], off["tokens"]),
          "traced engine's tokens differ from the untraced engine's")
    del params
    torch.cuda.empty_cache()
    return dict(n_layers=cfg.n_layers, graph_nodes=on["nodes"],
                cooperative=on["cooperative"], traced_nodes=on["traced_nodes"],
                traced_launches_before_capture=on["traced_launches"],
                plans_traced=sorted(on["trace"]), traces=on["trace"],
                tokens_equal=True, ms_per_token=on["ms_per_token"],
                ms_per_token_untraced=off["ms_per_token"])


def phase_api(device, gen):
    """Phase 14: the collective API and its tuning loop on the card."""
    from repro_torch.core.executor import CudaExecutor
    t = time.perf_counter()
    smi = nvidia_smi()
    a = _api_calls(device, gen)
    emit("api", **a, seconds=round(time.perf_counter() - t, 3))
    b = _tree_call(device, gen)
    emit("api_tree", **b)
    traces, rows, timer = _traces(device, gen)
    emit("api_traces", plans=len(rows), timer=timer, rows=rows,
         traced_launches=CudaExecutor.traced_launches)
    link, preds = _fit_and_predict(traces, rows)
    emit("api_fit", card=smi, link=dataclasses.asdict(link),
         fitted_on=[s for s in TRACE_SIZES if s < max(TRACE_SIZES)],
         predictions=preds)
    table, choices = _selection(device, gen, link, traces, rows)
    emit("api_selection", card=smi, link=dataclasses.asdict(link),
         table=table.entries, choices=choices)
    f = _traced_engine(device)
    emit("api_engine", **f, seconds=round(time.perf_counter() - t, 3))
    overhead = sorted(r["overhead"] for r in rows)
    return dict(traced_overhead_median=overhead[len(overhead) // 2],
                traced_overhead_max=overhead[-1],
                traced_overhead_by_size={
                    s: float(np.median([r["overhead"] for r in rows
                                        if r["bytes_per_rank"] == s]))
                    for s in TRACE_SIZES},
                timer=timer["tick_ns"], traced_shapes=len(rows))


# ---------------------------------------------------------------------------
# phase 15: the robustness layer (faults and the serving guardrails)
# ---------------------------------------------------------------------------
def _healthy(x, label):
    """An engine or scheduler that served as it was asked: its running
    mode the requested one, nothing degraded, and every guardrail counter
    at 0 (a fallback would leave the executor kernel for the plain
    model)."""
    eng = getattr(x, "eng", x)
    rep = x.plan_report()
    check(rep["mode"] == eng.requested_mode and not rep["degraded"],
          f"{label}: serving {rep['mode']}, requested {eng.requested_mode}")
    moved = {k: eng.health[k] for k in CHAOS_COUNTERS if eng.health[k]}
    check(not moved, f"{label}: guardrail counters moved: {moved}")


def _chaos_engine(cfg, params, mode, **kw):
    from repro_torch.serve.engine import Engine, ServeConfig
    return Engine(cfg, params, ServeConfig(batch=BATCH, max_kv=MAX_KV, **kw),
                  tp=TP, mode=mode)


def _free():
    """Release what the caller dropped (its references go first)."""
    gc.collect()
    torch.cuda.empty_cache()


def _graph_record(eng):
    from repro_torch.core.executor import graph_nodes
    nodes = graph_nodes(eng.graph.graph)
    return dict(launches=eng.graph.launches, executor_nodes=nodes[0],
                cooperative=nodes[1], traced=nodes[2])


def _guard_costs(device):
    """The two guards' own host costs, apart from a step: the numeric
    guard's ``isfinite().all()`` read over BATCH x vocab f32 logits on the
    card (one sync), and the watchdog's handoff of a no-op to a worker
    thread and back. Median µs of CHAOS_COST_ITERS."""
    import concurrent.futures
    from repro_torch import configs
    logits = torch.randn(BATCH, configs.get_config(ARCH).vocab,
                         device=device)
    out = {}
    bool(torch.isfinite(logits).all())
    ts = []
    for _ in range(CHAOS_COST_ITERS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        bool(torch.isfinite(logits).all())
        ts.append((time.perf_counter() - t) * 1e6)
    out["numeric_guard_us"] = float(np.median(ts))
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    pool.submit(lambda: None).result()
    ts = []
    for _ in range(CHAOS_COST_ITERS):
        t = time.perf_counter()
        pool.submit(lambda: None).result(timeout=CHAOS_TIMEOUT_S)
        ts.append((time.perf_counter() - t) * 1e6)
    pool.shutdown()
    out["watchdog_handoff_us"] = float(np.median(ts))
    return out


def _chaos_guards(cfg, params, prompts, per_step):
    """(a) every guard armed, no fault, against the same engine unguarded
    (and each guard alone): explicit, counters 0, the same graph, tokens
    equal and first-step logits bit-equal; then ms/token of each, the
    engines' decode loops interleaved over CHAOS_TIME_ROUNDS rounds, each
    round starting at the next engine."""
    kws = {"unguarded": {},
           "guarded": dict(guard_numerics=True,
                           plan_timeout_s=CHAOS_TIMEOUT_S),
           "numeric_guard": dict(guard_numerics=True),
           "watchdog": dict(plan_timeout_s=CHAOS_TIMEOUT_S)}
    engines, runs = {}, {}
    for name, kw in kws.items():
        eng = _chaos_engine(cfg, params, "explicit", **kw)
        r = _serve(eng, prompts, DECODE)
        g = _graph_record(eng)
        check(g == dict(launches=per_step, executor_nodes=per_step,
                        cooperative=per_step, traced=0),
              f"chaos (a) {name}: graph {g}, want {per_step} cooperative "
              f"executor nodes")
        _healthy(eng, f"chaos (a) {name}")
        engines[name], runs[name] = eng, dict(graph=g, tokens=r["tokens"],
                                              first=r["first"])
    base = runs["unguarded"]
    for name, r in runs.items():
        check(np.array_equal(r["tokens"], base["tokens"]),
              f"chaos (a) {name}: tokens differ from unguarded")
        check(torch.equal(r["first"], base["first"]),
              f"chaos (a) {name}: first-step logits not bit-equal")
    # serving ms/token (a step, the draw and its host read, and each
    # guard's own work), the engines' loops interleaved
    times, logits = {name: [] for name in engines}, {}
    for name, eng in engines.items():
        logits[name] = eng._run_step(torch.zeros(BATCH, dtype=torch.long,
                                                 device=eng.device))
        eng.pos += 1
    names = list(engines)
    for k in range(CHAOS_TIME_ROUNDS):
        # each round starts at another engine: no engine always follows
        # the same one
        for name in names[k % len(names):] + names[:k % len(names)]:
            eng = engines[name]
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.decode(logits[name], num_tokens=CHAOS_TIME_STEPS)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3
                               / CHAOS_TIME_STEPS)
    for name, eng in engines.items():
        _healthy(eng, f"chaos (a) {name} timed")
    ms = {name: float(np.median(v)) for name, v in times.items()}
    out = dict(graph=base["graph"], ms_per_token=ms,
               ms_per_token_rounds=times,
               guarded_over_unguarded=ms["guarded"] / ms["unguarded"])
    clean_explicit = dict(tokens=base["tokens"], first=base["first"])
    engines.clear()
    _free()
    return out, clean_explicit


def _chaos_faults(cfg, params, prompts, clean_explicit):
    """(b) each runtime fault fired at the explicit engine's capture: a
    transient retried (explicit, tokens equal to the clean explicit
    run's); a persistent one, a poisoned payload under the numeric guard
    and a stall past the watchdog each falling back at step 0 (tokens
    and first logits bit-equal to a clean auto engine's, no executor
    node left), the stalled worker leaving the cache as it was when it
    wakes. Peak device memory over the persistent case's fallback."""
    import warnings
    from repro_torch.core import faults
    eng = _chaos_engine(cfg, params, "auto")
    auto = _serve(eng, prompts, DECODE)
    del eng
    _free()
    cases = (("fail_call", faults.FaultSpec("fail_call", count=1), {}),
             ("fail_call_persistent",
              faults.FaultSpec("fail_call", count=100), {}),
             ("corrupt_chunk", faults.FaultSpec("corrupt_chunk", count=1),
              dict(guard_numerics=True)),
             ("stall_rank", faults.FaultSpec("stall_rank", count=1,
                                             delay_s=CHAOS_STALL[1]),
              dict(plan_timeout_s=CHAOS_STALL[0])))
    out = {}
    for name, spec, kw in cases:
        t0 = time.perf_counter()
        eng = _chaos_engine(cfg, params, "explicit", **kw)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            with faults.inject(spec) as inj:
                r = _serve(eng, prompts, DECODE)
        # no device-wide sync yet: a stalled worker may still capture
        torch.cuda.current_stream().synchronize()
        rec = dict(fired=inj.fired, mode=eng.mode, health=dict(eng.health),
                   warnings=[str(w.message)[:160] for w in warned],
                   graph=_graph_record(eng),
                   memory_before_gb=before / 1e9,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        check(inj.fired >= 1, f"chaos (b) {name}: the fault never fired")
        if name == "fail_call":
            check(eng.mode == "explicit" and eng.health["retries"] == 1
                  and eng.health["fallbacks"] == 0,
                  f"chaos (b) {name}: {rec}")
            check(np.array_equal(r["tokens"], clean_explicit["tokens"]),
                  f"chaos (b) {name}: tokens differ from the clean run's")
            rec["first_bit_equal_clean_explicit"] = bool(
                torch.equal(r["first"], clean_explicit["first"]))
        else:
            check(eng.mode == "auto" and eng.requested_mode == "explicit"
                  and eng.health["fallbacks"] == 1,
                  f"chaos (b) {name}: no fallback: {rec}")
            check(any("falling back to auto" in w for w in rec["warnings"]),
                  f"chaos (b) {name}: no fallback warning")
            check(np.array_equal(r["tokens"], auto["tokens"])
                  and torch.equal(r["first"], auto["first"]),
                  f"chaos (b) {name}: tokens or first logits differ from "
                  f"the clean auto engine's")
            check(rec["graph"]["launches"] == 0
                  and rec["graph"]["executor_nodes"] == 0,
                  f"chaos (b) {name}: executor nodes after the fallback: "
                  f"{rec['graph']}")
        if name == "fail_call_persistent":
            check(eng.health["retries"] == 2 and inj.fired == 3,
                  f"chaos (b) {name}: {rec}")
        if name == "corrupt_chunk":
            check(eng.health["faults_detected"] == 1,
                  f"chaos (b) {name}: {rec}")
        if name == "stall_rank":
            check(eng.health["timeouts"] == 1 and len(eng.abandoned) == 1,
                  f"chaos (b) {name}: {rec}")
            saved = _snapshot(eng.cache)
            worker = eng.abandoned[0]
            rec["worker_done_before_wait"] = worker.done()
            exc = worker.exception(timeout=4 * CHAOS_STALL[1])
            torch.cuda.synchronize()
            rec["worker_ended_with"] = type(exc).__name__
            check(type(exc).__name__ == "_Abandoned",
                  f"chaos (b) {name}: the abandoned worker ended with {exc!r}")
            check(all(torch.equal(a, b) for k in saved
                      for a, b in zip(eng.cache[k], saved[k])),
                  f"chaos (b) {name}: the woken worker wrote the cache")
        rec["seconds"] = time.perf_counter() - t0
        out[name] = rec
        del eng, r
        _free()
    return out


def _drive_faulted(target, trace, step_s, at_tick, spec):
    """``loadgen.run_load`` on ``target`` with ``spec`` installed once
    ``at_tick`` ticks have run (cleared at the end): the injector."""
    from collections import deque
    from repro_torch.core import faults
    pending = deque(sorted(trace, key=lambda r: (r.arrival_s, r.rid)))
    ticks, inj = 0, None
    try:
        while pending or target.outstanding():
            while pending and pending[0].arrival_s <= target.now:
                target.submit(pending.popleft())
            if target.n_active == 0 and target.outstanding() == 0 \
                    and pending:
                target.advance_to(pending[0].arrival_s)
                continue
            if ticks == at_tick:
                inj = faults.install(spec)
            info = target.tick()
            ticks += 1
            target.advance(step_s * (1 + info.micro_steps))
    finally:
        faults.clear()
    return inj


def _chaos_scheduler(cfg, params, label, margin, buckets):
    """(c) a fault fired in an eager fused prefill step after
    CHAOS_FAULT_TICK ticks of trace A's first CHAOS_REQUESTS requests:
    the scheduler warns, counts one fallback, converts its engine's cache
    and re-runs the step on auto; every stream against the sequential run
    on the same (now auto) scheduler, at ``margin``; the router names the
    replica in ``degraded``."""
    import warnings
    from repro_torch.core import faults
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.serve.router import Router
    Sched = _serve_scheduler()
    t0 = time.perf_counter()
    eng = _serve_engine(cfg, params, "explicit", buckets)
    sched = Sched(eng, max_slots=BATCH, prefill_chunk=SERVE_CHUNK,
                  fused_prefill=True, gaps=True)
    router = Router([sched])
    trace = _serve_trace(TRACE_A, cfg.vocab)[:CHAOS_REQUESTS]
    step_s = TRACE_A["step_s"]
    launches = CudaExecutor.launches
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        inj = _drive_faulted(router, trace, step_s, CHAOS_FAULT_TICK,
                             faults.FaultSpec("fail_call", count=1))
    torch.cuda.synchronize()
    m = router.metrics()
    rep = router.plan_report()
    check(inj is not None and inj.fired == 1,
          f"{label}: the fault did not fire once")
    check(m["completed"] == len(trace) and m["dropped"] == 0,
          f"{label}: {m}")
    check(sched.mode == eng.mode == "auto"
          and eng.health["fallbacks"] == 1
          and rep["degraded"] == [0] and rep["modes"] == ["auto"],
          f"{label}: not one fallback: {rep['modes']} {rep['degraded']} "
          f"{eng.health}")
    check(any("falling back to auto" in str(w.message) for w in warned),
          f"{label}: no fallback warning")
    check(all(g.launches == 0 for g in sched.graphs.values()),
          f"{label}: executor nodes in the auto graphs")
    streams = dict(sched.streams)
    base = _sequential(sched, trace, step_s)
    bar = _stream_bar(streams, base, sched.gaps, SERVE_RID, margin, label)
    if not margin:
        check(bar["equal"] == len(trace), f"{label}: streams differ from "
              f"the sequential run")
    out = dict(fault_tick=CHAOS_FAULT_TICK, requests=len(trace),
               launches_before_fallback=CudaExecutor.launches - launches,
               prefill_steps_explicit=sum(
                   1 for _, _, n, _, _ in sched.prefill_log if n),
               degraded=rep["degraded"], health=dict(eng.health),
               vs_sequential=bar, seconds=time.perf_counter() - t0)
    del router, sched, eng
    _free()
    return out


def _chaos_launcher():
    """(d) ``python -m repro_torch.launch.serve`` in-process, explicit at
    CHAOS_LAUNCH_LAYERS layers: the one-shot path and the router path
    (2 replicas from one exported plan set)."""
    import io
    from repro_torch.launch import serve as launch
    out = {}
    common = ["--arch", ARCH, "--tp", str(TP), "--mode", "explicit",
              "--layers", str(CHAOS_LAUNCH_LAYERS)]
    for name, extra in (
            ("one_shot", []),
            ("router", ["--replicas", "2", "--requests", "8",
                        "--plan-dir", str(ROOT / "build" / "launch_plans")])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = launch.main(common + extra)
        lines = buf.getvalue().strip().splitlines()
        out[name] = dict(rc=rc, lines=lines,
                         seconds=time.perf_counter() - t0)
        check(rc == 0, f"launcher {name}: rc {rc}")
        _free()
    one, router = out["one_shot"]["lines"], out["router"]["lines"]
    check(len(one) == 2 and "mode=explicit" in one[0]
          and one[1].startswith("seq0: ["), f"launcher one-shot: {one}")
    check(len(router) == 3 and "degraded=[]" in router[0]
          and "modes=['explicit', 'explicit']" in router[0]
          and "served 8/8 requests (0 dropped)" in router[1],
          f"launcher router: {router}")
    return out


def _chaos_unrecoverable(cfg, params, prompts):
    """(e) four failures that must propagate, counting nothing: a
    planted kernel build failure (a stand-in ``nvcc`` that fails, an
    empty build directory, no library loaded) out of ``Engine()``, out of
    an engine's first step and out of a scheduler's fused prefill step
    at a new row bucket; a launch the runtime refuses (the executor's
    launch asks for more blocks a rank than the card keeps resident, so
    the cooperative launch returns a non-zero ``cudaError_t``) out of a
    watched, guarded engine's capture and a scheduler's prefill step,
    the card usable after it; a planted CUDA error
    (``torch.AcceleratorError`` where this torch has it) out of an
    engine's capture and a scheduler's prefill step; and the capture's
    node check (a node count one short) out of an engine's capture."""
    import os
    import shutil
    import repro_torch.core.executor as ex
    from repro_torch.distributed.step import CaptureError
    from repro_torch.kernels import build
    from repro_torch.kernels.build import KernelBuildError, KernelLaunchError
    from repro_torch.serve.scheduler import Request
    out = {}

    def propagates(name, exc_type, fn, eng):
        try:
            fn()
        except exc_type as e:
            out[name] = dict(raised=type(e).__name__,
                             message=str(e)[:240],
                             mode=eng.mode if eng is not None else None,
                             health=dict(eng.health) if eng else None)
        else:
            check(False, f"chaos (e) {name}: {exc_type.__name__} did not "
                  f"propagate")
        if eng is not None:
            check(eng.mode == "explicit"
                  and not any(eng.health[k] for k in CHAOS_COUNTERS),
                  f"chaos (e) {name}: {eng.mode} {eng.health}")

    def sched_with_prompt():
        Sched = _serve_scheduler()
        eng = _serve_engine(cfg, params, "explicit", SERVE_SHORT_BUCKETS)
        sched = Sched(eng, max_slots=BATCH, prefill_chunk=SERVE_CHUNK,
                      fused_prefill=True)
        sched.submit(Request(0, np.arange(1, 40, dtype=np.int32), 4))
        return sched, eng

    # the planted build failure
    fake = ROOT / "build" / "chaos_nvcc"
    (fake / "bin").mkdir(parents=True, exist_ok=True)
    nvcc = fake / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'stand-in nvcc: planted failure' >&2\n"
                    "exit 1\n")
    nvcc.chmod(0o755)
    empty = ROOT / "build" / "chaos_empty"
    shutil.rmtree(empty, ignore_errors=True)
    empty.mkdir(parents=True)
    eng = _chaos_engine(cfg, params, "explicit")
    sched, seng = sched_with_prompt()
    env = {k: os.environ.get(k) for k in ("CUDA_HOME",
                                          "REPRO_TORCH_BUILD_DIR")}
    libs, bound = dict(build._LIBS), dict(build._BOUND)
    try:
        build._LIBS.clear()
        build._BOUND.clear()
        os.environ["CUDA_HOME"] = str(fake)
        os.environ["REPRO_TORCH_BUILD_DIR"] = str(empty)
        propagates("build_engine_init", KernelBuildError,
                   lambda: _chaos_engine(cfg, params, "explicit"), None)
        propagates("build_engine_step", KernelBuildError,
                   lambda: _serve(eng, prompts, 1), eng)
        propagates("build_scheduler_prefill", KernelBuildError,
                   sched.tick, seng)
    finally:
        build._LIBS.update(libs)
        build._BOUND.update(bound)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del eng, sched, seng
    _free()

    # a launch the runtime refuses: the executor library's launch asked
    # for CHAOS_REFUSED_BLOCKS blocks a rank, more than a cooperative
    # launch keeps resident, so cudaLaunchKernelEx returns an error and
    # no block runs
    lib = build.executor_library()

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        def dsl_executor_launch(self, *args):
            args = list(args)
            args[14] = CHAOS_REFUSED_BLOCKS      # nb, the blocks a rank
            return lib.dsl_executor_launch(*args)

    eng = _chaos_engine(cfg, params, "explicit", guard_numerics=True,
                        plan_timeout_s=CHAOS_TIMEOUT_S)
    sched, seng = sched_with_prompt()
    library = build.executor_library
    build.executor_library = lambda: Refusing()
    try:
        propagates("launch_refused_engine", KernelLaunchError,
                   lambda: _serve(eng, prompts, 1), eng)
        propagates("launch_refused_scheduler_prefill", KernelLaunchError,
                   sched.tick, seng)
    finally:
        build.executor_library = library
    # the thread that saw the refusal launches the kernel again: the
    # refusal's error is not left behind for that launch to report
    from repro_torch.core import algorithms
    y = torch.randn(TP, 64, 256, device=eng.device)
    after = ex.CudaExecutor(algorithms.REGISTRY["allreduce_1pa"](TP)) \
        .prepare(TP)(y)
    torch.cuda.synchronize()
    out["card_usable_after_refusal"] = bool(torch.allclose(
        after, y.sum(0).expand_as(after), atol=1e-4))
    check(out["card_usable_after_refusal"],
          "chaos (e): the kernel's next launch after a refused one failed "
          "or disagrees with the sum")
    for k in ("launch_refused_engine", "launch_refused_scheduler_prefill"):
        check("cooperative launch" in out[k]["message"],
              f"chaos (e) {k}: not the runtime's refusal: "
              f"{out[k]['message']}")
    del eng, sched, seng
    _free()

    # the planted CUDA error
    accel = getattr(torch, "AcceleratorError", None)
    msg = "CUDA error: an illegal memory access was encountered (planted)"
    planted = accel(msg) if accel is not None else RuntimeError(msg)
    out["cuda_error_type"] = type(planted).__name__
    eng = _chaos_engine(cfg, params, "explicit", guard_numerics=True,
                        plan_timeout_s=CHAOS_TIMEOUT_S)
    sched, seng = sched_with_prompt()
    launch = ex.CudaExecutor._launch

    def sticky(self, *a, **kw):
        raise planted

    ex.CudaExecutor._launch = sticky
    try:
        propagates("cuda_error_engine", type(planted),
                   lambda: _serve(eng, prompts, 1), eng)
        propagates("cuda_error_scheduler_prefill", type(planted),
                   sched.tick, seng)
    finally:
        ex.CudaExecutor._launch = launch
    del eng, sched, seng
    _free()

    # the capture's node check
    eng = _chaos_engine(cfg, params, "explicit")
    nodes = ex.graph_nodes
    ex.graph_nodes = lambda g: tuple(max(v - 1, 0) for v in nodes(g))
    try:
        propagates("capture_check_engine", CaptureError,
                   lambda: _serve(eng, prompts, 1), eng)
    finally:
        ex.graph_nodes = nodes
    del eng
    _free()
    return out


def phase_chaos(device):
    """Phase 15: the robustness layer on the card (qwen3-1.7b, TP=4,
    bf16): (a) the guards armed against unguarded; (b) each runtime fault
    fired at the explicit engine's capture; (c) a mid-stream scheduler
    fallback in f32 at 4 layers (qwen3-1.7b and hymba-1.5b) and in bf16
    at full depth; (d) the launcher; (e) the failures that propagate."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(ARCH)
    params = tf.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(31), device=device)
    prompts = np.random.RandomState(31).randint(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)
    per_step = 2 * cfg.n_layers + 2
    sec = {}
    t = time.perf_counter()
    costs = _guard_costs(device)
    guards, clean = _chaos_guards(cfg, params, prompts, per_step)
    sec["a"] = time.perf_counter() - t
    t = time.perf_counter()
    fault_runs = _chaos_faults(cfg, params, prompts, clean)
    sec["b"] = time.perf_counter() - t
    t = time.perf_counter()
    sched = {f"{ARCH} bf16": _chaos_scheduler(
        cfg, params, f"chaos (c) {ARCH} bf16", SERVE_TIE_MARGIN,
        SERVE_SEQ_BUCKETS)}
    del params
    _free()
    for arch_cfg, seed in (
            (dataclasses.replace(cfg, n_layers=CHAOS_F32_LAYERS,
                                 dtype="float32"), 32),
            (_hybrid_cfg(CHAOS_F32_LAYERS, dtype="float32"), 33)):
        p = tf.init_params(arch_cfg, torch.Generator(device=device)
                           .manual_seed(seed), device=device)
        label = f"{arch_cfg.name} f32 {CHAOS_F32_LAYERS} layers"
        sched[label] = _chaos_scheduler(arch_cfg, p, f"chaos (c) {label}", 0.0,
                                        SERVE_SHORT_BUCKETS)
        del p
        _free()
    sec["c"] = time.perf_counter() - t
    t = time.perf_counter()
    launcher = _chaos_launcher()
    sec["d"] = time.perf_counter() - t
    t = time.perf_counter()
    small = dataclasses.replace(cfg, n_layers=CHAOS_F32_LAYERS)
    p = tf.init_params(small, torch.Generator(device=device).manual_seed(34),
                       device=device)
    unrec = _chaos_unrecoverable(small, p, prompts)
    del p
    _free()
    sec["e"] = time.perf_counter() - t
    emit("chaos", card=RECORD["device"]["nvidia_smi"], arch=ARCH,
         n_layers=cfg.n_layers, tp=TP, batch=BATCH, prompt=PROMPT,
         decode=DECODE, guard_costs=costs, guards=guards,
         faults=fault_runs, scheduler=sched, launcher=launcher,
         unrecoverable=unrec, stall=list(CHAOS_STALL),
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         seconds_by_part=sec, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 16: the data-parallel trainer (explicit: every gradient leaf
# reduced by compiled plans on the executor kernel)
# ---------------------------------------------------------------------------
def _train_axes(name, device):
    """The DP axes of a phase-16 mode: none (auto), a 2 x 4 node-major
    grid (pod, data), or one flat axis of 4."""
    from repro_torch.mesh import RankAxis
    if name == "auto":
        return ()
    if name == "2x4":
        return (RankAxis("pod", TRAIN_NODES, device),
                RankAxis("data", TRAIN_LOCAL, device))
    return (RankAxis("data", TRAIN_FLAT, device),)


def _train_opt(steps, lr=None):
    from repro_torch.train import optimizer as opt
    return opt.AdamWConfig(total_steps=steps, warmup_steps=1,
                           **({} if lr is None else dict(lr=lr)))


def _train_batch(cfg):
    from repro_torch.train import data
    return data.SyntheticLM(data.DataConfig(
        vocab=cfg.vocab, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)).batch_at(0)


def _train_run(cfg, name, device, steps=TRAIN_STEPS, opt_cfg=None,
               keep=False, **tc):
    """One ``train.loop.run`` of mode ``name`` on the fixed batch, with the
    executor's and the library's launch counts set to 0 just before it
    and read just after (the executor's also after every step, from the
    loop's log line). Returns the record and, with ``keep``, the run's
    result (its params and optimizer state among it)."""
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.kernels import comm_utils
    from repro_torch.train import loop
    marks = []

    def log(line):
        if line.startswith("step "):
            marks.append(CudaExecutor.launches)

    _free()
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    CudaExecutor.launches = 0                   # just before the run
    comm_utils.LAUNCHES.clear()
    t = time.perf_counter()
    res = loop.run(cfg, _train_axes(name, device), loop.TrainConfig(
        steps=steps, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        mode="auto" if name == "auto" else "explicit", fixed_batch=True,
        log_every=1, **tc), opt_cfg or _train_opt(steps), device=device,
        log_fn=log)
    torch.cuda.synchronize()
    rec = dict(losses=res["losses"], grad_norms=res["grad_norms"],
               step_ms=[s * 1e3 for s in res["step_s"]],
               launches=CudaExecutor.launches,    # read just after
               launches_per_step=np.diff([0] + marks).tolist(),
               library_launches=dict(comm_utils.LAUNCHES),
               plan_stats=res["plan_stats"],
               peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
               seconds=time.perf_counter() - t)
    if not keep:
        del res
        _free()
        return rec, None
    return rec, res


def _train_gaps(run, auto):
    """Largest |loss difference| and largest relative grad-norm
    difference of a run against auto's, step by step."""
    n = len(run["losses"])
    return dict(
        loss=max(abs(a - b) for a, b in zip(run["losses"],
                                            auto["losses"][:n])),
        grad_norm=max(abs(a - b) / abs(b) for a, b in zip(
            run["grad_norms"], auto["grad_norms"][:n])))


def _drop_rank(x, *, rank=None):
    """Fault control in plain torch, in ``reduce_leaf``'s place: rank 0's
    gradient dropped from the sum (the other ranks' sum over ndp)."""
    out = (x[1:].float().sum(0) / x.shape[0]).to(x.dtype)
    return out.expand_as(x) if rank is None else out


def _no_mean(x, *, rank=None):
    """Fault control in plain torch, in ``reduce_leaf``'s place: the
    ranks' sum, not divided by ndp."""
    out = x.float().sum(0).to(x.dtype)
    return out.expand_as(x) if rank is None else out


def _train_control(cfg, device, reduce):
    """The 2 x 4 explicit step for TRAIN_CONTROL_STEPS on the fixed batch
    with its ``reduce_leaf`` replaced by ``reduce``: losses and grad
    norms."""
    from repro_torch.distributed import step as st
    oc = _train_opt(TRAIN_STEPS)
    step = st.make_train_step(cfg, _train_axes("2x4", device), oc,
                              mode="explicit", global_batch=TRAIN_BATCH,
                              seq_len=TRAIN_SEQ, device=device)
    step.reduce_leaf = reduce
    params, state = st.init_sharded(cfg, device=device, optimizer_cfg=oc)
    batch = _train_batch(cfg)
    losses, norms = [], []
    for _ in range(TRAIN_CONTROL_STEPS):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    del params, state, step
    _free()
    return dict(losses=losses, grad_norms=norms)


def _train_kernel_vs_plain(cfg, name, device):
    """Step 0's stacked gradient of mode ``name``, reduced leaf by leaf
    through the step's plans on the executor kernel and through the same
    axes' plans on ``TorchExecutor`` on the card: bit-equal; every rank's
    copy against rank 0's (bit-equal, or within the fold bound of the
    ranks' bf16 adds where a 1PA plan at more than two ranks folds each
    rank's sum from its own buffer)."""
    from repro_torch.distributed import step as st
    _free()
    axes = _train_axes(name, device)
    step = st.make_train_step(cfg, axes, _train_opt(TRAIN_STEPS),
                              mode="explicit", global_batch=TRAIN_BATCH,
                              seq_len=TRAIN_SEQ, device=device)
    plain = st.make_dp_communicators(axes, backend="torch")
    params, _ = st.init_sharded(cfg, device=device)
    names = _leaf_names(params)
    _, stacked = step.rank_grads(params, _train_batch(cfg))
    del params
    eps = torch.finfo(torch.bfloat16).eps
    leaves = []
    for i, name_i in enumerate(names):
        x = stacked[i]
        stacked[i] = None
        y = step.reduce_leaf(x)
        z = step.reduce_leaf(x, comms=plain)
        ndp = x.shape[0]
        rec = dict(leaf=name_i, shape=list(x.shape[1:]),
                   bit_equal_plain=torch.equal(y, z),
                   ranks_bit_equal=all(torch.equal(y[r], y[0])
                                       for r in range(1, ndp)))
        # the differences, read only where there are some (f32 copies of
        # a stacked leaf are several GB)
        rec["max_abs_err_plain"] = 0.0 if rec["bit_equal_plain"] else \
            (y.float() - z.float()).abs().max().item()
        del z
        if rec["ranks_bit_equal"]:
            rec.update(rank_max_abs_gap=0.0, ranks_within_fold_bound=True)
        else:
            bound = (ndp - 1) * eps * x.float().abs().sum(0) / ndp
            gaps = [(y[r].float() - y[0].float()).abs()
                    for r in range(1, ndp)]
            rec.update(rank_max_abs_gap=max(g.max().item() for g in gaps),
                       ranks_within_fold_bound=all(
                           bool(torch.all(g <= bound)) for g in gaps))
            del bound, gaps
        leaves.append(rec)
        del x, y
        _free()
    algos = {k: sorted({p.algo for p in c.plans().values()})
             for k, c in step.comms.items()}
    del step, plain, stacked
    _free()
    check(all(r["bit_equal_plain"] for r in leaves),
          f"train {name}: step 0's reduced gradient != TorchExecutor's "
          f"plans: {[r['leaf'] for r in leaves if not r['bit_equal_plain']]}")
    if name == "2x4":
        check(all(r["ranks_bit_equal"] for r in leaves),
              f"train {name}: a rank's reduced copy != rank 0's")
    check(all(r["ranks_within_fold_bound"] for r in leaves),
          f"train {name}: a rank's reduced copy past the fold bound")
    return dict(leaves=leaves, algos=algos,
                ranks_bit_equal=sum(r["ranks_bit_equal"] for r in leaves),
                max_abs_err=max(r["max_abs_err_plain"] for r in leaves))


def _leaf_names(params):
    """Each leaf's path in the reference's leaf order."""
    def walk(t, pre):
        if isinstance(t, dict):
            return [n for k in sorted(t) for n in walk(t[k], f"{pre}{k}/")]
        if isinstance(t, (list, tuple)):
            return [n for i, v in enumerate(t) for n in walk(v, f"{pre}{i}/")]
        return [pre[:-1]]
    return walk(params, "")


def _host_syncs(fn) -> list:
    """The calls in one ``fn()`` that made the host wait for the stream
    (``torch.cuda.set_sync_debug_mode``'s warnings: a copy from host
    memory, ``.item()``, ``nonzero``), each as its innermost frames
    (``file:line function``), the port's line that led to it among
    them."""
    import traceback
    import warnings
    sites = []

    def record(message, *args, **kw):
        if "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if not f.filename.endswith("warnings.py")]
            port = [f for f in frames if "repro_torch" in f.filename]
            sites.append([f"{pathlib.Path(f.filename).name}:{f.lineno} "
                          f"{f.name}" for f in (port[-1:] + frames[-3:])])
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def _busy_ms(fn) -> float:
    """Device-busy ms of one ``fn()``: its kernels' summed time under
    ``torch.profiler`` (device activity only), whatever the host's
    pace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(r[0] for r in _device_rows(prof, 1)) / 1e3


def _train_time(cfg, device, modes=TRAIN_MODES, iters=TRAIN_TIME_ITERS):
    """ms a step by part, by CUDA events behind a device sleep
    (``device_ms``), each beside whether the sleep covered the host's
    enqueue (where it did not, the part's figure is the host's time, not
    the device's) and the host syncs one call of it made: auto's
    forward+backward over the global batch and its update; for each
    explicit mode one rank's forward+backward, the gradient reduction and
    the update. A rank's pass enqueues more kernels than the launch
    queue holds, so the sleep cannot cover it: its figure is wall time,
    and ``fwd_bwd_busy_ms`` (its kernels' summed time, profiled) is its
    device time. The reduction is timed two ways: the step's (``reduce_ms``:
    every leaf's ``reduce_leaf`` as the step calls it, the payload's
    reshape, the plan's replay, its scratch released and rank 0's copy
    averaged), and the plan replays alone (``replay_ms``, each leaf's plan
    replayed on its payload, the kernel; ``replay_plain_ms``: the same
    axes' plans on ``TorchExecutor``; ``replay_library_ms``: ``x.sum(0)``
    expanded to every rank, one PyTorch call a leaf, which the port never
    calls), beside their bound (every rank's payload read once and written
    once over HBM). The state is the seeded init's; times do not depend on
    it. ``modes``: the phase-16 modes timed; ``iters``: the calls of
    each part a timing averages."""
    from repro_torch import tree
    from repro_torch.distributed import step as st
    from repro_torch.train import optimizer as opt
    out = {}
    batch = _train_batch(cfg)
    oc = _train_opt(TRAIN_STEPS)
    for name in modes:
        _free()
        t = time.perf_counter()
        axes = _train_axes(name, device)
        step = st.make_train_step(
            cfg, axes, oc, mode="auto" if name == "auto" else "explicit",
            global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, device=device)
        params, state = st.init_sharded(cfg, device=device,
                                        optimizer_cfg=oc)
        full = step.batch(batch)
        rows = TRAIN_BATCH // step.ndp
        sub = {k: v[:rows] for k, v in full.items()}
        rec = dict(tokens_per_rank=rows * TRAIN_SEQ, sleep_covered={},
                   host_syncs={})

        def fwd_bwd():
            step.value_and_grad(params, sub)
        rec["fwd_bwd_ms"], rec["sleep_covered"]["fwd_bwd"] = device_ms(
            fwd_bwd, iters)
        rec["host_syncs"]["fwd_bwd"] = _host_syncs(fwd_bwd)
        rec["fwd_bwd_busy_ms"] = _busy_ms(fwd_bwd)
        if name != "auto":
            _, stacked = step.rank_grads(params, batch)
            plain = st.make_dp_communicators(axes, backend="torch")
            nbytes = sum(2 * x.numel() * x.element_size() for x in stacked)

            def reduce():
                for x in stacked:
                    step.reduce_leaf(x, rank=0)

            rec["reduce_ms"], rec["sleep_covered"]["reduce"] = device_ms(
                reduce, iters)
            rec["reduce_wall_ms"] = wall_ms(reduce, iters)
            rec["host_syncs"]["reduce"] = _host_syncs(reduce)
            replay = dict(kernel=0.0, plain=0.0, library=0.0)
            cov = dict(kernel=True, plain=True, library=True)
            for leaf in stacked:
                x = step.payload(leaf)
                for part, comms, n in (("kernel", None, iters),
                                       ("plain", plain, 1),
                                       ("library", None, iters)):
                    if part == "library":
                        plan = None
                        fn = lambda: x.sum(  # noqa: E731
                            0, keepdim=True).expand_as(x).contiguous()
                    else:
                        plan = step.plan_for(x, comms)
                        fn = lambda: plan(x)  # noqa: E731
                    ms, c = device_ms(fn, n)
                    replay[part] += ms
                    cov[part] = cov[part] and c
                    # one plan's scratch held at a time, as in the step
                    if plan is not None:
                        plan.release()
                    del fn, plan
                    _free()
                del x
            rec["replay_ms"] = replay["kernel"]
            rec["replay_plain_ms"] = replay["plain"]
            rec["replay_library_ms"] = replay["library"]
            rec["sleep_covered"].update(
                {f"replay_{k}": v for k, v in cov.items()})
            rec["replay_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            rec["replay_bytes"] = nbytes
            rec["leaves"] = len(stacked)
            grads = tree.unflatten(params, [x[0] for x in stacked])
            del plain
        else:
            _, g = step.value_and_grad(params, full)
            grads = tree.unflatten(params, g)
            del g

        def update():
            opt.adamw_update(oc, params, grads, state, donate=True)
        rec["update_ms"], rec["sleep_covered"]["update"] = device_ms(
            update, iters)
        rec["host_syncs"]["update"] = _host_syncs(update)
        # each part's figure by its clock: "device" where the sleep
        # covered the enqueue, else "wall" (the host held the device back)
        rec["clock"] = {k: "device" if v else "wall"
                        for k, v in rec["sleep_covered"].items()}
        rec["seconds"] = time.perf_counter() - t
        out[name] = rec
        del params, state, grads, step, full, sub
        if name != "auto":
            del stacked
        _free()
    return out


def _train_profile(cfg, device):
    """One 2 x 4 explicit step under ``torch.profiler`` (device activity
    only: the host side of some 35 k ops a step took a minute to
    summarise) after a warm step: device busy share (summed kernel time
    over the step's wall) and the executor kernels it ran."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed import step as st
    _free()
    oc = _train_opt(TRAIN_STEPS)
    step = st.make_train_step(cfg, _train_axes("2x4", device), oc,
                              mode="explicit", global_batch=TRAIN_BATCH,
                              seq_len=TRAIN_SEQ, device=device)
    params, state = st.init_sharded(cfg, device=device, optimizer_cfg=oc)
    batch = _train_batch(cfg)
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = _device_rows(prof, 1)
    busy_ms = sum(r[0] for r in rows) / 1e3
    del params, state, step
    _free()
    return dict(step_wall_ms=wall, step_wall_ms_unprofiled=bare_ms,
                device_busy_ms=busy_ms,
                device_busy_share=busy_ms / wall if rows else None,
                device_busy_share_unprofiled=busy_ms / bare_ms if rows
                else None,
                executor_kernels=_executor_kernels(prof),
                top_kernels=[dict(name=k[:90], ms=us / 1e3, launches=c)
                             for us, c, k in rows[:8]])


def _train_f32(cfg, device):
    """Full width, TRAIN_F32_LAYERS layers in f32, TRAIN_F32_STEPS steps:
    each explicit mode's losses within the reference test's bar of
    auto's."""
    small = dataclasses.replace(cfg, n_layers=TRAIN_F32_LAYERS,
                                dtype="float32")
    runs = {name: _train_run(small, name, device, steps=TRAIN_F32_STEPS)[0]
            for name in TRAIN_MODES}
    out = {}
    for name in TRAIN_MODES[1:]:
        got, want = runs[name]["losses"], runs["auto"]["losses"]
        ok = np.allclose(got, want, rtol=TRAIN_F32_RTOL, atol=TRAIN_F32_ATOL)
        out[name] = dict(losses=got, gaps=_train_gaps(runs[name],
                                                      runs["auto"]),
                         within_bar=bool(ok))
        check(ok, f"train f32 {name}: losses {got} vs auto {want}")
    out["auto"] = dict(losses=runs["auto"]["losses"])
    return out


def _train_restart(cfg, device):
    """Checkpoint restart on the 2 x 4 explicit path at full width and
    TRAIN_RESTART_LAYERS layers, under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: the
    uninterrupted 8 steps; 4 steps written to a checkpoint; a run
    resumed from it to 8. Params and optimizer state bit-equal."""
    import shutil
    import tempfile
    import warnings

    from repro_torch import tree
    from repro_torch.train import checkpoint as ckpt
    state_gb = 0.0
    was = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    (ROOT / "build").mkdir(exist_ok=True)
    d = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "build",
                                      prefix="train_ckpt_"))
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            full, res = _train_run(cfg, "2x4", device, keep=True)
            want = [x.cpu() for x in tree.leaves(
                [res["params"], res["opt_state"]])]
            state_gb = sum(x.numel() * x.element_size() for x in want) / 1e9
            del res
            _free()
            free_gb = shutil.disk_usage(d).free / 1e9
            check(free_gb > 2.2 * state_gb,
                  f"train restart: {free_gb:.1f} GB free on disk for two "
                  f"checkpoints of {state_gb:.1f} GB")
            first, _ = _train_run(cfg, "2x4", device,
                                  steps=TRAIN_RESTART_AT,
                                  opt_cfg=_train_opt(TRAIN_STEPS),
                                  ckpt_dir=str(d), keep_n=1)
            ckpt.wait_pending()
            resumed, res = _train_run(cfg, "2x4", device,
                                      opt_cfg=_train_opt(TRAIN_STEPS),
                                      keep=True, ckpt_dir=str(d), keep_n=1)
            got = tree.leaves([res["params"], res["opt_state"]])
            equal = [torch.equal(a.cpu(), b) for a, b in zip(got, want)]
            gap = max((a.cpu().float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
            del res, got
            _free()
    finally:
        torch.use_deterministic_algorithms(was, warn_only=was_warn)
        shutil.rmtree(d, ignore_errors=True)
    out = dict(losses_full=full["losses"],
               losses_resumed=first["losses"] + resumed["losses"],
               leaves_bit_equal=sum(equal), leaves=len(equal),
               max_abs_gap=gap, state_gb=state_gb,
               nondeterministic_ops=sorted({str(w.message)[:100]
                                            for w in caught}))
    check(all(equal), f"train restart: {len(equal) - sum(equal)} leaves "
          f"differ from the uninterrupted run (max |gap| {gap})")
    check(len(resumed["losses"]) == TRAIN_STEPS - TRAIN_RESTART_AT,
          f"train restart: resumed {len(resumed['losses'])} steps")
    return out


def _train_launcher():
    """``python -m repro_torch.launch.train --arch qwen3-1.7b --reduced
    --mode explicit`` in-process."""
    import io
    from repro_torch.launch import train as launch
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = launch.main(["--arch", ARCH, "--reduced", "--mode", "explicit"])
    lines = buf.getvalue().strip().splitlines()
    out = dict(rc=rc, first=lines[0], last=lines[-1], lines=len(lines),
               seconds=time.perf_counter() - t0)
    check(rc == 0 and lines[0].startswith(f"arch={ARCH}-reduced")
          and "mode=explicit" in lines[0]
          and lines[-1].startswith("final loss "),
          f"train launcher: {lines[:2]} ... {lines[-1:]}")
    _free()
    return out


def phase_train(device):
    """Phase 16: the data-parallel trainer (see the module docstring)."""
    from repro_torch import configs
    t0 = time.perf_counter()
    _free()
    cfg = configs.get_config(ARCH)
    sec = {}
    t = time.perf_counter()
    runs = {name: _train_run(cfg, name, device)[0] for name in TRAIN_MODES}
    sec["runs"] = time.perf_counter() - t
    emit("train_runs", card=RECORD["device"]["nvidia_smi"], runs=runs)
    auto = runs["auto"]
    n_leaves = len(_grad_leaves())          # phase 11's, the same model
    drop = auto["losses"][0] - auto["losses"][-1]
    for name, r in runs.items():
        check(bool(np.isfinite(r["losses"]).all()),
              f"train {name}: losses {r['losses']}")
        check(not r["library_launches"],
              f"train {name}: library kernels launched on the trainer's "
              f"path {r['library_launches']}")
    check(drop >= TRAIN_LOSS_DROP, f"train auto: loss fell {drop} over "
          f"{TRAIN_STEPS} steps, not {TRAIN_LOSS_DROP}")
    per_step = {"auto": 0, "2x4": 3 * n_leaves, "flat4": n_leaves}
    for name, r in runs.items():
        check(r["launches_per_step"] == [per_step[name]] * TRAIN_STEPS
              and r["launches"] == per_step[name] * TRAIN_STEPS,
              f"train {name}: executor launches a step "
              f"{r['launches_per_step']}, not {per_step[name]}")
    gaps = {name: _train_gaps(runs[name], auto) for name in TRAIN_MODES[1:]}
    for name, g in gaps.items():
        check(g["loss"] <= TRAIN_LOSS_BAR
              and g["grad_norm"] <= TRAIN_GNORM_BAR,
              f"train {name} vs auto: {g} past the bars "
              f"({TRAIN_LOSS_BAR}, {TRAIN_GNORM_BAR})")
    t = time.perf_counter()
    lr0, _ = _train_run(cfg, "auto", device,
                        opt_cfg=_train_opt(TRAIN_STEPS, lr=0.0))
    lr0_drop = lr0["losses"][0] - lr0["losses"][-1]
    check(lr0_drop < TRAIN_LOSS_DROP,
          f"train control lr=0: the loss fell {lr0_drop}, past the gate")
    controls = {}
    for cname, fn in (("drop_rank", _drop_rank), ("no_mean", _no_mean)):
        c = _train_control(cfg, device, fn)
        c["gaps"] = _train_gaps(c, auto)
        controls[cname] = c
        check(c["gaps"]["loss"] > TRAIN_LOSS_BAR
              or c["gaps"]["grad_norm"] > TRAIN_GNORM_BAR,
              f"train control {cname}: {c['gaps']} inside the bars")
    sec["controls"] = time.perf_counter() - t
    t = time.perf_counter()
    vs_plain = {name: _train_kernel_vs_plain(cfg, name, device)
                for name in TRAIN_MODES[1:]}
    sec["kernel_vs_plain"] = time.perf_counter() - t
    t = time.perf_counter()
    timing = _train_time(cfg, device)
    prof = _train_profile(cfg, device)
    sec["timing"] = time.perf_counter() - t
    t = time.perf_counter()
    f32 = _train_f32(cfg, device)
    sec["f32"] = time.perf_counter() - t
    t = time.perf_counter()
    launcher = _train_launcher()
    sec["launcher"] = time.perf_counter() - t
    t = time.perf_counter()
    restart = _train_restart(dataclasses.replace(
        cfg, n_layers=TRAIN_RESTART_LAYERS), device)
    sec["restart"] = time.perf_counter() - t
    hier = RECORD.get("hierarchical")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    summary = {}
    for name, r in runs.items():
        ms = float(np.median(r["step_ms"][1:]))
        summary[name] = dict(step_ms_median=ms,
                             tokens_per_s=tokens / ms * 1e3,
                             peak_gb=r["peak_gb"],
                             first_loss=r["losses"][0],
                             last_loss=r["losses"][-1])
    emit("train", card=RECORD["device"]["nvidia_smi"], arch=ARCH,
         n_layers=cfg.n_layers, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         steps=TRAIN_STEPS, grid=f"{TRAIN_NODES}x{TRAIN_LOCAL}",
         flat=TRAIN_FLAT, leaves=n_leaves, summary=summary, gaps=gaps, bars=dict(loss=TRAIN_LOSS_BAR,
                              grad_norm=TRAIN_GNORM_BAR,
                              loss_drop=TRAIN_LOSS_DROP),
         loss_drop=drop, control_lr0=dict(losses=lr0["losses"],
                                          drop=lr0_drop),
         controls=controls, kernel_vs_plain=vs_plain, timing=timing,
         profile=prof, f32=f32, restart=restart, launcher=launcher,
         phase11_plan_replay_ms=(hier["gradient_total"]["plan_ms"]
                                 if hier else None),
         seconds_by_part=sec, seconds=time.perf_counter() - t0)
    # the executor on the trainer's path, for the kernels line: each
    # explicit mode's plan replays a step over its launches a step (the
    # step's whole reduction, reshape, scratch and averaging included, is
    # ``reduce_step_ms`` beside them)
    by = {}
    for name in TRAIN_MODES[1:]:
        tm, n = timing[name], per_step[name]
        by[name] = dict(launches=runs[name]["launches"],
                        launches_per_step=n,
                        ms=tm["replay_ms"] / n,
                        plain_ms=tm["replay_plain_ms"] / n,
                        bound_ms=tm["replay_bound_ms"] / n,
                        library_ms=tm["replay_library_ms"] / n,
                        replay_ms=tm["replay_ms"],
                        reduce_step_ms=tm["reduce_ms"])
    return dict(by_mode=by, max_abs_err=max(v["max_abs_err"]
                                            for v in vs_plain.values()))


# ---------------------------------------------------------------------------
# phase 17: the rwkv6 family (rwkv6-7b), auto mode
# ---------------------------------------------------------------------------
def _rwkv_cfg(n_layers=None, dtype="bfloat16"):
    from repro_torch import configs
    cfg = configs.get_config(RWKV_ARCH)
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                               dtype=dtype)


def _rwkv_decode_bytes(params, cache, batch) -> int:
    """The bytes one decode step must move: every weight read once (of
    the embedding table only the batch's rows), the recurrent state read
    once and written once."""
    from repro_torch import tree
    emb = params["embed"]
    weights = sum(x.numel() * x.element_size() for x in tree.leaves(params))
    weights += (batch - emb.shape[0]) * emb.shape[1] * emb.element_size()
    state = sum(x.numel() * x.element_size() for x in tree.leaves(cache))
    return weights + 2 * state


def _rwkv_decode_loop(cfg, device):
    """The WKV recurrence's share of a decode step: ``rwkv6.wkv_scan`` at
    the step's shapes (one token, BATCH rows, every head), once a layer,
    on seeded inputs (its kernels do not depend on the values): device
    ms by CUDA events and busy ms profiled, a step's worth."""
    from repro_torch.models import rwkv6
    g = torch.Generator(device=device).manual_seed(32)
    nh, hd = cfg.d_model // rwkv6.HEAD, rwkv6.HEAD

    def rand(*shape, uniform=False):
        fn = torch.rand if uniform else torch.randn
        return fn(shape, device=device, generator=g)

    args = ([rand(BATCH, 1, nh, hd) for _ in range(3)]
            + [rand(BATCH, 1, nh, hd, uniform=True), rand(nh, hd),
               rand(BATCH, nh, hd, hd)])

    def step():
        with torch.inference_mode():
            for _ in range(cfg.n_layers):
                rwkv6.wkv_scan(*args)

    ms, covered = device_ms(step, MAIN_DECODE_STEPS)
    return dict(wkv_loop_ms=ms, wkv_loop_sleep_covered=covered,
                wkv_loop_busy_ms=_busy_ms(step))


def _rwkv_engine(cfg, params, prompts, device):
    """(a): rwkv6-7b at full width and depth, auto, by graph replay then
    eagerly on one engine (``_run_engine``: first-step logits bit-equal,
    tokens equal); no executor launch; ms/token by the stream's clock
    (CUDA events around the decode loop, the host's share in it) and the
    device's (the profiler's kernel time a replay), kernels a step, the
    step's byte bound, and the WKV loop's share of the step
    (:func:`_rwkv_decode_loop`)."""
    from repro_torch.models import transformer as tf
    r = _run_engine(cfg, params, prompts, "auto", DECODE, False,
                    profile_steps=MAIN_DECODE_STEPS, tp=1)
    check(r["graph_launches"] == 0 and r["profiled_executor_kernels"] == 0,
          f"{RWKV_ARCH}: executor launches in auto mode")
    check(bool(torch.isfinite(r["first"]).all()
               and torch.isfinite(r["last"]).all())
          and r["tokens"].shape == (BATCH, DECODE),
          f"{RWKV_ARCH}: non-finite logits or tokens of the wrong shape")
    cache = tf.init_cache(cfg, BATCH, MAX_KV, device=device)
    nbytes = _rwkv_decode_bytes(params, cache, BATCH)
    del cache
    rec = _run_record(r)
    rec.update(_rwkv_decode_loop(cfg, device))
    rec["wkv_loop_busy_share"] = rec["wkv_loop_busy_ms"] / r["device_busy_ms"]
    rec.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_bytes=nbytes,
               kernels_per_step=r["profiled_kernel_records"]
               / r["profiled_replays"],
               graph_over_bound=r["ms_per_token"]
               / (nbytes / HBM_BYTES_PER_S * 1e3))
    emit("rwkv6_engine", **rec)
    return rec


def _rwkv_stepwise(eng, tokens):
    """Every position's logits of ``tokens`` (b, s) fed token by token
    through the engine's captured step, from position 0."""
    out = []
    for t in range(tokens.shape[1]):
        out.append(eng._run_step(tokens[:, t]).float())
        eng.pos += 1
    return torch.stack(out, dim=1)


def _rwkv_f32(device, prompts):
    """(b), (c) at full width, RWKV_SHORT_LAYERS layers. (b) In f32, the
    decode graph's logits at every prompt position against ``forward``'s
    within RWKV_F32_REL_TOL (relative L2), and (d)'s trace through the
    scheduler, streams equal to the sequential run's (the compaction
    control parting from them) and the cross-bucket drift; the same
    weights in bf16 through the graph within BF16_REL_TOL of the f32
    logits, and their cross-bucket drift. (c) bf16,
    explicit asked for at TP=4: the engine warns "falling back to auto",
    serves auto with one fallback counted (the reference's count), and
    its first-step logits and tokens equal an auto engine's; no executor
    launch."""
    import warnings

    from repro_torch import tree
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.models import transformer as tf
    from repro_torch.serve import loadgen
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.scheduler import Scheduler
    cfg32 = _rwkv_cfg(RWKV_SHORT_LAYERS, "float32")
    p32 = tf.init_params(cfg32, torch.Generator(device=device)
                         .manual_seed(31), device=device)
    toks = torch.as_tensor(prompts, device=device)
    with torch.inference_mode():
        want = tf.logits_fn(p32, cfg32, tf.forward(p32, cfg32, toks))
    scfg = ServeConfig(batch=BATCH, max_kv=MAX_KV)
    eng = Engine(cfg32, p32, scfg, tp=1)
    eng.capture()
    got32 = _rwkv_stepwise(eng, toks)
    del eng
    rel32 = _rel(got32, want)
    err32 = _max_abs_err(got32, want)
    check(rel32 <= RWKV_F32_REL_TOL, f"{RWKV_ARCH} f32: decode vs forward "
          f"rel L2 {rel32} (max abs {err32})")
    # the scheduler in f32: streams equal to the sequential run's, the
    # compaction control parting from them, the cross-bucket drift
    label = f"{RWKV_ARCH} f32 scheduler"
    step_s = RWKV_TRACE["step_s"]
    sched = _serve_scheduler()(Engine(cfg32, p32, scfg, tp=1),
                               max_slots=BATCH, prefill_chunk=SERVE_CHUNK,
                               gaps=True)
    trace = _rwkv_trace(cfg32.vocab)
    longest = max(trace, key=lambda r: len(r.prompt))
    loadgen.run_load(sched, trace, step_s=step_s)
    m = sched.metrics()
    check(m["completed"] == len(trace) and m["dropped"] == 0,
          f"{label}: {m}")
    streams = dict(sched.streams)
    base = _sequential(sched, trace, step_s)
    bar = _stream_bar(streams, base, sched.gaps, SERVE_RID, 0, label)
    check(bar["equal"] == len(trace), f"{label}: streams differ from the "
          f"sequential run's")
    sched_f32 = dict(requests=len(trace), tokens=m["tokens"],
                     bucket_steps=m["bucket_steps"], vs_sequential=bar,
                     compaction_control=_compaction_control(
                         sched, trace, base, step_s, margin=0),
                     drift=_rwkv_bucket_drift(sched, longest))
    del sched
    _free()
    cfg16 = _rwkv_cfg(RWKV_SHORT_LAYERS)
    p16 = tree.unflatten(p32, [x.to(torch.bfloat16)
                               for x in tree.leaves(p32)])
    del p32, want
    _free()
    eng = Engine(cfg16, p16, scfg, tp=1)
    eng.capture()
    got16 = _rwkv_stepwise(eng, toks)
    del eng
    drift16 = _rwkv_bucket_drift(Scheduler(Engine(cfg16, p16, scfg, tp=1),
                                           max_slots=BATCH), longest)
    _free()
    rel16 = _rel(got16, got32)
    check(rel16 <= BF16_REL_TOL, f"{RWKV_ARCH} bf16 vs f32 at "
          f"{RWKV_SHORT_LAYERS} layers: rel L2 {rel16}")
    # (c) explicit asked for: the reference's fallback to auto
    before = CudaExecutor.launches
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ex = Engine(cfg16, p16, scfg, tp=TP, mode="explicit")
    said = [str(w.message) for w in caught]
    check(any("falling back to auto" in m for m in said),
          f"{RWKV_ARCH} explicit: no fallback warning in {said}")
    # its decode plans compile, as the reference's do; nothing replays them
    check(ex.mode == "auto" and ex.requested_mode == "explicit"
          and ex.health["fallbacks"] == 1
          and set(ex.decode_plans) == {"layer_allreduce",
                                       "logits_allgather"},
          f"{RWKV_ARCH} explicit: mode {ex.mode}, health {ex.health}, "
          f"plans {sorted(ex.decode_plans)}")
    ex.capture()
    got_ex = _serve(ex, prompts, DECODE)
    del ex
    auto = Engine(cfg16, p16, scfg, tp=1)
    auto.capture()
    got_auto = _serve(auto, prompts, DECODE)
    _healthy(auto, f"{RWKV_ARCH} auto, {RWKV_SHORT_LAYERS} layers")
    del auto, p16
    _free()
    check(torch.equal(got_ex["first"], got_auto["first"])
          and np.array_equal(got_ex["tokens"], got_auto["tokens"]),
          f"{RWKV_ARCH}: the fallen-back engine differs from auto")
    check(CudaExecutor.launches == before,
          f"{RWKV_ARCH}: executor launches on the auto path")
    out = dict(
        layers=RWKV_SHORT_LAYERS, f32_decode_vs_forward=dict(
            rel_l2=rel32, max_abs_err=err32, tol=RWKV_F32_REL_TOL,
            positions=int(toks.shape[1])),
        f32_scheduler=sched_f32,
        bf16_vs_f32=dict(rel_l2=rel16, tol=BF16_REL_TOL),
        bf16_drift=drift16,
        explicit_requested=dict(mode="auto", fallbacks=1, warnings=said,
                                tokens_equal_auto=True,
                                ms_per_token=got_ex["ms_per_token"]))
    emit("rwkv6_short", **out)
    return out


def _rwkv_trace(vocab):
    """RWKV_TRACE's arrivals and budgets with prompt lengths drawn
    uniformly from RWKV_PROMPTS (a seeded numpy stream); every third
    request at SERVE_HOT_T."""
    trace = _serve_trace(RWKV_TRACE, vocab)
    rng = np.random.default_rng(RWKV_TRACE["seed"] + 1)
    lo, hi = RWKV_PROMPTS
    return [dataclasses.replace(r, prompt=rng.integers(
        0, vocab, int(rng.integers(lo, hi + 1))).astype(np.int32))
        for r in trace]


def _rwkv_bucket_drift(sched, req):
    """The cross-bucket difference the recurrent state gathers: ``req``'s
    prompt, then its greedy continuation at bucket 1 (RWKV_TRACE's
    ``max_new`` tokens), fed alone from a zero state through the
    scheduler's graph at bucket 1 and again, the same tokens, at the top
    bucket (its other rows inactive): the largest |logit difference| over
    the continuation's steps. Only the row count differs, so cuBLAS's
    kernels for it, not the code path; the cache is put back after."""
    top = sched.max_slots
    saved = _snapshot(sched.cache)
    toks = [int(t) for t in req.prompt]
    n_prompt = len(toks)
    logits = {}
    for b in (1, top):
        for leaves in sched.cache.values():
            for leaf in leaves:
                leaf.zero_()
        rows = []
        for t in range(n_prompt + RWKV_TRACE["max_new"]):
            if t == len(toks):
                toks.append(int(rows[-1].argmax()))
            x = np.zeros((3, b), np.int64)
            x[:, 0] = (toks[t], t, 1)
            rows.append(sched.run_step(b, torch.from_numpy(x),
                                       graph=True)[0].float().clone())
        logits[b] = torch.stack(rows[n_prompt - 1:])
    _restore(sched.cache, saved)
    diff = (logits[1] - logits[top]).abs()
    return dict(rid=req.rid, prompt_len=n_prompt, steps=int(diff.shape[0]),
                max_abs=diff.max().item(),
                max_abs_by_step=diff.amax(-1).tolist())


def _rwkv_scheduler(cfg, params):
    """(d): the Scheduler over an auto rwkv6-7b engine at full depth, 8
    slots, token-by-token prefill through the slot-bucket graphs (fused
    prefill asked for and off, a prefix cache given and none held):
    every request done, none dropped; each bucket's replay bit-equal to
    the eager step and a row bit-equal whatever its co-residents
    (``_bucket_checks``); wall tokens/s, TTFT. The streams against the
    sequential run are reported beside the cross-bucket drift
    (:func:`_rwkv_bucket_drift`), not gated: in bf16 the drift a
    recurrent state gathers over a prompt passes phase 13's margin (the
    f32 run of ``_rwkv_f32`` holds the streams equal)."""
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.prefix_cache import PrefixCache
    Sched = _serve_scheduler()
    label = f"{RWKV_ARCH} scheduler"
    eng = Engine(cfg, params, ServeConfig(batch=BATCH, max_kv=MAX_KV), tp=1)
    sched = Sched(eng, max_slots=BATCH, prefill_chunk=SERVE_CHUNK,
                  fused_prefill=True, gaps=True,
                  prefix_cache=PrefixCache(capacity_tokens=1 << 16))
    check(sched.prefix_cache is None and not sched.fused_prefill,
          f"{label}: a prefix cache or fused prefill on a recurrent cache")
    check(all(g.launches == 0 for g in sched.graphs.values()),
          f"{label}: executor launches captured")
    trace = _rwkv_trace(cfg.vocab)
    step_s = RWKV_TRACE["step_s"]
    run = _drive(sched, trace, step_s)
    m = sched.metrics()
    check(m["completed"] == len(trace) and m["dropped"] == 0
          and m["prefix_hits"] == 0, f"{label}: {m}")
    _healthy(sched, label)
    streams = dict(sched.streams)
    base = _sequential(sched, trace, step_s)
    bar = _stream_bar(streams, base, sched.gaps, SERVE_RID,
                      SERVE_TIE_MARGIN, label, hold=False)
    drift = _rwkv_bucket_drift(sched, max(trace, key=lambda r: len(r.prompt)))
    buckets = _bucket_checks(sched, 0, label)
    out = dict(requests=len(trace),
               prompt_lens=[int(len(r.prompt)) for r in trace],
               tokens=run["tokens"], wall_ms=run["wall_ms"],
               tokens_per_s=run["tokens_per_s"],
               ttft_wall_s=run["ttft_wall_s"],
               decode_tick_wall_ms=run["decode_tick_wall_ms"],
               bucket_steps=m["bucket_steps"], steps=m["steps"],
               micro_steps=m["micro_steps"], drift=drift,
               vs_sequential=bar, buckets=buckets)
    emit("rwkv6_scheduler", **out)
    del sched, eng
    _free()
    return out


def _rwkv_forward(cfg, params, device):
    """(e): ``forward`` at RWKV_FORWARD (b, s) in bf16, full depth: ms (CUDA
    events, one warm call first) and tokens/s; then, profiled at
    RWKV_SHORT_LAYERS layers (every layer has the same shapes), the
    device time in the WKV loop (``rwkv6.wkv_scan`` on the inputs the
    forward gave it) over the forward's, and the loop's share of the
    forward's wall."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import rwkv6
    from repro_torch.models import transformer as tf
    b, s = RWKV_FORWARD
    toks = torch.randint(0, cfg.vocab, (b, s), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(41))

    def fwd(c, p):
        with torch.inference_mode():
            return tf.forward(p, c, toks)

    hidden = fwd(cfg, params)
    check(bool(torch.isfinite(hidden).all()) and hidden.shape
          == (b, s, cfg.d_model), f"{RWKV_ARCH} forward: {hidden.shape}")
    del hidden
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fwd(cfg, params)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1)
    short = _rwkv_cfg(RWKV_SHORT_LAYERS)
    sp = dict(params, layers=[{k: v[:RWKV_SHORT_LAYERS]
                               for k, v in params["layers"][0].items()}])
    scans, orig = [], rwkv6.wkv_scan

    def spy(*args):
        scans.append([a.clone() for a in args])
        return orig(*args)

    rwkv6.wkv_scan = spy
    try:
        fwd(short, sp)
    finally:
        rwkv6.wkv_scan = orig
    check(len(scans) == RWKV_SHORT_LAYERS, f"{len(scans)} WKV loops")

    def loops():
        with torch.inference_mode():
            for a in scans:
                orig(*a)

    short_ms = wall_ms(lambda: fwd(short, sp), 1)
    loop_ms = wall_ms(loops, 1)
    busy = {}
    for name, fn in (("forward", lambda: fwd(short, sp)), ("loop", loops)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = _device_rows(prof, 1)
        busy[name] = dict(ms=sum(r[0] for r in rows) / 1e3,
                          kernels=sum(r[1] for r in rows))
    del scans
    _free()
    out = dict(batch=b, seq=s, n_layers=cfg.n_layers, ms=ms,
                tokens_per_s=b * s / ms * 1e3,
                profiled_layers=RWKV_SHORT_LAYERS,
                short_forward_ms=short_ms, short_loop_ms=loop_ms,
                loop_wall_share=loop_ms / short_ms,
                device_busy_ms=busy["forward"]["ms"],
                loop_device_ms=busy["loop"]["ms"],
                loop_device_share=busy["loop"]["ms"] / busy["forward"]["ms"],
                kernels=busy["forward"]["kernels"],
                loop_kernels=busy["loop"]["kernels"])
    emit("rwkv6_forward", **out)
    return out


def _rwkv_train(device):
    """(f): the trainer at full width, RWKV_TRAIN_LAYERS layers, the
    fixed 8 x 256 batch, RWKV_TRAIN_STEPS AdamW steps, auto and explicit
    DP 4 (one flat AllReduce plan a leaf): losses finite, auto's falling,
    DP 4 within phase 16's bars of auto's losses and grad norms step by
    step, exactly one executor launch a leaf (24) a step and no library
    kernel, step 0's reduction bit-equal to the same plans on
    ``TorchExecutor`` (within the fold bound across ranks); ms a step by
    part and clock, tokens/s, peak memory."""
    cfg = _rwkv_cfg(RWKV_TRAIN_LAYERS)
    runs = {name: _train_run(cfg, name, device, steps=RWKV_TRAIN_STEPS)[0]
            for name in RWKV_TRAIN_MODES}
    auto, dp = runs["auto"], runs["flat4"]
    for name, r in runs.items():
        check(bool(np.isfinite(r["losses"]).all()),
              f"{RWKV_ARCH} train {name}: losses {r['losses']}")
        check(not r["library_launches"], f"{RWKV_ARCH} train {name}: "
              f"library kernels launched {r['library_launches']}")
    check(auto["losses"][-1] < auto["losses"][0],
          f"{RWKV_ARCH} train auto: the loss did not fall {auto['losses']}")
    check(auto["launches"] == 0 and dp["launches_per_step"]
          == [RWKV_LEAVES] * RWKV_TRAIN_STEPS,
          f"{RWKV_ARCH} train: executor launches a step "
          f"{dp['launches_per_step']} (auto {auto['launches']}), want "
          f"{RWKV_LEAVES}")
    gaps = _train_gaps(dp, auto)
    check(gaps["loss"] <= TRAIN_LOSS_BAR and gaps["grad_norm"]
          <= TRAIN_GNORM_BAR, f"{RWKV_ARCH} train DP 4 vs auto: {gaps}")
    vs_plain = _train_kernel_vs_plain(cfg, "flat4", device)
    check(len(vs_plain["leaves"]) == RWKV_LEAVES,
          f"{RWKV_ARCH}: {len(vs_plain['leaves'])} gradient leaves")
    timing = _train_time(cfg, device, modes=RWKV_TRAIN_MODES, iters=1)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    summary = {name: dict(step_ms_median=float(np.median(r["step_ms"][1:])),
                          tokens_per_s=tokens / float(
                              np.median(r["step_ms"][1:])) * 1e3,
                          peak_gb=r["peak_gb"], losses=r["losses"],
                          grad_norms=r["grad_norms"])
               for name, r in runs.items()}
    tm = timing["flat4"]
    by_mode = {"flat4": dict(
        launches=dp["launches"], launches_per_step=RWKV_LEAVES,
        ms=tm["replay_ms"] / RWKV_LEAVES,
        plain_ms=tm["replay_plain_ms"] / RWKV_LEAVES,
        bound_ms=tm["replay_bound_ms"] / RWKV_LEAVES,
        library_ms=tm["replay_library_ms"] / RWKV_LEAVES,
        replay_ms=tm["replay_ms"], reduce_step_ms=tm["reduce_ms"])}
    rec = dict(n_layers=RWKV_TRAIN_LAYERS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               steps=RWKV_TRAIN_STEPS, leaves=RWKV_LEAVES, summary=summary,
               gaps=gaps, bars=dict(loss=TRAIN_LOSS_BAR,
                                    grad_norm=TRAIN_GNORM_BAR),
               kernel_vs_plain=vs_plain, timing=timing,
               plan_stats=dp["plan_stats"])
    emit("rwkv6_train", **rec)
    return rec, dict(by_mode=by_mode, max_abs_err=vs_plain["max_abs_err"])


def phase_rwkv6(device):
    """Phase 17: the rwkv6 family (see the module docstring)."""
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = _rwkv_cfg()
    sec = {}
    t = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(30), device=device)
    sec["init"] = time.perf_counter() - t
    prompts = np.random.RandomState(30).randint(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)
    t = time.perf_counter()
    engine = _rwkv_engine(cfg, params, prompts, device)
    sec["engine"] = time.perf_counter() - t
    t = time.perf_counter()
    sched = _rwkv_scheduler(cfg, params)
    sec["scheduler"] = time.perf_counter() - t
    t = time.perf_counter()
    forward = _rwkv_forward(cfg, params, device)
    sec["forward"] = time.perf_counter() - t
    del params
    _free()
    t = time.perf_counter()
    short = _rwkv_f32(device, prompts)
    sec["short"] = time.perf_counter() - t
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    t = time.perf_counter()
    train, train_path = _rwkv_train(device)
    sec["train"] = time.perf_counter() - t
    emit("rwkv6", card=RECORD["device"]["nvidia_smi"], arch=RWKV_ARCH,
         n_layers=cfg.n_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
         vocab=cfg.vocab, params=cfg.param_count(), batch=BATCH,
         prompt=PROMPT, decode=DECODE,
         ms_per_token=engine["ms_per_token"],
         eager_ms_per_token=engine["eager_ms_per_token"],
         decode_bound_ms=engine["bound_ms"],
         scheduler_tokens_per_s=sched["tokens_per_s"],
         forward_ms=forward["ms"],
         loop_device_share=forward["loop_device_share"],
         train_step_ms={k: v["step_ms_median"]
                        for k, v in train["summary"].items()},
         serve_peak_memory_gb=serve_peak,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         seconds_by_part=sec, seconds=time.perf_counter() - t0)
    return train_path


# ---------------------------------------------------------------------------
# phase 18: FSDP in the trainer, and the dry run held against the card
# ---------------------------------------------------------------------------
def _fsdp_instrument(fs, plain):
    """Wrap the FSDP step's four collectives (``fs.comms``): CUDA events
    around each call, by part (``gather``: all-gather and broadcast;
    ``reduce``: reduce-scatter and all-reduce), and the bytes it must
    move: its payload read once and its output written once, every
    rank's, except a broadcast's payload, of which only the root's slot
    is read. While ``rec["check"]`` is set each call also runs on
    ``plain`` (the same axes' plans on ``TorchExecutor``), bit-equal
    (``max_abs_err`` stays 0) or recorded in ``unequal`` with its largest
    ``|out - want|`` in ``max_abs_err``, and on its one-call PyTorch
    counterpart, each timed."""
    rec = dict(check=False, calls=[], unequal=[], checked=0,
               max_abs_err=0.0)
    library = {
        "all_gather": lambda x: x.reshape(1, -1, x.shape[-1]).expand(
            x.shape[0], -1, -1).contiguous(),
        "broadcast": lambda x, root: x[root:root + 1].expand_as(x)
        .contiguous(),
        "reduce_scatter": lambda x: x.sum(0).reshape(
            x.shape[0], x.shape[1] // x.shape[0], x.shape[2]),
        "all_reduce": lambda x: x.sum(0, keepdim=True).expand_as(x)
        .contiguous()}

    def timed(fn, *a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*a)
        e1.record()
        return out, (e0, e1)

    for name, part in (("all_gather", "gather"), ("broadcast", "gather"),
                       ("reduce_scatter", "reduce"),
                       ("all_reduce", "reduce")):
        def call(x, *a, _fn=getattr(fs.comms, name),
                 _plain=getattr(plain, name), _lib=library[name],
                 _name=name, _part=part):
            out, ev = timed(_fn, x, *a)
            read = x[0].numel() if _name == "broadcast" else x.numel()
            c = dict(part=_part, ev=ev, bytes=(read + out.numel())
                     * x.element_size())
            if rec["check"]:
                want, c["plain_ev"] = timed(_plain, x, *a)
                lib, c["lib_ev"] = timed(_lib, x.contiguous(), *a)
                rec["checked"] += 1
                if not torch.equal(out, want):
                    rec["unequal"].append(_name)
                    # a rank's slot at a time: a gathered embedding is
                    # gigabytes, and the card is nearly full here
                    rec["max_abs_err"] = max([rec["max_abs_err"]] + [
                        float((o.float() - w.float()).abs().max())
                        for o, w in zip(out, want)])
                del want, lib
            rec["calls"].append(c)
            return out
        setattr(fs.comms, name, call)
    return rec


def _fsdp_gathers_exact(fs, params, held) -> dict:
    """Every group's gathered leaves (each rank's copy) and the gathered
    embedding and logits' weight, against the unsharded leaves: bit-equal
    or named."""
    from repro_torch.distributed import fsdp
    lay = fs.layout
    bad = []
    with torch.no_grad():
        for g in range(lay.groups):
            slots = fs.gather_group(held, g)
            for i, path, d in lay.group_leaves():
                if d is None:
                    continue
                got = fsdp._get(slots[i], path)
                want = fsdp._get(params["layers"][i], path)[g]
                if not all(torch.equal(got[r], want)
                           for r in range(got.shape[0])):
                    bad.append(f"{g}/{i}/{'/'.join(path)}")
            del slots
        for name in ("embed", "unembed"):
            if lay.dims.get(name) is None:
                continue
            got = fs.gather_root(held, name)
            if not all(torch.equal(got[r], params[name])
                       for r in range(got.shape[0])):
                bad.append(name)
            del got
    return dict(groups=lay.groups, leaves_sharded=sum(
        d is not None for _, _, d in lay.group_leaves()), unequal=bad)


def _fsdp_run(cfg, ndp, device):
    """FSDP_STEPS steps of the explicit FSDP trainer on DP ``ndp`` (module
    docstring, phase 18 (a)); the executor's launches counted from 0 just
    before the steps and read after each. Then one more step under
    ``torch.profiler`` (device activity only) for its device-busy ms,
    outside the counts and the peak."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.executor import CudaExecutor
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import step as st
    from repro_torch.kernels import comm_utils
    from repro_torch.mesh import RankAxis
    from repro_torch.train import optimizer as opt
    _free()
    axes = (RankAxis("data", ndp, device),)
    step = st.make_train_step(cfg, axes, _train_opt(FSDP_STEPS),
                              mode="explicit", global_batch=TRAIN_BATCH,
                              seq_len=TRAIN_SEQ, fsdp=True, device=device)
    fs, lay = step.fsdp, step.fsdp.layout
    params, _ = st.init_sharded(cfg, device=device)
    held = step.shard(params)
    exact = _fsdp_gathers_exact(fs, params, held)
    del params
    _free()
    state = opt.adamw_init(held)
    rec = _fsdp_instrument(fs, fsdp.FsdpComms(
        st.make_dp_communicators(axes, backend="torch")))
    batch = _train_batch(cfg)
    predicted = lay.predicted_launches(backward=True)
    CudaExecutor.launches = 0                   # just before the steps
    comm_utils.LAUNCHES.clear()
    losses, norms, launches, parts = [], [], [], []
    for i in range(FSDP_STEPS):
        rec.update(check=i == 0, calls=[])
        n0 = CudaExecutor.launches
        torch.cuda.synchronize()
        if i == 1:
            # the peak over the unchecked steps (step 0 binds every plan
            # and runs each twice more, on TorchExecutor and in one call)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        t = time.perf_counter()
        loss, grads = step.grads(held, batch)
        a0 = torch.cuda.Event(enable_timing=True)
        a1 = torch.cuda.Event(enable_timing=True)
        a0.record()
        held, state, m = opt.adamw_update(step.opt_cfg, held, grads, state,
                                          donate=True)
        a1.record()
        del grads
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        launches.append(CudaExecutor.launches - n0)
        dev = {p: sum(c["ev"][0].elapsed_time(c["ev"][1])
                      for c in rec["calls"] if c["part"] == p)
               for p in ("gather", "reduce")}
        part = dict(step_ms_wall=wall, gathers_ms_device=dev["gather"],
                    reductions_ms_device=dev["reduce"],
                    adamw_ms_device=a0.elapsed_time(a1))
        # the rank passes: the step's wall less its timed parts (they
        # interleave with the gathers group by group)
        part["rank_passes_ms_wall_residual"] = wall - sum(
            v for k, v in part.items() if k != "step_ms_wall")
        if i == 0:
            calls = rec["calls"]
            part["check_calls"] = len(calls)
            step0 = dict(
                launches=len(calls),
                ms=sum(c["ev"][0].elapsed_time(c["ev"][1]) for c in calls),
                plain_ms=sum(c["plain_ev"][0].elapsed_time(c["plain_ev"][1])
                             for c in calls),
                library_ms=sum(c["lib_ev"][0].elapsed_time(c["lib_ev"][1])
                               for c in calls),
                bound_ms=sum(c["bytes"] for c in calls)
                / HBM_BYTES_PER_S * 1e3)
        parts.append(part)
        losses.append(float(loss))
        norms.append(float(m["grad_norm"]))
    out = dict(ndp=ndp, kind="groups" if lay.dims["layers"][0]["attn"][
                   "wq"] == 0 else "inner",
               losses=losses, grad_norms=norms, launches_per_step=launches,
               predicted_launches=predicted, launches=CudaExecutor.launches,
               library_launches=dict(comm_utils.LAUNCHES),
               plan_checks=rec["checked"], plan_unequal=rec["unequal"],
               plan_max_abs_err=rec["max_abs_err"],
               gathers_exact=exact, parts=parts, step0_plans=step0,
               step_ms_median=float(np.median(
                   [p["step_ms_wall"] for p in parts[1:]])),
               peak_growth_gb=(torch.cuda.max_memory_allocated(device)
                               - base) / 1e9,
               peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    rec.update(check=False, calls=[])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, grads = step.grads(held, batch)
        held, state, _ = opt.adamw_update(step.opt_cfg, held, grads, state,
                                          donate=True)
        del grads
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = sum(r[0] for r in _device_rows(prof, 1)) / 1e3
    out["profiled_step"] = dict(wall_ms=wall, device_busy_ms=busy,
                                device_busy_share=busy / wall)
    del step, fs, held, state, rec, prof
    _free()
    return out


def _dry_counts() -> dict:
    """The dry run of phase 18 (b)'s two steps on fake tensors (no
    device): phase 4's explicit decode step (TP 4, batch 8, max_kv 1024,
    the position at the cache's end) and (a)'s DP 8 FSDP step, every rank
    traced stacked as the card runs them. Each: FLOPs, traffic, peak and
    input bytes, plan calls, the trace's seconds."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.mesh import NamedGrid
    from repro_torch.roofline import op_stats
    cfg = configs.get_config(ARCH)
    steps = {
        "decode": ("decode_32k", dict(global_batch=BATCH, seq_len=MAX_KV,
                                      kind="decode"), (1, TP)),
        "train": ("train_4k", dict(global_batch=TRAIN_BATCH,
                                   seq_len=TRAIN_SEQ, kind="train"),
                  (FSDP_DP[0], 1))}
    out = {}
    for name, (cell, shape, sizes) in steps.items():
        t = time.perf_counter()
        _, _, specs, low = dryrun.lower_cell(
            ARCH, cell, cfg=cfg, grid=NamedGrid(("data", "model"), sizes),
            shape=shape, one_rank=False)
        st = op_stats.analyze(lambda s, *a: s(*a), specs["params"],
                              prepare=low.prepare, recorder=low.recorder)
        out[name] = dict(flops=st.flops, traffic_bytes=st.traffic_bytes,
                         peak_bytes=st.peak_bytes, base_bytes=st.base_bytes,
                         plan_calls=len(st.calls), layout=low.layout,
                         model_flops=dryrun.model_flops(
                             cfg, shape["kind"], shape["global_batch"],
                             shape["seq_len"]),
                         trace_s=time.perf_counter() - t)
    return out


def _dry_vs_card(dry, growth_bytes, measured_ms) -> dict:
    """The dry run's counts of a step beside the card's run of it: the
    peak's growth over the step's inputs, FLOPs over the model's, and the
    roofline time (compute and memory terms at the H100's rates; one card
    has no NVLink) over the measured device ms."""
    from repro_torch.roofline import analysis as roof
    compute_s = dry["flops"] / roof.H100.peak_flops
    memory_s = dry["traffic_bytes"] / roof.H100.hbm_bw
    dry_growth = dry["peak_bytes"] - dry["base_bytes"]
    return dict(dry_peak_growth_gb=dry_growth / 1e9,
                card_peak_growth_gb=growth_bytes / 1e9,
                peak_rel_err=abs(dry_growth - growth_bytes) / growth_bytes,
                flops=dry["flops"], model_flops=dry["model_flops"],
                flops_over_model=dry["flops"] / dry["model_flops"],
                traffic_gb=dry["traffic_bytes"] / 1e9,
                compute_ms=compute_s * 1e3, memory_ms=memory_s * 1e3,
                measured_ms=measured_ms,
                share=max(compute_s, memory_s) * 1e3 / measured_ms,
                plan_calls=dry["plan_calls"], layout=dry["layout"],
                trace_s=dry["trace_s"])


def _decode_on_card(cfg, device) -> tuple:
    """Phase 4's explicit decode step on the card at the position the dry
    run takes: (peak growth over one eager step, device ms a replay of
    the step's CUDA graph, whether the device sleep covered the
    enqueue)."""
    from repro_torch.distributed import step as st
    from repro_torch.mesh import RankAxis
    from repro_torch.models import transformer as tf
    _free()
    step, lay = st.make_serve_step(cfg, RankAxis("model", TP, device),
                                   batch=BATCH, max_kv=MAX_KV,
                                   mode="explicit")
    params = lay.params(tf.init_params(cfg, device=device))
    _free()
    cache = lay.cache()
    toks = torch.zeros(BATCH, dtype=torch.long, device=device)
    pos = MAX_KV - 1
    with torch.inference_mode():
        step(params, cache, toks, pos)           # binds the plans
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        step(params, cache, toks, pos)
        torch.cuda.synchronize()
        growth = torch.cuda.max_memory_allocated(device) - base
    graph = st.capture_serve_step(step, params, cache, batch=BATCH,
                                  device=device)
    graph.pos.fill_(pos)
    ms, covered = device_ms(graph.graph.replay, 10)
    del graph, step, params, cache
    _free()
    return growth, ms, covered


def phase_fsdp(device):
    """Phase 18: FSDP and the dry run (see the module docstring)."""
    from repro_torch import configs
    t0 = time.perf_counter()
    cfg = configs.get_config(ARCH)
    sec = {}
    t = time.perf_counter()
    auto, _ = _train_run(cfg, "auto", device, steps=FSDP_STEPS,
                         opt_cfg=_train_opt(FSDP_STEPS))
    runs = {ndp: _fsdp_run(cfg, ndp, device) for ndp in FSDP_DP}
    sec["runs"] = time.perf_counter() - t
    for ndp, r in runs.items():
        r["gaps"] = _train_gaps(r, auto)
        label = f"fsdp DP {ndp}"
        check(bool(np.isfinite(r["losses"]).all()),
              f"{label}: losses {r['losses']}")
        check(r["gaps"]["loss"] <= TRAIN_LOSS_BAR
              and r["gaps"]["grad_norm"] <= TRAIN_GNORM_BAR,
              f"{label} vs auto: {r['gaps']} past phase 16's bars "
              f"({TRAIN_LOSS_BAR}, {TRAIN_GNORM_BAR})")
        check(not r["gathers_exact"]["unequal"],
              f"{label}: gathered leaves != the unsharded ones: "
              f"{r['gathers_exact']['unequal'][:8]}")
        check(r["plan_checks"] == r["launches_per_step"][0]
              and not r["plan_unequal"],
              f"{label}: step 0's plans against TorchExecutor's: "
              f"{r['plan_checks']} checked of {r['launches_per_step'][0]}, "
              f"unequal {r['plan_unequal'][:8]}")
        check(r["launches_per_step"] == [r["predicted_launches"]]
              * FSDP_STEPS,
              f"{label}: executor launches a step {r['launches_per_step']}, "
              f"not the predicted {r['predicted_launches']}")
        check(not r["library_launches"],
              f"{label}: library kernels on the trainer's path "
              f"{r['library_launches']}")
    check({r["kind"] for r in runs.values()} == {"inner", "groups"},
          f"fsdp: the grids shard {[r['kind'] for r in runs.values()]}, "
          f"not both kinds of dim")
    t = time.perf_counter()
    growth, ms, covered = _decode_on_card(cfg, device)
    check(covered, f"dry run decode: the device sleep did not cover the "
          f"graph replays' enqueue ({ms} ms a replay)")
    sec["decode"] = time.perf_counter() - t
    t = time.perf_counter()
    counts = _dry_counts()
    sec["dryrun"] = time.perf_counter() - t
    train_run = runs[FSDP_DP[0]]
    dry = {"decode": dict(_dry_vs_card(counts["decode"], growth, ms),
                          device_ms_covered=covered),
           "train": dict(_dry_vs_card(
               counts["train"], train_run["peak_growth_gb"] * 1e9,
               train_run["profiled_step"]["device_busy_ms"]),
               step_ms_wall=train_run["step_ms_median"],
               plan_calls_card=train_run["predicted_launches"])}
    emit("fsdp_dryrun", card=RECORD["device"]["nvidia_smi"], dryrun=dry,
         runs={f"dp{k}": {kk: v for kk, v in r.items() if kk != "parts"}
               for k, r in runs.items()})
    for name, d in dry.items():
        check(d["share"] <= DRYRUN_SHARE_MAX,
              f"dry run {name}: roofline {max(d['compute_ms'], d['memory_ms'])}"
              f" ms over the measured {d['measured_ms']} ms reads "
              f"{d['share']}, past {DRYRUN_SHARE_MAX}: the count is wrong")
        check(d["peak_rel_err"] <= DRYRUN_PEAK_REL_TOL,
              f"dry run {name}: peak growth {d['dry_peak_growth_gb']} GB "
              f"against the card's {d['card_peak_growth_gb']} GB, past "
              f"{DRYRUN_PEAK_REL_TOL}")
    p16 = RECORD.get("train_runs", {}).get("runs", {}).get("flat4")
    emit("fsdp", card=RECORD["device"]["nvidia_smi"], arch=ARCH,
         n_layers=cfg.n_layers, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         steps=FSDP_STEPS, bars=dict(loss=TRAIN_LOSS_BAR,
                                     grad_norm=TRAIN_GNORM_BAR,
                                     share=DRYRUN_SHARE_MAX,
                                     peak_rel=DRYRUN_PEAK_REL_TOL),
         auto=dict(losses=auto["losses"], grad_norms=auto["grad_norms"],
                   peak_gb=auto["peak_gb"]),
         runs={f"dp{k}": v for k, v in runs.items()},
         phase16_dp4_peak_gb=p16["peak_gb"] if p16 else None,
         dryrun=dry, seconds_by_part=sec,
         seconds=time.perf_counter() - t0)
    by = {}
    for ndp, r in runs.items():
        s0 = r["step0_plans"]
        by[f"dp{ndp}"] = dict(
            launches=r["launches"], launches_per_step=s0["launches"],
            **{k: s0[k] / s0["launches"] for k in
               ("ms", "plain_ms", "bound_ms", "library_ms")})
    return dict(by_mode=by, max_abs_err=max(
        r["plan_max_abs_err"] for r in runs.values()))


# ---------------------------------------------------------------------------
# phase 19: the channels and the examples
# ---------------------------------------------------------------------------
CH_SOURCE = "src/repro_torch/csrc/channels.cu"
# the reference code each entry point carries to the card: its channel
# classes, which reach no pallas_call of their own
CH_REPLACES = {"port_put": "src/repro/core/channels.py:134",
               "fused_reduce": "src/repro/core/channels.py:145"}
CH_N = (2, 4, 8)
CH_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
CH_SIZES = {"1KiB": 1 << 10, "64KiB": 64 << 10, "1MiB": 1 << 20,
            "16MiB": 16 << 20}                   # bytes a rank
CH_ODD = ("1KiB", "1MiB")                        # also at an odd count
CH_CHAIN = 16            # back-to-back launches, alternating the two
CH_REPLAYS = 16          # graph replays of each entry point
CH_LINE = (4, "16MiB", torch.bfloat16)           # the kernels line's shape
GEMM_DIM = 8192          # the report-only overlap GEMM (bf16, square)
GEMM_ITERS = 8


def _ch_cases():
    """(n, dtype, label, count) of the grid: every size at its full count,
    the CH_ODD sizes also one element short (an odd count)."""
    out = []
    for n in CH_N:
        for dtype in CH_DTYPES:
            esz = torch.empty((), dtype=dtype).element_size()
            for label, nbytes in CH_SIZES.items():
                out.append((n, dtype, label, nbytes // esz))
                if label in CH_ODD:
                    out.append((n, dtype, label + "-1", nbytes // esz - 1))
    return out


def _ch_ops():
    from repro_torch.kernels import channels as ch
    return {"port_put": (ch.port_put, ch.port_put_plain),
            "fused_reduce": (ch.fused_reduce, ch.fused_reduce_plain)}


def _ch_held(name, got, x, errs, what):
    """``got`` bit-equal to the plain model on ``x``."""
    want = _ch_ops()[name][1](x)
    err = _max_abs_err(got, want)
    errs[name] = max(errs.get(name, 0.0), err)
    check(torch.equal(got, want), f"{name} {what}: |kernel - plain| {err}")


def _ch_grid(gen, device, errs):
    """Both entry points bit-equal to their plain models over the grid."""
    cases = 0
    for n, dtype, label, count in _ch_cases():
        x = _rand((n, 1, count), dtype, gen, device)
        for name, (kern, _) in _ch_ops().items():
            _ch_held(name, kern(x), x, errs,
                     f"n={n} {dtype} {label} ({count} elements)")
            cases += 1
        del x
    torch.cuda.empty_cache()
    return cases


def _ch_chain(gen, device, errs):
    """The channels' path: CH_CHAIN launches back to back, alternating the
    two entry points on one input each (an odd bf16 count and f32), each
    result held after the chain. The launch counts are set to 0 just
    before and read just after."""
    from repro_torch.kernels import comm_utils
    xs = {"port_put": _rand((4, 3, 1021), torch.bfloat16, gen, device),
          "fused_reduce": _rand((4, 5, 2047), torch.float32, gen, device)}
    for name, (kern, _) in _ch_ops().items():   # workspaces, off the count
        kern(xs[name])
    torch.cuda.synchronize()
    comm_utils.LAUNCHES.clear()                 # just before the path
    outs = []
    for i in range(CH_CHAIN):
        name = list(xs)[i % 2]
        outs.append((name, _ch_ops()[name][0](xs[name])))
    torch.cuda.synchronize()
    launches = {k: comm_utils.LAUNCHES[k] for k in xs}   # read just after
    for i, (name, got) in enumerate(outs):
        _ch_held(name, got, xs[name], errs, f"chain launch {i}")
    for k, c in launches.items():
        check(c == CH_CHAIN // 2, f"{k}: {c} launches in the chain")
    return launches


def _ch_graph(gen, device, errs):
    """Each entry point captured once in a CUDA graph and replayed
    CH_REPLAYS times on fresh inputs, each replay bit-equal to the plain
    model (the epoch lives on the card)."""
    out = {}
    for name, (kern, _) in _ch_ops().items():
        for dtype in (torch.float32, torch.bfloat16):
            x = _rand((8, 7, 1031), dtype, gen, device)
            kern(x)                               # the workspace, eagerly
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s), torch.cuda.graph(g, stream=s):
                y = kern(x)
            torch.cuda.current_stream().wait_stream(s)
            for i in range(CH_REPLAYS):
                x.copy_(_rand(x.shape, dtype, gen, device))
                g.replay()
                torch.cuda.synchronize()
                _ch_held(name, y, x, errs, f"{dtype} graph replay {i}")
            out[f"{name}/{str(dtype).replace('torch.', '')}"] = CH_REPLAYS
            del g
    return out


def _ch_time(gen, device):
    """µs a launch of both entry points at n in CH_N x every size (bf16),
    beside the HBM bound (each rank's input read once, its output written
    once), one PyTorch call (``index_select`` into ``out``: the put;
    ``x.sum(0)`` expanded: the reduce) and the plain model."""
    from repro_torch.kernels import comm_utils
    rows = []
    for n in CH_N:
        for label, nbytes in CH_SIZES.items():
            x = _rand((n, 1, nbytes // 2), torch.bfloat16, gen, device)
            src = (torch.arange(n, device=device) - 1) % n
            out = torch.empty_like(x)
            libs = {"port_put": lambda x=x, out=out, src=src:
                    torch.index_select(x, 0, src, out=out),
                    "fused_reduce": lambda x=x:
                    x.sum(0, keepdim=True).expand_as(x).contiguous()}
            total = 2 * x.numel() * x.element_size()
            iters = max(5, min(200, int(2e9 // total)))
            for name, (kern, plain) in _ch_ops().items():
                k_ms, k_cov = device_ms(lambda: kern(x), iters)
                p_ms, p_cov = device_ms(lambda: plain(x), max(3, iters // 8))
                l_ms, l_cov = device_ms(libs[name], iters)
                rows.append(dict(
                    kernel=name, n=n, size=label, dtype="bfloat16",
                    rank_bytes=nbytes, ms=k_ms, plain_ms=p_ms,
                    library_ms=l_ms, bound_ms=total / HBM_BYTES_PER_S * 1e3,
                    bytes=total, blocks_per_rank=comm_utils.workspace(
                        name, x).blocks,
                    sleep_covered=dict(kernel=k_cov, plain=p_cov,
                                       library=l_cov)))
            del x, out
            torch.cuda.empty_cache()
    return rows


def _ch_overlap(gen, device):
    """Report only: the µs of a bf16 GEMM_DIM^3 matmul on a second stream,
    alone, then beside a stream of 16 MiB-a-rank puts (n = 4) through the
    PortChannel (TMA: one thread a block copies) and through the SM copy
    (``msccl::put``: every thread of the block copies), enough puts to
    cover the GEMMs. Which put leaves the SMs to the GEMM shows in its
    time; nothing is gated."""
    from repro_torch.kernels import channels as ch
    a = torch.randn(GEMM_DIM, GEMM_DIM, generator=gen, device=device).to(
        torch.bfloat16)
    b = torch.randn(GEMM_DIM, GEMM_DIM, generator=gen, device=device).to(
        torch.bfloat16)
    x = _rand((4, 1, (16 << 20) // 2), torch.bfloat16, gen, device)
    side = torch.cuda.Stream()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def gemms():
        with torch.cuda.stream(side):
            ev[0].record(side)
            for _ in range(GEMM_ITERS):
                a @ b
            ev[1].record(side)

    def run(put=None, count=0):
        torch.cuda.synchronize()
        if put is not None:
            ev[2].record()
            for _ in range(count):
                put()
            ev[3].record()
        gemms()
        torch.cuda.synchronize()
        return (ev[0].elapsed_time(ev[1]) / GEMM_ITERS * 1e3,
                ev[2].elapsed_time(ev[3]) / max(count, 1) * 1e3
                if put is not None else None)

    run()                                           # warm-up
    alone, _ = run()
    res = dict(gemm_alone_us=alone, gemm_dim=GEMM_DIM, rank_bytes=16 << 20,
               n=4)
    for label, tma in (("port_put", True), ("sm_put", False)):
        put = functools.partial(ch.port_put, x, tma=tma)
        put()
        put_us = device_ms(put, 10)[0] * 1e3
        count = int(alone * GEMM_ITERS / put_us) + 2
        gemm_us, during_us = run(put, count)
        res[label] = dict(put_alone_us=put_us, puts=count,
                          gemm_beside_us=gemm_us,
                          put_beside_us=during_us)
    del a, b, x
    torch.cuda.empty_cache()
    return res


def _ch_phase(gen, device):
    """Phase 19 (a): the two channel entry points."""
    errs = {}
    cases = _ch_grid(gen, device, errs)
    launches = _ch_chain(gen, device, errs)
    graphs = _ch_graph(gen, device, errs)
    timing = _ch_time(gen, device)
    overlap = _ch_overlap(gen, device)
    return dict(cases=cases, launches=launches, graph_replays=graphs,
                max_abs_err=errs, timing=timing, overlap=overlap)


EXAMPLES = ROOT / "examples_torch"
# each example's argv on the card: the reference's sizes, models and
# defaults (serve_llm's 32 tokens, prefix_serve's 16 requests), only
# train_llm's 300 steps cut to 10 to fit the phase's time
EXAMPLE_ARGS = {
    "custom_collective": [], "quickstart": [], "communicator": [],
    "profile_plan": [], "hierarchical": [],
    "serve_llm": ["--tokens", "32"],
    "prefix_serve": [],
    "train_llm": ["--steps", "10"],
}


def _example(name):
    """``examples_torch/<name>.py`` as a module (the folder is no
    package); importing it runs nothing."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(name, argv):
    """One example's ``main(argv)`` with every launch count set to 0 just
    before and read just after: (its result, executor launches (its
    traced instantiation's among them), library kernel launches,
    seconds)."""
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.kernels import comm_utils
    main = _example(name).main
    torch.cuda.synchronize()
    CudaExecutor.launches = 0                    # just before the example
    CudaExecutor.traced_launches = 0
    comm_utils.LAUNCHES.clear()
    t = time.perf_counter()
    res = main(list(argv))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = (CudaExecutor.launches            # read just after
                + CudaExecutor.traced_launches,
                {k: v for k, v in comm_utils.LAUNCHES.items() if v})
    return res, launches[0], launches[1], secs


def _examples_phase(device):
    """Phase 19 (b): every example in-process through its ``main(argv)``
    on the card, each gated, each launching at least one kernel."""
    rec, counts = {}, {}

    def run(name, *extra):
        res, ex, lib, secs = _run_example(name, EXAMPLE_ARGS[name]
                                          + list(extra))
        label = name + "".join(extra).replace("--mode", "/")
        counts[label] = dict(executor=ex, library=lib, seconds=secs)
        return res

    got = {}
    for name in ("custom_collective", "quickstart", "communicator",
                 "hierarchical"):
        got[name] = res = run(name)
        same = res["cuda_equals_torch"]
        ok = all(same.values()) if isinstance(same, dict) else same is True
        check(ok, f"example {name}: the executor kernel against the plain "
                  f"executor: {same}")
        rec[name] = dict(cuda_equals_torch=same)
    comm = got["communicator"]
    check(comm["json_bit_identical"],
          "communicator: the reloaded plan does not replay bit-identical")
    rec["communicator"].update(fitted=comm["fitted"],
                               fitted_algo=comm["fitted_algo"])
    hier = got["hierarchical"]
    check(hier["launches_per_replay"] == 3 and hier["exact"]
          and hier["json_bit_identical"],
          f"hierarchical: {hier['launches_per_replay']} launches a replay "
          f"(want 3), integer sum exact {hier['exact']}, reloaded "
          f"{hier['json_bit_identical']}")
    rec["hierarchical"].update(
        launches_per_replay=hier["launches_per_replay"],
        phases=hier["phases"])

    card = run("profile_plan")
    cpu = _example("profile_plan").main(["--device", "cpu"])
    check(card["events"] == cpu["events"],
          f"profile_plan: traced events {card['events']} on the card, "
          f"{cpu['events']} on the CPU")
    # reported, not gated: the serving surface's 1PA plan, whose kernel
    # issues one put a peer and one wait a flag slot (as the reference's
    # Pallas executor) where the plain executor lowers a fan-out round to
    # one emission (as the reference's XLA executor); the ring plans
    # above emit alike on both
    rec["profile_plan"] = dict(
        events=card["events"], span_us=card["span_us"], link=card["link"],
        tuned_algo=card["tuned_algo"],
        serve_trace_events=dict(card=card["serve_trace_events"],
                                cpu=cpu["serve_trace_events"],
                                algo=card["serve_trace_algo"]))

    serve = {m: run("serve_llm", "--mode", m) for m in ("explicit", "auto")}
    for m, r in serve.items():
        check(r["mode"] == m and r["graph"] and
              r["compiles_after_decode"] == r["compiles_before_decode"],
              f"serve_llm {m}: ran {r['mode']}, graph {r['graph']}, "
              f"compiles {r['compiles_before_decode']} -> "
              f"{r['compiles_after_decode']}")
    check(serve["explicit"]["tokens"] == serve["auto"]["tokens"],
          "serve_llm: f32 tokens differ between explicit and auto")
    rec["serve_llm"] = {m: dict(decode_ms_per_token=r["decode_ms_per_token"],
                                prefill_ms=r["prefill_ms"],
                                graph_launches=r["graph_launches"],
                                hits=r["hits"],
                                continuation=r["continuation"])
                        for m, r in serve.items()}

    ps = run("prefix_serve")
    check(ps["warm"]["bit_identical"] and ps["cold"]["bit_identical"]
          and ps["warm"]["prefix_hits"] > 0,
          f"prefix_serve: warm {ps['warm']['bit_identical']}, cold "
          f"{ps['cold']['bit_identical']}, hits {ps['warm']['prefix_hits']}")
    rec["prefix_serve"] = dict(
        micro_steps=dict(warm=ps["warm"]["micro_steps"],
                         cold=ps["cold"]["micro_steps"]),
        prefix_hits=ps["warm"]["prefix_hits"],
        prefix_misses=ps["warm"]["prefix_misses"],
        prefill_bucket_steps=ps["warm"]["prefill_bucket_steps"])

    tr = {m: run("train_llm", "--mode", m) for m in ("explicit", "auto")}
    for m, r in tr.items():
        check(len(r["losses"]) == 10 and r["losses"][-1] < r["losses"][0],
              f"train_llm {m}: losses {r['losses']} do not fall")
    gaps = _train_gaps(tr["explicit"], tr["auto"])
    check(gaps["loss"] <= TRAIN_LOSS_BAR
          and gaps["grad_norm"] <= TRAIN_GNORM_BAR,
          f"train_llm: explicit against auto {gaps}")
    stats = tr["explicit"]["plan_stats"]
    check(all(v["compiles"] == v["plans"] for v in stats.values()),
          f"train_llm: a gradient shape compiled twice: {stats}")
    rec["train_llm"] = dict(
        gaps=gaps, plan_stats=stats,
        losses={m: r["losses"] for m, r in tr.items()},
        mean_step_s={m: r["mean_step_s"] for m, r in tr.items()})
    # every example launched a kernel on the card (its auto-mode runs are
    # the comparison: they serve and train without plans)
    for name in EXAMPLE_ARGS:
        n = sum(c["executor"] + sum(c["library"].values())
                for label, c in counts.items() if label.split("/")[0] == name)
        check(n > 0, f"example {name} launched no kernel on the card")
    return dict(examples=rec, launches=counts)


def phase_channels_examples(device, gen):
    """Phase 19: (a) the channel entry points, (b) the examples."""
    t = time.perf_counter()
    ch = _ch_phase(gen, device)
    ch_s = time.perf_counter() - t
    ex = _examples_phase(device)
    emit("channels_examples", seconds=time.perf_counter() - t,
         channels_seconds=ch_s, channels=ch, examples=ex["examples"],
         example_launches=ex["launches"])
    return ch


def _ch_kernels(chan) -> list:
    """The kernels line's entries of the two channel entry points: their
    times at CH_LINE, every timed shape under ``per_shape``."""
    n, size, dtype = CH_LINE
    out = []
    for name in ("port_put", "fused_reduce"):
        rows = [r for r in chan["timing"] if r["kernel"] == name]
        row = next(r for r in rows if (r["n"], r["size"]) == (n, size))
        out.append(dict(
            name=name, route="cuda", source=CH_SOURCE,
            replaces=CH_REPLACES[name], launches=chan["launches"][name],
            max_abs_err=chan["max_abs_err"][name],
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "library_ms")},
            bound_by="bytes", n=n, size=size,
            dtype=str(dtype).replace("torch.", ""), per_shape=rows))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,8,9,10,11,12,13,14,15,16,17,18,19",
                    help="comma-separated phases to run (default 1-6 and "
                         "8-19; 7 profiles a decode step)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here, before any output,
    # when the script runs outside a checkout of the repository)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    (max_err, launches, timing, coll, moe, prefill, hier, hybrid, serve,
     api, train, rwkv, fsdp, chan) = (None,) * 14
    if 2 in phases:
        phase_build()
    if 3 in phases:
        max_err = phase_kernel_vs_plain(device, gen)
    if 4 in phases:
        launches = phase_main_path(device)
    if 5 in phases:
        phase_f32_reduced_depth(device)
    if 6 in phases:
        timing = phase_kernel_time(device, gen)
    if 7 in phases:
        phase_profile(device)
    if 8 in phases:
        coll = phase_collectives(device, gen)
    if 9 in phases:
        moe = phase_moe(device, gen)
    if 10 in phases:
        prefill = phase_prefill(device, gen)
    if 11 in phases:
        hier = phase_hierarchical(device, gen)
    if 12 in phases:
        hybrid = phase_hybrid(device)
    if 13 in phases:
        serve = phase_serve(device, gen)
    if 14 in phases:
        api = phase_api(device, gen)
    if 15 in phases:
        phase_chaos(device)
    if 16 in phases:
        train = phase_train(device)
    if 17 in phases:
        rwkv = phase_rwkv6(device)
    if 18 in phases:
        fsdp = phase_fsdp(device)
    if 19 in phases:
        chan = phase_channels_examples(device, gen)
    kernels = []
    # the trainers (phases 16, 17): the executor's launches over the
    # explicit runs (2 x 4: 3 a leaf a step; flat DP 4: one), and its times
    # a launch, each mode's plan replays over its launches a step, weighted
    # by the modes' launches. Kept out of the decode paths' weighted mean:
    # a gradient leaf's launch is milliseconds
    train_paths = {}
    for path, rec in ((TRAIN_PATH, train), (RWKV_TRAIN_PATH, rwkv),
                      (FSDP_PATH, fsdp)):
        if rec is None:
            continue
        tb = rec["by_mode"]
        n_train = sum(v["launches"] for v in tb.values())
        train_paths[path] = dict(
            launches=n_train,
            launches_per_step={m: v["launches_per_step"]
                               for m, v in tb.items()},
            **{k: sum(v[k] * v["launches"] for v in tb.values()) / n_train
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            per_mode=tb)
    train_errs = [rec["max_abs_err"] for rec in (train, rwkv, fsdp)
                  if rec is not None]
    if timing is not None:
        # each main path's per-step launch mix at full occupancy (every
        # plan family at its top bucket): qwen3-1.7b's layer AllReduces
        # and embedding, one logits gather; phi3.5-moe's attention
        # AllReduces and embedding, dispatch and combine per layer, one
        # logits gather; hymba-1.5b's attention, SSM and MLP AllReduces.
        # The entry's times are the paths' means
        # weighted by their launches (phases 4, 9 and 12, each counted from
        # 0: the wrapper's launches over the engine's construction, the
        # warm-up steps and the capture of its graph; the executor
        # kernels that the profiler counted over later replays of that
        # graph are ``launches_profiled`` over ``replays_profiled``);
        # ``by_path`` keeps each path's own
        from repro_torch import configs
        n_layers = configs.get_config(ARCH).n_layers
        mixes = {ARCH: {"layer_allreduce": 2 * n_layers + 1,
                        "logits_allgather": 1},
                 MOE_ARCH: {"layer_allreduce": MOE_LAYERS + 1,
                            "moe_alltoall": 2 * MOE_LAYERS,
                            "logits_allgather": 1},
                 HYBRID_ARCH: {"layer_allreduce":
                               3 * _hybrid_cfg().n_layers}}
        counted = {ARCH: launches or (None, None, None),
                   MOE_ARCH: moe[2] if moe else (None, None, None),
                   HYBRID_ARCH: hybrid or (None, None, None)}
        keys = ("ms", "plain_ms", "bound_ms", "library_ms")
        by_path = {}
        for arch, mix in mixes.items():
            top = {p: max((t for t in timing
                           if t["arch"] == arch and t["plan"] == p),
                          key=lambda t: t["rows"]) for p in mix}
            total = sum(mix.values())
            by_path[arch] = dict(
                launches=counted[arch][0],
                launches_profiled=counted[arch][1],
                replays_profiled=counted[arch][2], launch_mix=mix,
                blocks_per_rank={p: top[p]["blocks_per_rank"] for p in mix},
                threads={p: top[p]["threads"] for p in mix},
                **{k: sum(top[p][k] * c for p, c in mix.items()) / total
                   for k in keys})
        if serve is not None:
            # the serving path (phase 13, trace A explicit): the executor
            # at every slot bucket (graph replays) and at the fused
            # prefill steps' row buckets. ``launches`` is the wrapper's
            # count from 0 (the bucket graphs' warm-ups and captures, and
            # every prefill step), beside the graphs' replays and the
            # prefill steps; the times are the per-shape times weighted
            # by ``time_weights`` (graph replays x each plan's dispatches
            # into one capture, and the prefill steps' counted launches)
            sv = serve["executor"]
            w = sv["time_weights"]
            per = {f"{r['plan']}@{r['rows']}": r
                   for r in timing + serve["executor_time"]
                   if r["arch"] == ARCH}
            total = sum(w.values())
            counted[SERVE_PATH] = (
                sv["launches"],
                sum(v["profiled_executor_kernels"]
                    for v in serve["buckets"].values()),
                SERVE_PROFILED * len(serve["buckets"]))
            by_path[SERVE_PATH] = dict(
                launches=counted[SERVE_PATH][0],
                launches_profiled=counted[SERVE_PATH][1],
                replays_profiled=counted[SERVE_PATH][2],
                graph_launches=sv["graph_launches"],
                graph_replays=sv["graph_replays"],
                prefill_steps=sv["prefill_steps"],
                prefill_launches=sv["prefill_launches"],
                time_weights=w,
                blocks_per_rank={b: per[b]["blocks_per_rank"] for b in w},
                threads={b: per[b]["threads"] for b in w},
                **{k: sum(per[b][k] * n for b, n in w.items()) / total
                   for k in keys})
        weight = {a: v["launches"] for a, v in by_path.items()
                  if v["launches"]} or {ARCH: 1}
        # phase 3's cases and every timed shape, each held bit-equal
        shapes = timing + (serve["executor_time"] if serve else [])
        errs = [e for e in [max_err] + [t["max_abs_err"] for t in shapes]
                if e is not None]
        by_path.update(train_paths)
        errs += train_errs
        kernels.append(dict(
            name="dsl_executor", route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES, max_abs_err=max(errs),
            launches=(sum(weight.values())
                      if any(c[0] for c in counted.values()) else None),
            launches_profiled=(sum(c[1] for c in counted.values() if c[1])
                               or None),
            replays_profiled=(sum(c[2] for c in counted.values() if c[2])
                              or None),
            **{k: sum(by_path[a][k] * w for a, w in weight.items())
               / sum(weight.values()) for k in keys},
            bound_by="bytes",
            blocks_per_rank=sorted({t["blocks_per_rank"] for t in timing}),
            threads=sorted({t["threads"] for t in timing}),
            by_path=by_path, per_shape=shapes,
            # phase 14: the traced kernel's µs over the untraced one's, at
            # every traced plan of (c) (median, worst, median by size)
            traced_overhead=api))
    elif train_paths:
        # without phase 6 the executor's entry is the trainers' alone, the
        # paths weighted by their launches
        n_train = sum(v["launches"] for v in train_paths.values())
        kernels.append(dict(
            name="dsl_executor", route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES, max_abs_err=max(train_errs),
            launches=n_train,
            **{k: sum(v[k] * v["launches"] for v in train_paths.values())
               / n_train for k in ("ms", "plain_ms", "bound_ms",
                                   "library_ms")},
            bound_by="bytes", by_path=train_paths))
    if hier is not None:
        # the executor's group view on phase 11's path, apart from the
        # decode mixes above: 14 hierarchical replays of 3 launches each.
        # Times are the replays' sums over their launches (the plain
        # executor replaying the same plan files; x.sum(0) expanded), so
        # launches x ms is the path's executor time; ``per_shape`` keeps
        # each leaf's whole replay
        ht = hier["hier_timing"]
        n_hier = hier["launches"]["executor"]
        kernels.append(dict(
            name="dsl_executor_group_view", route="cuda",
            source=KERNEL_SOURCE, replaces=REPLACES, launches=n_hier,
            max_abs_err=hier["err_plan"],
            **{k: sum(r[src] for r in ht) / n_hier
               for k, src in (("ms", "plan_ms"), ("plain_ms", "plan_plain_ms"),
                              ("bound_ms", "bound_ms"),
                              ("library_ms", "library_ms"))},
            bound_by="bytes", grid=f"{HIER_NN}x{HIER_L}",
            launches_per_replay=n_hier // len(ht),
            blocks_per_rank=sorted({b for r in ht
                                    for b in r["plan_blocks_per_rank"]}),
            threads=sorted({t for r in ht for t in r["plan_threads"]}),
            per_shape=[dict(leaf=r["leaf"], replay_ms=r["plan_ms"],
                            plain_replay_ms=r["plan_plain_ms"],
                            bound_ms=r["bound_ms"],
                            library_ms=r["library_ms"],
                            blocks_per_rank=r["plan_blocks_per_rank"],
                            threads=r["plan_threads"]) for r in ht]))
    if coll is not None:
        # the decode-size row of each kernel: the 1PA LL decode AllReduce,
        # the ReduceScatter half of the decode AllReduce through 2PA, and
        # the logits gather through the ring; the all-pairs AllGather at
        # its main-path size (the AllGather half of the prefill AllReduce
        # through 2PA), the decode half beside it
        errs, coll_launches, coll_timing = coll
        at = {"all_reduce_1pa": ("decode", True),
              "reduce_scatter_2pa": ("decode", None),
              "all_gather_2pa": ("prefill_2pa_half", None),
              "all_gather_ring": ("logits", None)}
        keys = ("ms", "plain_ms", "bound_ms", "library_ms")

        def size_row(name, label, ll=None):
            return next(r for r in coll_timing[name]
                        if r["size"] == label and r.get("use_ll") == ll)

        for name, (source, replaces) in COLLECTIVES.items():
            label, ll = at[name]
            row = size_row(name, label, ll)
            extra = {}
            if name == "all_reduce_1pa":
                hb = size_row(name, label, False)
                extra.update(
                    {k: row[k] for k in ("launch_floor_ms", "pair_ms",
                                         "pair_ms_no_pdl", "ms_no_pdl",
                                         "tiles", "cluster", "smem_bytes")},
                    hb={k: hb[k] for k in keys + ("launch_floor_ms",
                                                  "pair_ms",
                                                  "pair_ms_no_pdl")})
            if name == "all_gather_2pa":
                extra["size"] = label
                extra["decode_half"] = {
                    k: size_row(name, "decode_2pa_half")[k]
                    for k in keys + ("protocol",)}
            kernels.append(dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=coll_launches.get(name, 0), max_abs_err=errs[name],
                **{k: row[k] for k in keys}, bound_by="bytes", **extra))
    if moe is not None:
        # the decode top bucket: 64 rows per block, (4, 256, 4096) bf16
        a2a_err, a2a_launches, _, a2a_timing = moe
        row = next(r for r in a2a_timing
                   if r["size"] == f"moe_c{_moe_caps()[-1]}")
        kernels.append(dict(
            name="all_to_all", route="cuda", source=A2A_SOURCE,
            replaces=A2A_REPLACES, launches=a2a_launches,
            max_abs_err=a2a_err, ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by="bytes",
            library_ms=row["library_ms"]))
    if prefill is not None:
        # launch-weighted over the main path's forwards: each shape's
        # layers per forward
        fa_err, fa_launches, fa_timing = prefill
        mean = {k: sum(r[k] * r["layers_per_forward"] for r in fa_timing)
                / sum(r["layers_per_forward"] for r in fa_timing)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                          "ops_ms", "bytes_ms")}
        kernels.append(dict(
            name="flash_attention", route="cuda", source=FA_SOURCE,
            replaces=FA_REPLACES, launches=fa_launches, max_abs_err=fa_err,
            **{k: mean[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "library_ms")},
            bound_by="operations" if mean["ops_ms"] >= mean["bytes_ms"]
            else "bytes", per_shape=fa_timing))
    if hier is not None:
        # launch-weighted over the main path: one 2PH launch per gradient
        # leaf, one AllGather-matmul launch per shape and output type
        keys = ("ms", "plain_ms", "bound_ms", "library_ms")
        ht, mt = hier["hier_timing"], hier["mm_timing"]
        kernels.append(dict(
            name="all_reduce_2ph", route="cuda", source=AR2PH_SOURCE,
            replaces=AR2PH_REPLACES,
            launches=hier["launches"]["all_reduce_2ph"],
            max_abs_err=hier["err_2ph"],
            **{k: sum(r[k] for r in ht) / len(ht) for k in keys},
            bound_by="bytes", per_shape=ht))
        mean = {k: sum(r[k] for r in mt) / len(mt)
                for k in keys + ("ops_ms", "bytes_ms")}
        kernels.append(dict(
            name="allgather_matmul", route="cuda", source=AGMM_SOURCE,
            replaces=AGMM_REPLACES,
            launches=hier["launches"]["allgather_matmul"],
            max_abs_err=max(r["max_abs_err"] for r in hier["mm_main"]),
            **{k: mean[k] for k in keys},
            bound_by="operations" if mean["ops_ms"] >= mean["bytes_ms"]
            else "bytes", per_shape=mt))
    if chan is not None:
        kernels += _ch_kernels(chan)
    emit("total", seconds=time.perf_counter() - t0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(RECORD, kernels=kernels), indent=1))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
