#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--n-users N] [--serve-requests N] [--seed N]

Builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc for
sm_90a and drives the port's paths, the MWU graph-LP solve, the
hubert-xlarge encoder forward, recurrentgemma-9b's forward (RG-LRU blocks
and MQA local attention at head dim 256), graph-LP serving
(``repro_torch.lpserve``), the paper's two comparison studies (Table
3's step rules, Figure 3's MPCSolver baseline), the distributed solve
(``repro_torch.dist``), mixtral-8x22b's MoE forward with the paper's
MWU LP router inside it, mixtral-8x22b's decode (the KV cache, prefill
and the serving engine, ``repro_torch.serve``), mixtral-8x22b's training
(``repro_torch.train``: the train step, AdamW, checkpoints, the Trainer),
and the last two configs, mamba2-1.3b (the Mamba-2 SSD block) and
internvl2-26b (the vision_text modality), forward, decode and training, in
twelve phases, and in a thirteenth the dry run (``repro_torch.launch``) held
against the card; any failed phase exits non-zero before the result lines are
printed.

1. Card: its name and power limit (nvidia-smi) and the kernels' build time.
2. Kernels vs their plain PyTorch versions on the card, at the main path's
   shapes, in float32 and float64: max error against the bar; the device
   time of the kernel and of the plain version (one call captured in a
   CUDA graph and replayed between CUDA events); the time of an eager call,
   which for short vectors is the host's cost; one library call computing
   the same function where there is one; and the bound (bytes read once
   and written once over 3.35 TB/s, or operations over the card's peak).
   Flash attention gets rows at published widths: (a) hubert-xlarge's
   attention (B 16, S 1500, 16 heads, d 80, bidirectional) and (b)
   minitron-4b's (B 1, S 4096, 24 over 8 heads, d 128, causal) in bf16 and
   f32, (c) mixtral-8x22b's (B 1, S 6144, 48 over 8 heads, d 128,
   causal, window 4096) in bf16 and f32 (phase 10 (a)'s prefill), and (d) recurrentgemma-9b's at phase 5
   (b)'s shape (B 2, S 8192, 16 over 1 heads, d 256, causal, window 2048)
   in bf16 and f32, and (e) internvl2-26b's at phase 12 (d)'s forward (B 1,
   S 32768, 48 over 8 heads, d 128, causal) in bf16, with the
   card's name and power limit. Within bar means |kernel - plain| <= bar * (1 + |plain|)
   elementwise (tests/test_kernels.py's atol = rtol). At these sizes every
   call is bound by the device, so the plain version is timed eagerly (its
   f32 scores take up to 8.6 GB, too much to capture twice in a CUDA graph);
   the library time is ``scaled_dot_product_attention`` with the same mask,
   a yardstick the port never calls. Each flash row also prints its
   achieved TFLOP/s (4 d flops per scored pair over the device time) and,
   in bf16, the kernel's tile choices (swizzle, boxes, stages, tile rows,
   shared memory) as the built library reports them. The f32 rows are
   bound by 3x their flops over the TF32 tensor-core peak (the kernel's
   3xTF32 products), and also print the bound of the same flops once at f32
   FMA, SDPA's time in f32, and the card's name and power limit. Both
   bodies' ptxas lines (registers, spills) are printed per head dim; a
   spill at d 80 or 128 in either, or at d 256 in the bf16 body, fails the
   phase (the f32 body's d 256 line is printed, its spills written down). The Newton search runs on three seeded
   states a dtype: equal bit for bit to the host loop over the probe
   kernel, and within ls_eps * alpha of its plain version (the same loop
   over plain PyTorch probes), whose time is the row's plain time. Its
   step form, as the MWU loop launches it (max(d) and the warm start read
   from device memory, the record [alpha, probes, completes, step, bad]
   written there), gets a row of its own, held on those states and one
   whose alpha < 1, at max(d) > 0 and = 0, to the host loop bit for bit
   and to its plain version. The binary search kernel (Alg. 3 in one
   launch, ``binary_rows``) gets its step-form row at the solve's shape and
   masked at phase 6's bucket, held in both forms to the host loop over the
   probe kernel bit for bit (alpha, probes, completes; step, bad and
   alpha_prev) and to its plain version within ls_eps where alpha >= 1.
   The axpy gets a second row too: its step read
   from device memory (the form the loop launches), bit for bit the
   host-float form and the plain version, in place as well.
   ``step_direction`` (g gathered from w, as bmatch's solve runs it) must
   give d bit for bit as the plain eager chain, in both of its sources, and
   max(d) exactly. The gather runs in every form (plain, with an edge
   slab's mask, weighted, both), each bit for bit its plain version, beside
   cuSPARSE's M^T w over the CSR of its entries. ``incidence_scatter`` runs M x with the items' Zipf
   popularity of the bmatch graph (one item of ~740k entries): within
   1e-4 (f32) / 1e-10 (f64) of its plain version relative to max(1,
   |plain|), two launches bitwise equal, with the v side as the operator
   cuts it into slabs of x and in one piece (that segment spans hundreds
   of merge tiles); its library time is the two ``index_add_`` calls it
   replaces. The masked forms (row masks, one byte a row: the padded rows
   of phase 6's requests) get rows of their own at phase 6's bucket
   V1048576xE4194304 with tier 1's rows real: the gather over the padded
   match operator's edges in every form (its edge mask: a served vcover
   lane's covering product; beside cuSPARSE's M^T w), the step direction
   of a served match lane (the gather with the edge mask inside the pass:
   d bit for bit the plain chain, max(d) exact), softmax over the vertex rows
   (weights exactly 0 off the mask), the two-sided probe over both (mins
   exact), the search in both forms at a served match request's shape (the
   vertex rows masked) and at a served vcover request's ([1, 4,194,304],
   the edge rows masked: form "masked cover"), held as above (bit for bit
   against the host loop over the masked probe kernel, within ls_eps of
   the masked plain loop); every timed search row prints the kernel's
   plan (shared memory or streamed) and its ms a sweep,
   the axpy's min and max over the edge rows (exact; the update bit for
   bit over every row), and the scatter over the match operator of tier
   1's request padded onto the bucket (3M of 4,194,304 edges kept; x fits
   the L2), held as above, with cuSPARSE's time.
3. The full-size solve: bipartite matching (bmatch) at float64 on the
   Netflix Prize shape, ``bipartite_ratings(480_189, 17_770,
   avg_ratings=209, seed=0)`` (498k vertices, 98.6M edges), through
   ``Solver(MWUOptions(eps=0.1, step_rule="newton"), batch_width=4)``,
   whose rounds of four bounds run as the four lanes of one
   ``solve_batch``: the phase prints each round's lanes, bounds, lane
   iterations and wall time, the loop iterations (the longest lane's a
   round), the certificate's time alone (``certify_solution``, on the
   host), peak memory of a plain Solver's solve and the lanes' state as
   reckoned beforehand. Round
   1's four lanes must equal four sequential ``feasible()`` solves at its
   bounds bit for bit (status, iterations, probes, certificates, x).
   The certified objective must be within 1.5*eps of the exact maximum
   matching (scipy's Hopcroft-Karp; the bipartite matching LP is
   integral) and max(Mx), recomputed on the host, at most 1 + 1e-9.
   The scatter's CSR (bytes, build time) is built first. The solve runs
   twice: the two must give the same feasibility calls, iterations,
   probes, objective and x bits (no atomics in the scatter). The launch
   counts of the first show that it went through every MWU kernel but the
   probe's and the standalone gather's: the Newton search and the step
   direction, each launched once a lane iteration, the axpy three times,
   probe and gather inside their own launches. One more feasibility solve
   at the certified bound, and round 1's batch again, are each timed, then
   profiled (the two repeat) for the device time by kernel, the search's
   share, the device's idle share and the host reads (device-to-host
   copies) a loop iteration, which must be one, plus three at most for
   the run; the profile must show the scatter and step-direction kernels
   and no ``index_add_`` kernel. ``--n-users`` cuts the user count (items
   and ratings per user stay).
4. Small solves, card vs CPU, for all six families: same status, bound
   within rel 1e-5, objective within rel 2*eps; each card solve run twice
   repeats bit for bit, and their launches give the gather's count in the
   kernels line. Then four-lane ``solve_batch`` calls on the card for
   the six families and a ``stack_problems`` batch of two match instances
   (erdos(4096, 40000)): each lane equal to the card's ``feasible()`` at
   its bound bit for bit. Then match and vcover on
   rgg(12) with ``step_rule="binary"``: the binary search kernel once a
   lane iteration (its launches are its count in the kernels line), no
   lone probe (the probe's count there: 0), the host read once a loop
   iteration (printed), and each solve's status, iterations, probes and
   ``sha256 binary x`` line to compare with another tree
   (``tools/binary_bits.py``).
5. The hubert-xlarge encoder forward at full width: 48 layers, d_model
   1280, 16 heads of d 80, ``attn_impl="pallas"``, bf16 compute over f32
   params from a seeded random init, on 16 utterances x 1500 frames (30 s
   at 50 frames/s; frames N(0, 0.02^2)), ``forward`` + ``logits`` under
   ``torch.inference_mode``. The launch counts of one forward must show
   flash attention 48 times; the logits must be finite and agree with the
   dense-attention forward on the same weights within a relative L2 error
   of 5e-2 (bf16 rounds at other places in the two paths, through 48
   residual layers). Time per forward, frames/s, peak memory, and a
   torch.profiler breakdown (flash, matmuls, the rest) with the device's
   idle share. (b) recurrentgemma-9b's forward at full width and depth:
   38 layers (12 x (rglru, rglru, attn), then (rglru, rglru)), d_model
   4096, 16 query heads over 1 kv head of d 256 in a 2,048-key window,
   rnn_width 4096, swiglu d_ff 12288, vocab 256,000, ``attn_impl="pallas"``,
   bf16 compute over f32 params from a seeded random init on the card
   (~9.57B params, ~38 GB), on 2 x 8192 tokens from a seeded generator
   (S is 4x the window: the band skip runs); ``forward`` under
   ``torch.inference_mode``, then ``logits`` of the last position only.
   One forward must launch flash attention 12 times, once an attn layer,
   each the d 256 body (the profile's kernel names); hidden states and
   logits finite, and within relative L2 5e-2 of the same module's forward
   with ``attn_impl="chunked"`` (no second copy of the weights). Prints
   time per forward (median of 5), tokens/s, init time, peak memory, and a
   profile split (flash, matmuls, the rglru scan, weight casts, the rest)
   with the idle share; the scan's share is timed by CUDA events around
   each of its 26 calls in one unprofiled forward. Then the
   scan itself: at the forward's shape (B 2, S 8192, w 4096, f32), with a
   drawn from U(0.9, 0.999) so that every doubling step counts, ``_scan``
   must equal a sequential f64 loop within 1e-5 (relative L2, and
   elementwise of 1 + |h|); and at full width (B 2, S 256, f32),
   ``rglru_apply`` must equal a loop of ``rglru_decode`` steps from an
   empty state within 1e-4 (atol and rtol): the reference's
   tests/test_layers.py identity (at the init's a of ~0.007 it checks the
   block's wiring, not the carry). (c) The same module's ``prefill`` of
   (b)'s 2 x 8192 tokens (a ring of 2,048 slots in each attn layer, the
   rglru states), then 8 ``decode_step``s: the last step's logits within
   relative L2 5e-2 of the last row of a forward over all 8,200 tokens, in
   bf16; prefill ms (flash once an attn layer, no other kernel of the
   port), ms a decode step (no kernel of the port), and one more step
   profiled (weight casts, matmuls, the rest, the idle share against
   that step's own time, CUDA events around it).
6. Graph-LP serving at card size: 12 requests (``--serve-requests``),
   match and vcover alternating, request i on ``erdos(n, m, seed=i)`` of
   tier i % 3 of (600k, 2.2M), (800k, 3M), (1.5M, 4M) vertices and edges,
   through ``LPEngine(LPServeConfig(MWUOptions(eps=0.1,
   step_rule="newton"), lanes=4))`` with the default bucket policy, in
   float64: buckets V1048576xE4194304 and V2097152xE4194304, four
   dispatch keys, every lane padded and masked. Prints per bucket its
   requests, batches, occupancy and padding waste; latency p50 and p99 and
   the engine's wall time, split into its rounds, its certificates (host
   clock) and the rest; each round's lanes, iterations and time; per
   request its calls and objective. Fails unless every request is found
   and feasible, max Mx <= 1 + 1e-9 (match) or min M^T x >= 1 - 1e-9
   (vcover) recomputed on the host, each objective within 3*eps of the
   sequential ``Solver(batch_width=1).solve`` on the card
   (examples/serve_lp_batch.py's contract), batches < feasibility calls,
   and every lane iteration launched the search and the step direction
   once (no lone probe), and the gather only for the vcover lanes'
   covering products (once a lane iteration and once at a lane's start):
   served match lanes gather inside the step direction. One more round,
   profiled (a fresh engine's
   second round over four tier-0/1 match requests, their CSR built by its
   first), must read the host at most its loop iterations + 3 times and
   launch no lone gather; it
   prints its device time by kernel, the device-to-host copies' time and
   the idle share against the same round of another fresh engine timed
   without the profiler.
7. The paper's comparison studies at full width, on phase 3's graph,
   float64. (a) Table 3: one profiled ``Solver.feasible`` of phase 3's
   bmatch problem at its certified bound per step rule, newton, binary
   and std (std cut to 500 iterations; the cut is printed): status,
   iterations, probes an iteration, device ms a lane iteration, ms a
   search launch, host reads a loop iteration (at most 1.01 for every
   rule, else the phase fails), the idle share and the kernels' launches.
   (b) Figure 3:
   generalized matching with ``benchmarks/bench_convergence.py``'s bounds
   (users lb = min(3, deg), ub = 5; items ub = 200), eps 0.05, by
   ``solve_traced`` with the newton and the std rule and by ``mpc_solve``,
   each cut to 2,000 iterations (std to 500): iterations to eps (or "not
   reached by the cap"), the final violation, ms an iteration, host reads an
   iteration and the kernels' launches; first ``mpc_solve`` on a small instance on the card against
   the CPU (the same iterations, x within rel 1e-9).
8. The distributed solve (``repro_torch.dist``) on phase 3's problem. (a)
   ``DistSolver(plan=MeshPlan(), batch_width=4).solve`` must equal phase
   3's ``Solver(batch_width=4).solve``: x by sha256, objective, bound,
   rounds and lane iterations. (b) Two ranks share the card: the script
   starts itself twice (``--dist-rank``, hidden), a ``file://`` init and
   gloo (NCCL refuses two ranks on one device), under a time limit; the
   parent hands them the edges and the search bounds through a temporary
   directory. Each solves with ``DistSolver(plan=MeshPlan(pod=2),
   batch_width=4)`` over its edge slab (98,609,647 edges, odd: one padded,
   masked edge, gathered inside the step direction with the slab's mask).
   Fails unless the
   Solution is FEASIBLE within 1.5*eps of the exact maximum, max Mx <=
   1 + 1e-9 on the host, both ranks return the same x (sha256), status,
   bound and iterations, and each rank launched the search and the step
   direction once a lane iteration, the axpy three times and no lone
   gather. Prints each rank's time to solution, rounds, lane iterations,
   peak memory, and, from one more feasibility solve at the certified
   bound, its device ms a lane iteration (its own kernels), the
   all_reduce's ms a lane iteration (host clock, the device drained
   first) and its host reads a loop iteration. The two ranks share one
   card, so none of it is a speed-up figure.
9. mixtral-8x22b's forward (arXiv:2401.04088) at full width: d_model
   6144, 48 query heads over 8 kv heads of d 128, a 4,096-key window,
   8 experts of d_ff 16384, top-2, vocab 32768, ``attn_impl="pallas"``,
   bf16 compute over f32 params from a seeded random init (depth cut from
   56 to 4 layers, ~42 GB), on B 1 x S 6144 tokens (past the window) at
   one dispatch group: capacity 1,920, a routing LP of 49,152 variables,
   49,160 packing and 6,145 covering rows. The same weights run with the
   ``topk`` router and with the ``mwu`` router, whose LP each layer solves
   with the port's MWU kernels (16 Newton iterations). For each router:
   ms a forward (median of 5), tokens/s, the idle share, a profile split
   (matmuls, flash, the router's kernels, dispatch/combine by CUDA events,
   weight casts, the rest), the router's ms a layer (CUDA events), MWU
   iterations and host reads a layer, each layer's expert load (max over
   mean) and dropped tokens; the router alone on layer 0's logits,
   profiled (its kernels, its plain ops, the device's idle time); the
   router's kernels at its shapes (softmax over 49,160 and 6,145 rows, the
   step direction's g form, the Newton search, the three axpys; f32, the
   LP's first iteration) against their plain versions, with device ms and
   bounds (``router_rows``; the kernels line's ``router`` field). Fails
   unless: (a) every layer's routing LP on the card matches the same LP
   on the CPU (the plain versions), in f64 over the whole budget (x within
   1e-4, the same iterations, probes and status, the same routes on every
   token whose k-th/(k+1)-th margin exceeds 1e-4; near ties printed) and,
   in f32, the forward's own LP over its first three iterations (x within
   1e-4, the same probes): over the whole budget the f32 LP is decided by
   rounding (``ROUTER_F32_ITERS``), and is printed; (b) ``moe_apply`` on
   layer 0's input at capacity_factor = E, in f32 with TF32 off, matches
   a per-expert loop on the card within 2e-4, with either router; (c)
   layer 0's logits as two dispatch groups give two lanes that each equal
   their own G 1 solve bit for bit; (d) each forward repeats bit for bit
   (sha256 of the hidden states); (e) the topk forward is within relative
   L2 5e-2 of the chunked-attention forward of the same module given the
   flash forward's routes (a router decision is discrete: routing freely,
   bf16 rounding moves near-tie tokens to other experts, whose count a
   layer is printed with that relative L2); (f) one forward launches
   flash attention once a layer, and the router's kernels once (search,
   step direction), twice (softmax) and three times (axpy) a router lane
   iteration, nothing else; and the mwu forward reads the host at most
   its routing loops' iterations + 2 times a layer.
10. mixtral-8x22b decode on phase 9's module (its 4 layers at full width,
   the same weights). (a) ``prefill`` of B 1 x S 6144 (past the 4,096-key
   window), then 16 greedy ``decode_step``s, in f32 with TF32 off and the
   topk router at capacity_factor = E (no token dropped at T 1 or T
   6,160, as tests/test_layers.py:58-61): every layer's ring holds
   positions 2,048-6,143 after the prefill and each step writes one slot,
   (S + t) mod 4096; the last step's logits within relative L2 1e-3 of the
   last row of a ``forward`` + ``logits`` over the 6,160 tokens, the
   tokens routed differently a layer printed; the prefill and the forward
   launch flash (its f32 body) once a layer, the decode steps never. Prints the f32 prefill's ms and
   ms a decode step, and the bf16 prefill's (phase 9's config, median of
   3). (b) ``Engine`` (``slots=4``, ``max_len=512``, greedy, bf16) with
   each router on the same weights: four prompts of 24, 40, 56 and 64
   tokens from ``--seed``, 32 new tokens each (95 decode steps: 64
   teacher-forced, 31 sampled). Prints decode ms a step (median, CUDA
   events around each step of the first engine run) and tokens/s (B over
   it), the generate's wall and its generated tokens/s; one decode step
   (the 16th generated, in a hand loop) profiled: weight casts, expert
   matmuls (the einsums' bmm over an expert weight), attention over the
   cache (the kernels inside the cache write and ``_sdpa_dense``, a
   profiler range around each), the router's kernels, the rest, and the
   idle share against that step's own time (CUDA events around it; fails
   if the parts overlap: the rest below 0); for mwu the router's ms a layer a
   step (CUDA events), its iterations and host reads a layer a step, each
   layer's expert load, and the tokens it routed otherwise than top-k
   would on the same logits. Fails unless two engine runs give the same tokens and the same
   sha256 of the last logits, the tokens equal the hand loop of
   ``decode_step`` + argmax from the same empty caches, no step launches
   flash, the mwu steps launch the router's kernels as phase 9 (f) counts
   them a router lane iteration (topk: none), and a generate reads the
   host at most the routing loops' iterations + 2 times a layer a step
   plus once a sampled step.
11. Training on the card (``repro_torch.train``). (a) mixtral-8x22b at full
   width cut to TRAIN_LAYERS layer (2.907B f32 params; params, grads and
   both AdamW moments 46.5 GB), bf16 compute, ``remat="full"``, the
   config's chunked attention, B 1 x S 4,096 (train_4k's sequence; its
   global batch 256 cut to 1) from the token pipeline, ``loss_chunk`` 512,
   AdamW (TRAIN_OPT); ``topk`` then ``mwu`` on the same seeded weights,
   one model at a time. Per router: the first step's loss equals
   ``chunked_ce_loss`` of the batch under ``inference_mode`` (rel 1e-6);
   the router runs in the forward and again in the recompute, and the
   step's launches are the router's kernels for those LP solves (mwu:
   search and step direction once, softmax twice, axpy three times a lane
   iteration; topk: none), the recompute's LP equal to the forward's bit
   for bit, every layer's forward LP held card vs CPU as phase 9 (a) holds
   it in f64 over the whole budget (solved apart in f32, printed: at these
   logits rounding parts the f32 search at its first iteration), and its
   f32 solve again over the whole budget with every kernel call held
   against its plain version on the call's own inputs
   (``router_f32_held``); TRAIN_STEPS steps on the batch drive the loss
   below the first step's (every loss printed), finite; one step at B 2 in
   two microbatches has the mean of its halves' losses (rel 1e-6); the
   launch counts are reset after every check's own solves, and each
   counted block's launches equal its training LPs' lane iterations; the first
   step again from a new model of the same seed gives the same loss, grad
   norm and sha256 of every parameter. Prints ms a step (CUDA events,
   median of the steps after the first) and tokens/s, the peak memory
   beside the dry run's reckoning (``reckoned``), host reads a step, a
   profiled step's split (weight casts, expert bmm, attention, the router's
   kernels and the router's span, the vocab side: CE and the embedding,
   the optimizer, the rest) and idle share against that step's own time,
   and the tokens mwu routes to other experts than topk. (b) ``Trainer``
   on mixtral-8x22b-mwu reduced(), TRAINER_STEPS steps with a checkpoint
   every TRAINER_EVERY, against the run interrupted after TRAINER_STOP and
   restarted from its checkpoint: the final parameters bit for bit.
12. The ssm block kind and the vision_text modality, bf16 over f32 params
   unless a check says f32 (then with TF32 off). (a) mamba2-1.3b at full
   width and depth (48 layers, 1.34B random params, nothing cut), B 1 x S
   32,768 (prefill_32k's sequence, its batch of 32 cut to 1): ms a forward
   (median of 5), tokens/s, the SSD's share (CUDA events around each
   ``_ssd_chunked``), a profiled split (the SSD's intra-chunk dual, chunk
   states, scan across chunks and state read-out, the conv, the norms,
   matmuls, weight casts, the rest) and the idle share against the profiled
   run's own time; layer 0's ``_ssd_chunked`` on the forward's own inputs
   against a sequential f64 recurrence, relative L2 SSD_LOOP_BAR. (b)
   decode on (a)'s model at B 128 (decode_32k's batch) after a prompt of 512
   (a step's work and state, 2 MB a sequence a layer, do not depend on the
   context's length, so the 32,768-token context is cut to 512): ms a step
   over 32 greedy steps (CUDA events), tokens/s, the SSD step's share, a
   profiled step; B 1 steps (long_500k's per-step cost: its 524,288-token
   prefill does not fit the reference's algorithm in one call); f32 at B 4,
   the prefill and 16 steps against the forward's last row (relative L2
   DECODE_BAR); ``Engine.generate`` at 4 slots. (c) mamba2-1.3b training at
   full width and depth, B 1 x S 4,096 (train_4k's global batch of 256 cut
   to 1), remat full, AdamW: ms a step (median of 7), tokens/s, the peak
   beside the dry run's reckoning; the first step repeats bit for bit from a
   new model of the same seed, and the loss falls. (d) internvl2-26b at full
   width, 48 layers cut to VLM_LAYERS (the whole model, 79.4 GB of f32
   params, does not fit), flash attention: a forward over 1,024 patches and
   31,744 tokens (prefill_32k's sequence, batch cut to 1), ms, tokens/s and
   a profiled split, against the same module's chunked forward (relative L2
   5e-2), flash once a layer; prefill of B 4 x (1,024 patches + 512 tokens)
   and 32 text-only steps (ms a step, tokens/s), and in f32 the prefill and
   8 steps against the forward (relative L2 DECODE_BAR). (e) internvl2-26b
   cut to VLM_TRAIN_LAYERS layers, B 1 x S 4,096 (1,024 patches, 3,072
   tokens, loss_mask 0 over the patches), chunked attention (flash has no
   backward): ms a step, tokens/s, peak beside its reckoning, the first
   step bit for bit again. No kernel of the port but flash runs in phase 12.
13. The dry run held against the card (``dryrun_phase``), the card's name
   and power limit on its first line. (a) ``launch.dryrun``'s cells of the
   configs phases 9-12 run (mixtral-8x22b and -mwu, mamba2-1.3b,
   internvl2-26b) at every shape on (16, 16) and (2, 16, 16), and the MWU
   cell on both, in DRYRUN_WORKERS spawned processes on the host (meta
   tensors over a fake process group of 512 ranks): each ``ok`` or the
   reference's skip reason, a line each (per-device GB, TFLOP, the three
   roofline terms, the bottleneck). (b) The dry run's count (``run_cell`` on
   a (1, 1) mesh, ``reckoned``) of phase 9's topk forward, phase 11's topk
   training step, phase 12's forwards (a), (d) and training steps (c), (e),
   against the op counter (``utils.opcount``) around one more of the same
   run on the card: FLOPs and HBM bytes within COUNT_REL; the reckoned
   peaks of phase 11 (both routers) and 12 (c), (e) within PEAK_REL of
   their ``max_memory_allocated`` less what was allocated before the
   model. (c) Each run's roofline lower bound (``roofline_terms``) against
   its phase's own measured ms: a share over 1 fails; the MFU and its bound
   are printed. The phase prints its seconds.

The line before the last is ``{"kernels": [...]}``, one entry per kernel;
the last is ``{"ok": true, "device": {...}}``. The flash entry takes row
(a) in bf16 and the launches of both phase 5 forwards, and row (d) in bf16
with phase 5 (b)'s and (c)'s launches under ``recurrentgemma``, row (c) with phase 9's and
phase 10's bf16 launches under ``mixtral``, row (c) f32 with phase 10 (a)'s f32
launches under ``mixtral_f32``, row (e) with phase 12 (d)'s launches (its
forward, bf16 prefill, f32 prefill and forward) under ``internvl2``; the
axpy and the searches take
the row of the form the main path launches (device step, step form), and
each MWU kernel's masked row goes into its entry's ``masked`` field. Every
entry's launches add phase 6's (``serving_launches``), phase 8's, (a)'s
and both ranks' of (b) (``dist_launches``), phase 9's two forwards'
and phase 10's runs (``moe_launches``), and every train step of phase 11
(``train_launches``); the MWU kernels the router launches carry its rows at
its shapes under ``router``. The script exits non-zero
without a result when no CUDA device is present or when it is run outside
the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# peak rates: f32 and f64 outside the tensor cores, bf16 and TF32 on them
# (dense; NVIDIA H100 SXM data sheet). The f32 flash kernel multiplies on
# the TF32 tensor cores, three times a product (3xTF32): its bound is 3x its
# flops over the "tf32" rate.
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12, torch.bfloat16: 989e12, "tf32": 495e12}
LOGITS_REL_L2_BAR = 5e-2  # pallas vs dense (a) / chunked (b) forward of phase 5, bf16 through 48 / 38 layers
SCAN_BAR = 1e-4  # phase 5 (b): rglru_apply vs its decode loop at f32 (tests/test_layers.py: 2e-4)
SCAN_LOOP_BAR = 1e-5  # phase 5 (b): _scan vs a sequential f64 loop, a in (0.9, 0.999), S 8192 (~1e-7 on the CPU)
RG_DECODE_STEPS = 8  # phase 5 (c): decode steps after the prefill of phase 5 (b)'s tokens
# bf16 flash rows, whole tensor: ||kernel - plain|| / ||plain||. The two
# differ by where p is rounded to bf16 (unnormalised in the kernel, after
# the division in the plain version): ~3e-3 at every bf16 row. The bar is
# twice that, so a fault of 1% (a few unmasked keys in a row of 1,500)
# fails it; the elementwise bar alone lets such a fault through.
FLASH_REL_L2_BAR = 6e-3
EPS = 0.1
# the form of a kernel that the main path launches, where a kernel has two
# rows in phase 2 (its kernels-line entry takes that row); the "masked"
# rows of phase 6's forms go into the entry's "masked" field (the row at
# phase 6's bucket where a form has rows at two shapes)
MAIN_FORM = {"axpy_reduce": "device step", "newton_search": "step", "binary_search": "step"}
MASKED_FORM = {"softmax_weights": "masked", "linesearch_probe": "masked", "newton_search": "step masked",
               "binary_search": "step masked", "axpy_reduce": "masked", "incidence_scatter": "masked",
               "incidence_gather": "masked", "step_direction": "masked"}
# phase 7: iteration caps of the comparison studies (cuts: the reference's
# bench_convergence.py runs 6,000 iterations, MWUOptions' default cap is
# 5,000). The std rule, whose iterations are alike (alpha 1, no search),
# is cut further to keep the phase short: it reaches neither the bound nor
# eps within any of these caps.
TABLE3_STD_CAP = 500
FIG3_CAP = 2_000
FIG3_STD_CAP = 500
FIG3_EPS = 0.05
# phase 6: graph-LP serving, request i on erdos(n, m, seed=i) of tier i % 3,
# match and vcover alternating; both buckets have 4,194,304 edge slots
SERVE_TIERS = [(600_000, 2_200_000), (800_000, 3_000_000), (1_500_000, 4_000_000)]
SERVE_BUCKET = (1 << 20, 1 << 22)  # tiers 0 and 1


class SmokeFailure(RuntimeError):
    pass


def sha256(t) -> str:
    """sha256 of a tensor's or an array's bytes, to compare two trees' bits."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def served_digest(sols) -> str:
    """sha256 over served Solutions' x bytes and objective bits, in order: to
    compare two trees' served answers bit for bit (tools/serve_bits.py)."""
    h = hashlib.sha256()
    for sol in sols:
        h.update(np.ascontiguousarray(sol.x if sol.x is not None else np.zeros(0)).tobytes())
        h.update(np.float64(sol.objective).tobytes())
    return h.hexdigest()


def check(failures: list, ok: bool, what: str) -> None:
    print(("  ok    " if ok else "  FAIL  ") + what, flush=True)
    if not ok:
        failures.append(what)


def end_phase(name: str, failures: list) -> None:
    if failures:
        raise SmokeFailure(f"phase {name} failed: {failures}")


def _events_ms(run, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, reps: int) -> float:
    """Mean time of back-to-back eager calls of fn() from CUDA events, after a
    warm-up call: for short vectors this is the host's cost of a call."""
    fn()
    torch.cuda.synchronize()
    return _events_ms(fn, reps)


def device_ms(fn, reps: int) -> float:
    """Mean device time of fn(): one call captured in a CUDA graph, the graph
    replayed back to back between CUDA events, so no host cost is counted."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, reps)


def host_ms(fn, reps: int = 20) -> float:
    """Mean host-clock time of fn() after a warm-up call: for loops that
    read the card back between launches."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


@contextlib.contextmanager
def counted_reads():
    """Count the host's reads of CUDA tensors' values (``item``,
    ``tolist``, ``float``, ``cpu``, ``numpy``) while active: yields a
    one-element list that holds the count."""
    reads, active = [0], [False]
    saved = {name: getattr(torch.Tensor, name) for name in ("item", "tolist", "__float__", "cpu", "numpy")}

    def counting(method):
        def read(t, *a, **k):
            if t.is_cuda and not active[0]:
                reads[0] += 1
            active[0], outer = True, active[0]
            try:
                return method(t, *a, **k)
            finally:
                active[0] = outer
        return read

    for name, method in saved.items():
        setattr(torch.Tensor, name, counting(method))
    try:
        yield reads
    finally:
        for name, method in saved.items():
            setattr(torch.Tensor, name, method)


def counted_on_card(fn) -> dict:
    """The op counts (``repro_torch.utils.opcount``) of one ``fn()`` on the
    card: what phase 13 (b) holds the dry run's count of the same run to."""
    from repro_torch.utils.opcount import OpCounter

    with OpCounter() as c:
        fn()
    torch.cuda.synchronize()
    return c.report.as_dict()


def reckoned(cfg, B: int, S: int, step: str) -> dict:
    """The dry run's record of a phase's run (``launch.dryrun.run_cell`` on a
    (1, 1) mesh, on meta): ``step`` ("forward", "train") of ``cfg`` at B x S."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun

    return dryrun.run_cell(cfg, ShapeCell(f"{step} {B}x{S}", S, B, step), "one card", mesh={"data": 1, "model": 1})


def bound(nbytes: int, ops: int, rate) -> tuple[float, str]:
    """Least time (ms) for the bytes over HBM's rate or the ops over the
    peak of ``rate`` (a key of PEAK_OPS_PER_S), the larger, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[rate]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# -- phase 2 -----------------------------------------------------------------
def scatter_inputs(n_vertices: int, n_items: int, n_edges: int, seed: int = 0) -> tuple:
    """The scatter's edges at the bmatch graph's shape: users ascending, items
    of the Zipf popularity of graphs/generators.py (item = n_items / rank,
    rank = U^-2 at zipf_a 1.5: item 0 holds ~E / sqrt(n_items) entries);
    u, v int32 on the card from a generator seeded with ``seed``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_users = n_vertices - n_items
    u = torch.randint(0, n_users, (n_edges,), generator=gen, device=dev, dtype=torch.int32).sort().values
    v = n_users + torch.clamp((n_items * torch.rand(n_edges, generator=gen, device=dev, dtype=torch.float64) ** 2)
                              .to(torch.int32), max=n_items - 1)
    return u, v


def scatter_x(n_edges: int, dtype, seed: int = 1) -> torch.Tensor:
    """The scatter's x: n_edges values in [0, 1) on the card, seeded."""
    dev = torch.device("cuda")
    return torch.rand(n_edges, generator=torch.Generator(device=dev).manual_seed(seed), device=dev, dtype=dtype)


def serving_scatter_op():
    """The match operator of phase 6's request 4 (tier 1: erdos(800_000,
    3_000_000, seed=4)) as the engine serves it: padded by ``pad_problem``
    onto the bucket V1048576xE4194304, its padded edges masked."""
    from repro_torch.graphs import build, erdos
    from repro_torch.lpserve import BucketSpec, pad_problem

    return pad_problem(build("match", erdos(*SERVE_TIERS[1], seed=4), device="cuda"), BucketSpec(*SERVE_BUCKET)).P


def sparse_matrix(sides, dtype) -> torch.Tensor:
    """The rows x cols ``torch.sparse_csr_tensor`` (int32 indices) of the
    segments' entries, all sides together: ``torch.mv`` over it (cuSPARSE)
    is the one PyTorch call that computes the same product. A yardstick,
    which the port never calls."""
    rows, cols, vals = [], [], []
    for s in sides:
        q = torch.arange(s.slabs * s.span, device=s.offsets.device)
        rows.append(s.lo + torch.repeat_interleave(q, s.offsets[1:] - s.offsets[:-1], output_size=s.nnz) % s.span)
        cols.append(torch.arange(s.nnz, dtype=torch.int32, device=q.device) if s.src is None else s.src)
        vals.append(torch.ones(s.nnz, dtype=dtype, device=q.device) if s.wt is None else s.wt.to(dtype))
    r, order = torch.sort(torch.cat(rows), stable=True)
    n = sides[0].rows
    crow = torch.searchsorted(r, torch.arange(n + 1, device=r.device)).to(torch.int32)
    return torch.sparse_csr_tensor(crow, torch.cat(cols)[order], torch.cat(vals)[order], size=(n, sides[0].cols),
                                   check_invariants=False)


def kernel_rows(K, refs, n_vertices: int, n_items: int, n_edges: int, dtype, eta: float,
                failures: list) -> list[dict]:
    """Each kernel vs its plain version at the main path's shapes in ``dtype``."""
    from repro_torch.core.mwu import make_eta
    from repro_torch.core.operators import Incidence
    from repro_torch.kernels.incidence_scatter import MERGE_TILE, segments

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    size = torch.finfo(dtype).bits // 8
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    rows = []

    def row(name, shape, err, bar, ok, kernel, plain, reps, nbytes, ops, library=None, form=None):
        b_ms, b_by = bound(nbytes, ops, dtype)
        r = dict(name=name, form=form, dtype=str(dtype).removeprefix("torch."), shape=shape, max_abs_err=err, bar=bar,
                 within_bar=ok,
                 ms=device_ms(kernel, reps), plain_ms=device_ms(plain, reps), bound_ms=b_ms, bound_by=b_by,
                 library_ms=None if library is None else call_ms(library, reps),
                 call_ms=call_ms(kernel, reps), plain_call_ms=call_ms(plain, reps))
        check(failures, ok, f"{name}{'' if form is None else f' ({form})'} {r['dtype']} {shape}: max_abs_err "
                            f"{err:.3g} (bar {bar}); device ms: kernel "
                            f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library {r['library_ms']}, bound "
                            f"{b_ms:.4f} ({b_by}); per eager call: kernel {r['call_ms']:.4f}, plain "
                            f"{r['plain_call_ms']:.4f}")
        rows.append(r)

    # incidence gather at E edges over n vertices, laid out as the bmatch
    # graph's edges are: users ascending, each rating a random item
    E, n = n_edges, n_vertices
    u = torch.randint(0, n - n_items, (E,), generator=gen, device=dev, dtype=torch.int32).sort().values
    v = torch.randint(n - n_items, n, (E,), generator=gen, device=dev, dtype=torch.int32)
    w = torch.rand(n, generator=gen, device=dev, dtype=dtype)
    # every form: plain (bmatch's), masked (an edge slab's padded edge off,
    # as phase 8 (b)'s slabs), weighted, masked and weighted
    slab_mask = torch.ones(E, dtype=torch.bool, device=dev)
    slab_mask[-1] = False
    weights = (torch.rand(E, generator=gen, device=dev, dtype=torch.float64) + 0.5).to(dtype)
    gather_rows(K, row, refs, failures, u, v, w, n, dtype, tol, slab_mask, weights)
    del slab_mask, weights

    # the step direction with its max, g gathered from w (bmatch's source):
    # d bit-equal to the plain eager chain, max(d) exact; the read source on
    # the same g too
    h = torch.rand(E, generator=gen, device=dev, dtype=dtype) * 2.0
    x = torch.rand(E, generator=gen, device=dev, dtype=dtype)
    scale = float(torch.tensor(1.0 / eta, dtype=dtype))  # bmatch is pure packing
    d, dmax = K.step_direction(h, x, scale, gather=(u, v, w))
    d_r, dmax_r = refs["step_direction"](h, x, scale, gather=(u, v, w))
    d2, dmax2 = K.step_direction(h, x, scale, g=refs["incidence_gather"](u, v, w))
    same = torch.equal(d, d_r) and torch.equal(d2, d_r) and dmax.item() == dmax_r.item() == dmax2.item()
    err = (d - d_r).abs().max().item()
    positive = (d > 0).float().mean().item()
    del d, d_r, d2
    check(failures, same, f"step_direction {dtype} [{E}, {n}]: d bit-equal to the plain chain in both sources, "
                          f"max(d) {dmax.item():.6g} exact ({positive:.1%} of d > 0)")
    row("step_direction", [E, n], err, 0.0, same, lambda: K.step_direction(h, x, scale, gather=(u, v, w)),
        lambda: refs["step_direction"](h, x, scale, gather=(u, v, w)), 10, E * (4 + 4 + 3 * size) + n * size, 6 * E)
    del h, x, w
    torch.cuda.empty_cache()

    # the scatter M x at the bmatch graph's shape with the items' Zipf
    # popularity (scatter_inputs: item 0 holds ~740k entries). The v side as
    # the operator builds it (cut into slabs of x) and in one piece (no
    # slabs: one segment of hundreds of merge tiles); in both many CSR rows
    # cross merge-tile edges. Its library time is cuSPARSE's CSR product;
    # the two index_add_ calls the kernel replaced are printed beside it
    del u, v
    u, v = scatter_inputs(n, n_items, E)
    op = Incidence(u=u, v=v, n_vertices=n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, b = op.csr
    order = op.scatter_order
    torch.cuda.synchronize()
    t_csr = time.perf_counter() - t0
    whole = segments(v, n, E, slab_cols=E)

    def crossing(s) -> int:  # CSR rows whose merge items span two tiles or more
        q = torch.arange(s.offsets.shape[0] - 1, device=dev)
        return int(((q + s.offsets[:-1]) // MERGE_TILE != (q + s.offsets[1:]) // MERGE_TILE).sum())

    longest = int((whole.offsets[1:] - whole.offsets[:-1]).max())
    cross = [crossing(s) for s in (a, b, whole)]
    check(failures, longest >= 2**18 and min(cross[1:]) > 0 and a.src is None and b.slabs > 1,
          f"scatter segments: u side sorted (no permutation: {a.src is None}); v side in {b.slabs} slabs of rows "
          f"[{b.lo}, {b.lo + b.span}); longest segment in one piece {longest} entries (>= 2^18); CSR rows across "
          f"merge tiles (u, v, v in one piece) {cross}; CSR {(a.nbytes + b.nbytes) / 1e6:.1f} MB and the "
          f"dispatch order of {a.tiles} + {b.tiles} tiles built in {t_csr:.2f} s")
    x = scatter_x(E, dtype)
    got, again = K.incidence_scatter(x, a, b, order=order), K.incidence_scatter(x, a, b, order=order)
    ref = refs["incidence_scatter"](x, a, b)
    same = torch.equal(got, again)
    err = ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    side_major = K.incidence_scatter(x, a, b, order=torch.arange(a.tiles + b.tiles, dtype=torch.int32, device=dev))
    check(failures, torch.equal(side_major, got), f"incidence_scatter {dtype}: the side-major and the interleaved "
                                                  f"dispatch orders give the same bits")
    if dtype == torch.float64:
        print(f"sha256 scatter f64 [{E}, {n}]: {sha256(got)}", flush=True)
    one, one_again = K.incidence_scatter(x, a, whole), K.incidence_scatter(x, a, whole)
    one_err = ((one - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    check(failures, torch.equal(one, one_again) and one_err <= tol,
          f"incidence_scatter {dtype}, v side in one piece: two launches bitwise equal, {one_err:.3g} from the "
          f"plain version (relative; bar {tol})")
    del one, one_again, whole, side_major
    mat = sparse_matrix((a, b), dtype)
    lib, lib_again = torch.mv(mat, x), torch.mv(mat, x)
    lib_err = ((lib - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    print(f"  cuSPARSE torch.mv {dtype} [{E}, {n}]: two calls bit-equal: {torch.equal(lib, lib_again)}", flush=True)
    check(failures, lib_err <= tol, f"cuSPARSE torch.mv M x agrees with the plain version ({lib_err:.3g}, relative)")
    del lib, lib_again
    add_err = ((torch.zeros(n, dtype=dtype, device=dev).index_add_(0, u, x).index_add_(0, v, x) - ref).abs()
               / ref.abs().clamp(min=1.0)).max().item()
    del got, again, ref
    check(failures, same, f"incidence_scatter {dtype} [{E}, {n}]: two launches bitwise equal")
    check(failures, add_err <= tol, f"index_add_ M x agrees with the plain version ({add_err:.3g}, relative)")
    row("incidence_scatter", [E, n], err, tol, err <= tol and same, lambda: K.incidence_scatter(x, a, b, order=order),
        lambda: refs["incidence_scatter"](x, a, b), 10, E * (size + 4) + 2 * (n + 1) * 8 + n * size, 2 * E,
        lambda: torch.mv(mat, x))
    rows[-1]["index_add_ms"] = call_ms(lambda: torch.zeros(n, dtype=dtype, device=dev).index_add_(0, u, x)
                                       .index_add_(0, v, x), 10)
    print(f"  incidence_scatter {dtype} [{E}, {n}]: cuSPARSE {rows[-1]['library_ms']:.4f} ms, index_add_ x2 "
          f"{rows[-1]['index_add_ms']:.4f} ms (eager calls)", flush=True)
    del u, v, x, op, a, b, order, mat
    torch.cuda.empty_cache()

    # softmax weights on the packing side (n) and the one-row objective side
    # (1); the two-sided probe at the solve's shape, both sides in one launch
    reps = 200
    for m in (n, 1):
        y = torch.rand(m, generator=gen, device=dev, dtype=dtype) * 1.1
        lse, wk = K.softmax_weights(y, eta, 1.0)
        lse2, wk2 = K.softmax_weights(y, eta, 1.0)
        lse_r, w_r = refs["softmax_weights"](y, eta, 1.0)
        lse_err = abs(lse.item() - lse_r.item())
        err = max(lse_err, (wk - w_r).abs().max().item())
        ok = lse_err <= tol * max(1.0, abs(lse_r.item())) and (wk - w_r).abs().max().item() <= tol
        same = torch.equal(wk, wk2) and lse.item() == lse2.item()
        check(failures, same, f"softmax_weights {dtype} [{m}]: two launches bitwise equal")
        row("softmax_weights", [m], err, tol, ok and same, lambda: K.softmax_weights(y, eta, 1.0),
            lambda: refs["softmax_weights"](y, eta, 1.0), reps, 2 * m * size, 7 * m)
        del y

    y, dy = (torch.rand(n, generator=gen, device=dev, dtype=dtype) * s for s in (1.1, 1e-3))
    z, dz = (torch.rand(1, generator=gen, device=dev, dtype=dtype) * s for s in (1.1, 1e-3))
    got, again = (K.linesearch_probe2(y, dy, z, dz, 7.5, eta) for _ in range(2))
    ref = refs["linesearch_probe2"](y, dy, z, dz, 7.5, eta)
    err = (got - ref).abs().max().item()
    ok = err <= tol * max(1.0, ref.abs().max().item()) and got[2].item() == ref[2].item() and got[5].item() == ref[5].item()
    same = torch.equal(got, again)
    check(failures, same, f"linesearch_probe {dtype} [{n}, 1]: two launches bitwise equal")
    row("linesearch_probe", [n, 1], err, tol, ok and same, lambda: K.linesearch_probe2(y, dy, z, dz, 7.5, eta),
        lambda: refs["linesearch_probe2"](y, dy, z, dz, 7.5, eta), reps, 2 * (n + 1) * size, 9 * (n + 1))
    del y, dy, z, dz
    rows += search_rows(K, n, dtype, eta, failures)
    rows += binary_rows(K, n, dtype, eta, failures)

    # fused update at E (the x update)
    y = torch.rand(E, generator=gen, device=dev, dtype=dtype)
    dy = torch.rand(E, generator=gen, device=dev, dtype=dtype)
    out, mn, mx = K.axpy_reduce(y, dy, 3.25)
    out_r, mn_r, mx_r = refs["axpy_reduce"](y, dy, 3.25)
    err = max((out - out_r).abs().max().item(), abs(mn.item() - mn_r.item()), abs(mx.item() - mx_r.item()))
    del out, out_r
    row("axpy_reduce", [E], err, min(tol, 1e-6), err <= min(tol, 1e-6), lambda: K.axpy_reduce(y, dy, 3.25),
        lambda: refs["axpy_reduce"](y, dy, 3.25), 10, 3 * E * size, 4 * E, form="host alpha")
    # the device-step form, as the MWU loop runs it: the step read from
    # device memory, [min, max] into a float64 slot; bit for bit the
    # host-float form and the plain version, into another tensor and in place
    step, red = torch.tensor([3.25], dtype=torch.float64, device=dev), torch.empty(2, dtype=torch.float64, device=dev)
    buf = torch.empty_like(y)
    out, mn, mx = K.axpy_reduce(y, dy, 3.25)
    out_r = refs["axpy_reduce"](y, dy, step)[0]
    got, gmn, gmx = K.axpy_reduce(y, dy, step, out=buf, red=red)
    same = torch.equal(got, out) and torch.equal(got, out_r) and (gmn.item(), gmx.item()) == (mn.item(), mx.item())
    inplace = y.clone()
    K.axpy_reduce(inplace, dy, step, out=inplace)
    same = same and torch.equal(inplace, out)
    err = (got - out_r).abs().max().item()
    del out, out_r, inplace
    check(failures, same, f"axpy_reduce {dtype} [{E}], device step: bit-equal to the host-float form and the plain "
                          f"version, in place too; [min, max] into the record slot")
    # the plain version reads the step as a host float (a read would stop
    # the CUDA graph the time is taken from): the same arithmetic
    row("axpy_reduce", [E], err, 0.0, same, lambda: K.axpy_reduce(y, dy, step, out=buf, red=red),
        lambda: refs["axpy_reduce"](y, dy, 3.25), 10, 3 * E * size, 4 * E, form="device step")
    del y, dy, buf
    torch.cuda.empty_cache()

    # the masked forms, at phase 6's bucket V1048576xE4194304 with tier 1's
    # real rows first (800k vertices, 3M edges), as pad_problem lays them
    # out: softmax over the vertex rows, the two-sided probe over both, the
    # search at a served match request's shape (the vertex rows masked, the
    # objective row not), the z update's min and max over the edge rows
    V, Eb = SERVE_BUCKET
    kv = torch.arange(V, device=dev) < SERVE_TIERS[1][0]
    ke = torch.arange(Eb, device=dev) < SERVE_TIERS[1][1]
    eta_b = float(make_eta(V + 1, EPS))
    y = torch.rand(V, generator=gen, device=dev, dtype=dtype) * 1.1
    lse, wk = K.softmax_weights(y, eta_b, 1.0, keep=kv)
    lse_r, w_r = refs["softmax_weights"](y, eta_b, 1.0, keep=kv)
    lse_err, w_err = abs(lse.item() - lse_r.item()), (wk - w_r).abs().max().item()
    ok = lse_err <= tol * max(1.0, abs(lse_r.item())) and w_err <= tol and not wk[~kv].any()
    row("softmax_weights", [V], max(lse_err, w_err), tol, ok, lambda: K.softmax_weights(y, eta_b, 1.0, keep=kv),
        lambda: refs["softmax_weights"](y, eta_b, 1.0, keep=kv), reps, 2 * V * size + V, 7 * V, form="masked")
    dy = torch.rand(V, generator=gen, device=dev, dtype=dtype) * 1e-3
    z, dz = (torch.rand(Eb, generator=gen, device=dev, dtype=dtype) * s for s in (1.1, 1e-3))
    got = K.linesearch_probe2(y, dy, z, dz, 7.5, eta_b, p_keep=kv, c_keep=ke)
    ref = refs["linesearch_probe2"](y, dy, z, dz, 7.5, eta_b, kv, ke)
    err = (got - ref).abs().max().item()
    ok = err <= tol * max(1.0, ref.abs().max().item()) and got[2].item() == ref[2].item() and \
        got[5].item() == ref[5].item()
    row("linesearch_probe", [V, Eb], err, tol, ok, lambda: K.linesearch_probe2(y, dy, z, dz, 7.5, eta_b, p_keep=kv,
                                                                               c_keep=ke),
        lambda: refs["linesearch_probe2"](y, dy, z, dz, 7.5, eta_b, kv, ke), reps, (2 * size + 1) * (V + Eb),
        9 * (V + Eb), form="masked")
    del y, dy
    rows += search_rows(K, V, dtype, eta_b, failures, p_keep=kv)
    rows += binary_rows(K, V, dtype, eta_b, failures, p_keep=kv)
    # the bucket's covering side, as a served vcover lane searches it: the
    # objective row and the 4,194,304 edge slots, tier 1's 3M kept (more
    # tiles a block than the plan holds in shared memory: the streamed path)
    eta_c = float(make_eta(1 + Eb, EPS))
    rows += search_rows(K, 1, dtype, eta_c, failures, m=Eb, c_keep=ke)
    rows += binary_rows(K, 1, dtype, eta_c, failures, m=Eb, c_keep=ke)
    red = torch.empty(2, dtype=torch.float64, device=dev)
    step = torch.tensor([3.25], dtype=torch.float64, device=dev)
    out, mn, mx = K.axpy_reduce(z, dz, step, red=red, keep=ke)
    out_r, mn_r, mx_r = refs["axpy_reduce"](z, dz, 3.25, keep=ke)
    same = torch.equal(out, out_r) and (mn.item(), mx.item()) == (mn_r.item(), mx_r.item())
    check(failures, same, f"axpy_reduce masked {dtype} [{Eb}]: the update bit-equal to the plain version's over every "
                          f"row, [min, max] {[mn.item(), mx.item()]} over the kept rows exact")
    row("axpy_reduce", [Eb], (out - out_r).abs().max().item(), 0.0, same,
        lambda: K.axpy_reduce(z, dz, step, out=z, red=red, keep=ke), lambda: refs["axpy_reduce"](z, dz, 3.25, keep=ke),
        10, 3 * Eb * size + Eb, 4 * Eb, form="masked")
    del z, dz, out, out_r
    torch.cuda.empty_cache()

    # the scatter at the same bucket: the match operator of tier 1's request,
    # padded (3M of its 4,194,304 edge slots kept); x fits the L2
    op = serving_scatter_op()
    a, b = op.csr
    x = scatter_x(Eb, dtype)
    got, again = (K.incidence_scatter(x, a, b, order=op.scatter_order) for _ in range(2))
    ref = refs["incidence_scatter"](x, a, b)
    err = ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    same = torch.equal(got, again)
    mat = sparse_matrix((a, b), dtype)
    lib, lib_again = torch.mv(mat, x), torch.mv(mat, x)
    lib_err = ((lib - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    check(failures, same and lib_err <= tol, f"incidence_scatter masked {dtype} [{Eb}, {V}], {a.nnz} edges kept: two "
                                             f"launches bitwise equal; cuSPARSE {lib_err:.3g} from the plain version "
                                             f"(relative), two calls bit-equal: {torch.equal(lib, lib_again)}")
    del got, again, ref, lib, lib_again
    nnz = a.nnz + b.nnz  # the kept entries: x, each side's permutation, offsets, out
    row("incidence_scatter", [Eb, V], err, tol, err <= tol and same,
        lambda: K.incidence_scatter(x, a, b, order=op.scatter_order), lambda: refs["incidence_scatter"](x, a, b), 10,
        a.nnz * size + 4 * nnz + 2 * (V + 1) * 8 + V * size, nnz, lambda: torch.mv(mat, x), form="masked")
    del a, b, x, mat
    # the gather at the same bucket, over the padded operator's edges, in
    # every form: "masked" as a served vcover lane's covering product runs
    # it (its padded edges off), weighted, masked and weighted, and plain
    u, v, mask = op.u, op.v, op.edge_mask
    w = torch.rand(V, generator=gen, device=dev, dtype=dtype)
    weights = (torch.rand(Eb, generator=gen, device=dev, dtype=torch.float64) + 0.5).to(dtype)
    gather_rows(K, row, refs, failures, u, v, w, V, dtype, tol, mask, weights)
    # the step direction of a served match lane: the gather with its edge
    # mask inside the pass (no lone gather, ones, where or multiply); d bit
    # for bit the plain chain, max(d) exact
    h = torch.rand(Eb, generator=gen, device=dev, dtype=dtype) * 2.0
    x = torch.rand(Eb, generator=gen, device=dev, dtype=dtype)
    scale = float(torch.tensor(1.0 / eta_b, dtype=dtype))
    gather = (u, v, w, mask, None)
    d, dmax = K.step_direction(h, x, scale, gather=gather)
    d_r, dmax_r = refs["step_direction"](h, x, scale, gather=gather)
    same = torch.equal(d, d_r) and dmax.item() == dmax_r.item()
    check(failures, same, f"step_direction masked {dtype} [{Eb}, {V}]: d bit-equal to the plain chain (gather, "
                          f"ones, where, multiply, ratio), max(d) {dmax.item():.6g} exact")
    row("step_direction", [Eb, V], (d - d_r).abs().max().item(), 0.0, same,
        lambda: K.step_direction(h, x, scale, gather=gather), lambda: refs["step_direction"](h, x, scale, gather=gather),
        reps, Eb * (4 + 4 + 1 + 3 * size) + V * size, 7 * Eb, form="masked")
    del op, u, v, w, mask, weights, h, x, d, d_r
    torch.cuda.empty_cache()
    return rows


def gather_rows(K, row, refs, failures: list, u, v, w, n: int, dtype, tol: float, mask, weights) -> None:
    """The gather's rows over edges (u, v) and w of n values in every form:
    plain, "masked" (the edge factor's mask), "weighted" and "masked
    weighted", each bit for bit its plain version, beside cuSPARSE's M^T w
    over the CSR of the E x n transposed incidence (its entries the edge
    factor), a yardstick the port never calls."""
    from repro_torch.kernels.incidence_gather.ref import edge_factor

    dev, E = w.device, u.shape[0]
    size = torch.finfo(dtype).bits // 8
    reps = 10 if E > 10_000_000 else 200
    crow = torch.arange(0, 2 * E + 1, 2, device=dev, dtype=torch.int32)
    cols = torch.stack([u, v], dim=1).reshape(-1)
    for form, m, wt in ((None, None, None), ("masked", mask, None), ("weighted", None, weights),
                        ("masked weighted", mask, weights)):
        got = K.incidence_gather(u, v, w, m, wt)
        want = refs["incidence_gather"](u, v, w, m, wt)
        same = torch.equal(got, want)
        err = (got - want).abs().max().item()
        f = edge_factor(E, dtype, dev, m, wt)
        mt = torch.sparse_csr_tensor(crow, cols, f.repeat_interleave(2), size=(E, n), check_invariants=False)
        lib_err = ((torch.mv(mt, w) - got).abs() / got.abs().clamp(min=1.0)).max().item()
        check(failures, lib_err <= tol, f"sparse M^T w ({form or 'plain'}) agrees with the gather ({lib_err:.3g}, "
                                        f"relative)")
        nbytes = E * (4 + 4 + size + (m is not None) + size * (wt is not None)) + n * size
        row("incidence_gather", [E, n], err, 0.0, same, lambda: K.incidence_gather(u, v, w, m, wt),
            lambda: refs["incidence_gather"](u, v, w, m, wt), reps, nbytes, E, lambda: torch.mv(mt, w), form=form)
        del got, want, f, mt



def plan_text(plan: dict) -> str:
    return f"{plan['path']} ({plan['gy']} + {plan['gz']} blocks, at most {plan['tiles']} tiles a block)"


def search_state(n: int, kind: str, seed: int, dtype, m: int = 1) -> list:
    """A mid-solve MWU state (tests/test_torch_stepsize.py's _state) with n
    packing rows and m covering rows: bmatch's n vertex rows and its one
    objective row (m = 1), or vcover's objective row and its m edge rows
    (n = 1): y, z, dy, dz."""
    rng = np.random.default_rng(seed)
    y, dy, dz = rng.random(n) * 0.3, rng.random(n) * 1e-3, rng.random(m) * 4e-3 + 1e-4
    z = {"far": rng.random(m) * 0.3, "near": 1.0 - dz * rng.uniform(0.5, 3.0, m),
         "done": 1.0 - dz * rng.uniform(0.2, 0.9, m), "below": rng.random(m) * 0.3}[kind]
    if kind == "below":  # a packing step 300x as large: f(1) < 1, the search backs off below 1
        dy = dy * 300.0
    return [torch.from_numpy(t).to(dtype).cuda() for t in (y, z, dy, dz)]


def search_rows(K, n: int, dtype, eta: float, failures: list, p_keep=None, m: int = 1, c_keep=None) -> list[dict]:
    """The Newton search kernel on seeded n + m states (its packing rows
    masked by ``p_keep`` when given, as a served match request's padded
    vertex rows are: the rows' "masked" forms; its covering rows by
    ``c_keep``, as a served vcover request's padded edge rows are: the
    "masked cover" forms, whose m rows the plan streams). Each timed row
    prints the kernel's plan (``search_plan``: shared memory or streamed) and
    its ms a sweep on a line of its own. Against the host loop
    over the probe kernel (stepsize._newton_step_host): alpha bit for bit,
    probes and completes equal. Against its plain version, the same loop
    over plain PyTorch probes on the card (ref.newton_search_ref), whose
    probes differ from the kernel's by rounding: completes equal and alpha
    within ls_eps * alpha, the search's own resolution. The row times the
    "far" state from a cold start (alpha0 1, as the solve's first
    iteration): ms a search (one launch replayed from a CUDA graph), its
    probes, and ms a probe counting the alpha = 0 sweep; the plain version
    and the host loop over the probe kernel are timed a search on the host
    clock (their probes read back one by one).

    Then the step form, as the MWU loop launches it (max(d) and the warm
    start alpha_prev read from device memory, the record [alpha, probes,
    completes, step, bad] written there), on the three states and a
    "below" one whose alpha < 1, at max(d) > 0 and max(d) = 0: alpha,
    probes and completes bit for bit the host loop's; step, bad and
    alpha_prev as the MWU iteration decides them; against its plain
    version (ref.newton_step_ref) bad and completes equal and alpha within
    ls_eps * alpha. Its row times the "far" state at max(d) = 0, so that
    alpha_prev stays and every replay runs the same search."""
    import struct

    from repro_torch.core import stepsize
    from repro_torch.kernels.linesearch_probe.ops import search_plan
    from repro_torch.kernels.linesearch_probe.ref import newton_search_ref, newton_step_ref

    size = torch.finfo(dtype).bits // 8
    masked = " masked cover" if c_keep is not None else "" if p_keep is None else " masked"
    mask_bytes = (0 if p_keep is None else n) + (0 if c_keep is None else m)
    plan = search_plan(n, m, dtype)
    for kind, alpha0 in (("far", 1.0), ("near", 37.0), ("done", None)):
        y, z, dy, dz = search_state(n, kind, 1, dtype, m)
        host = stepsize._newton_step_host(y, z, dy, dz, eta, p_keep, c_keep, ls_eps=EPS, alpha0=alpha0)
        dev = stepsize.newton_step(y, z, dy, dz, eta, p_keep, c_keep, ls_eps=EPS, alpha0=alpha0)
        p_alpha, p_probes, p_completes = newton_search_ref(y, dy, z, dz, eta, EPS, alpha0, p_keep, c_keep).tolist()
        same = (struct.pack("d", dev.alpha), dev.probes, dev.completes) == \
            (struct.pack("d", host.alpha), host.probes, host.completes)
        bar = EPS * max(dev.alpha, p_alpha)
        near = dev.completes == bool(p_completes) and abs(dev.alpha - p_alpha) <= bar
        check(failures, same, f"newton_search{masked} {dtype} [{n}, {m}] {kind}, alpha0 {alpha0}: card {tuple(dev)} | "
                              f"host loop {tuple(host)}")
        check(failures, near, f"newton_search{masked} {dtype} [{n}, {m}] {kind}, alpha0 {alpha0}: plain search "
                              f"({p_alpha!r}, {int(p_probes)}, {bool(p_completes)}), |alpha - plain| "
                              f"{abs(dev.alpha - p_alpha):.3g} (bar {bar:.3g})")
        if kind == "far":
            timed, err, probes, ok, far_bar = (y, z, dy, dz, alpha0), abs(dev.alpha - p_alpha), dev.probes, \
                same and near, bar
    y, z, dy, dz, alpha0 = timed
    ms = device_ms(lambda: K.newton_search(y, dy, z, dz, eta, EPS, alpha0, p_keep=p_keep, c_keep=c_keep), 50)
    plain_ms = host_ms(lambda: newton_search_ref(y, dy, z, dz, eta, EPS, alpha0, p_keep, c_keep).tolist())
    loop_ms = host_ms(lambda: stepsize._newton_step_host(y, z, dy, dz, eta, p_keep, c_keep, ls_eps=EPS, alpha0=alpha0))
    call = call_ms(lambda: stepsize.newton_step(y, z, dy, dz, eta, p_keep, c_keep, ls_eps=EPS, alpha0=alpha0), 50)
    # bound: the inputs (and the mask) read once; operations of every sweep the search took
    b_ms, b_by = bound(2 * (n + m) * size + mask_bytes, 9 * (n + m) * (probes + 1), dtype)
    r = dict(name="newton_search", dtype=str(dtype).removeprefix("torch."), shape=[n, m], max_abs_err=err,
             bar=far_bar, within_bar=ok, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
             call_ms=call, plain_call_ms=plain_ms, host_loop_ms=loop_ms, probes=probes,
             ms_per_probe=ms / (probes + 1), ms_per_sweep=ms / (probes + 1), path=plan["path"])
    print(f"  newton_search{masked} {r['dtype']} [{n}, {m}]: path {plan_text(plan)}; {probes + 1} sweeps, "
          f"{r['ms_per_sweep']:.5f} ms a sweep", flush=True)
    check(failures, ok, f"newton_search{masked} {r['dtype']} [{n}, {m}]: {probes} probes; device ms a search {ms:.4f} "
                        f"({r['ms_per_probe']:.4f} a probe with the alpha = 0 sweep), bound {b_ms:.4f} ({b_by}); "
                        f"host clock ms a search: plain {plain_ms:.4f}, host loop over the probe kernel "
                        f"{loop_ms:.4f}, newton_step with its read {call:.4f}")

    def bits(v: float) -> bytes:
        return struct.pack("d", v)

    dev = torch.device("cuda")
    step_ok, step_err = True, 0.0
    for kind, alpha0 in (("far", 1.0), ("near", 37.0), ("done", 1.0), ("below", 1.0)):
        y, z, dy, dz = search_state(n, kind, 1, dtype, m)
        host = stepsize._newton_step_host(y, z, dy, dz, eta, p_keep, c_keep, ls_eps=EPS, alpha0=alpha0)
        for d_max in (1e-3, 0.0):
            dm = torch.tensor(d_max, dtype=dtype, device=dev)
            ap, ap_p = (torch.tensor([alpha0], dtype=torch.float64, device=dev) for _ in range(2))
            rec = stepsize.newton_step_record(y, z, dy, dz, eta, EPS, dm, ap, p_mask=p_keep, c_mask=c_keep).tolist()
            plain = newton_step_ref(y, dy, z, dz, eta, EPS, dm, ap_p, p_keep, c_keep).tolist()
            bad = d_max <= 0 or host.alpha < 1
            same = (bits(rec[0]), int(rec[1]), bool(rec[2])) == (bits(host.alpha), host.probes, host.completes) \
                and bool(rec[4]) == bad and bits(rec[3]) == bits(0.0 if bad else host.alpha) \
                and bits(ap.item()) == bits(alpha0 if bad else host.alpha)
            near = (rec[2], rec[4]) == (plain[2], plain[4]) and abs(rec[0] - plain[0]) <= EPS * max(rec[0], plain[0])
            check(failures, same and near and (kind != "below" or host.alpha < 1),
                  f"newton_search{masked} step form {dtype} [{n}, {m}] {kind}, alpha_prev {alpha0}, max(d) {d_max}: "
                  f"record "
                  f"{rec} | host loop {tuple(host)}, bad {bad}; plain {plain}")
            step_ok = step_ok and same and near
            step_err = max(step_err, abs(rec[0] - plain[0]))
    y, z, dy, dz = search_state(n, "far", 1, dtype, m)
    dm0, ap, out = (torch.zeros((), dtype=dtype, device=dev), torch.ones(1, dtype=torch.float64, device=dev),
                    torch.empty(5, dtype=torch.float64, device=dev))
    def search():
        return K.newton_search(y, dy, z, dz, eta, EPS, ap, d_max=dm0, out=out, p_keep=p_keep, c_keep=c_keep)

    probes = int(search()[1].item())
    ms = device_ms(search, 50)
    plain_ms = host_ms(lambda: newton_step_ref(y, dy, z, dz, eta, EPS, dm0, ap, p_keep, c_keep).tolist())
    b_ms, b_by = bound(2 * (n + m) * size + mask_bytes, 9 * (n + m) * (probes + 1), dtype)
    s = dict(r, form="step" + masked, max_abs_err=step_err, within_bar=step_ok, ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by, call_ms=call_ms(search, 50), plain_call_ms=plain_ms, probes=probes,
             ms_per_probe=ms / (probes + 1), ms_per_sweep=ms / (probes + 1))
    print(f"  newton_search{masked} step form {s['dtype']} [{n}, {m}]: path {plan_text(plan)}; {probes + 1} sweeps, "
          f"{s['ms_per_sweep']:.5f} ms a sweep", flush=True)
    check(failures, step_ok, f"newton_search{masked} step form {s['dtype']} [{n}, {m}]: {probes} probes; device ms a "
                             f"search {ms:.4f}, bound {b_ms:.4f} ({b_by}); plain {plain_ms:.4f} (host clock); eager "
                             f"call {s['call_ms']:.4f}")
    return [dict(r, form="host alpha0" + masked), s]


def binary_rows(K, n: int, dtype, eta: float, failures: list, p_keep=None, m: int = 1, c_keep=None) -> list[dict]:
    """The binary search kernel (Alg. 3 in one launch) on the seeded n + m
    states of ``search_rows`` (its packing rows masked by ``p_keep`` when
    given: the row's "masked" form; its covering rows by ``c_keep``: "masked
    cover"), its plan and ms a sweep printed as there. In both forms against the host loop
    over the probe kernel (stepsize._binary_search_step_host): alpha,
    probes and completes bit for bit; the step form (max(d) and the warm
    start alpha_prev read from device memory, the record [alpha, probes,
    completes, step, bad] written there) at max(d) > 0 and = 0, with step,
    bad and alpha_prev as the MWU iteration decides them. Against its plain
    version (ref.binary_step_ref, the same loop over plain PyTorch probes):
    completes and bad equal and alpha within ls_eps * alpha where alpha >=
    1 (a step the loop takes; far below 1, as on the "below" state, whose
    alpha < 1 is checked, f32 probes are rounding noise). The row is the step form, as the MWU loop
    launches it, timed on the "far" state from a cold start at max(d) = 0
    (alpha_prev stays, so every replay runs the same search): ms a search
    (one launch replayed from a CUDA graph), its probes, ms a sweep (the
    probes, the alpha = 0 sweep and the completion test's sweep); its plain
    version on the host clock."""
    import struct

    from repro_torch.core import stepsize
    from repro_torch.kernels.linesearch_probe.ops import search_plan
    from repro_torch.kernels.linesearch_probe.ref import binary_step_ref

    def bits(v: float) -> bytes:
        return struct.pack("d", v)

    dev = torch.device("cuda")
    size = torch.finfo(dtype).bits // 8
    masked = " masked cover" if c_keep is not None else "" if p_keep is None else " masked"
    plan = search_plan(n, m, dtype)
    ok, err = True, 0.0
    for kind, alpha0 in (("far", 1.0), ("near", 37.0), ("done", 1.0), ("below", 1.0)):
        y, z, dy, dz = search_state(n, kind, 1, dtype, m)
        host = stepsize._binary_search_step_host(y, z, dy, dz, eta, p_keep, c_keep, ls_eps=EPS, alpha0=alpha0)
        lone = stepsize.binary_search_step(y, z, dy, dz, eta, p_keep, c_keep, ls_eps=EPS, alpha0=alpha0)
        same = (bits(lone.alpha), lone.probes, lone.completes) == (bits(host.alpha), host.probes, host.completes)
        for d_max in (1e-3, 0.0):
            dm = torch.tensor(d_max, dtype=dtype, device=dev)
            ap, ap_p = (torch.tensor([alpha0], dtype=torch.float64, device=dev) for _ in range(2))
            rec = stepsize.binary_step_record(y, z, dy, dz, eta, EPS, dm, ap, p_mask=p_keep, c_mask=c_keep).tolist()
            plain = binary_step_ref(y, dy, z, dz, eta, EPS, dm, ap_p, p_keep, c_keep).tolist()
            bad = d_max <= 0 or host.alpha < 1
            same = same and (bits(rec[0]), int(rec[1]), bool(rec[2])) == \
                (bits(host.alpha), host.probes, host.completes) and bool(rec[4]) == bad \
                and bits(rec[3]) == bits(0.0 if bad else host.alpha) and bits(ap.item()) == bits(alpha0 if bad else
                                                                                                 host.alpha)
            near = host.alpha < 1 if kind == "below" else host.alpha < 1 or \
                (rec[2], rec[4]) == (plain[2], plain[4]) and abs(rec[0] - plain[0]) <= EPS * max(rec[0], plain[0])
            check(failures, same and near,
                  f"binary_search{masked} {dtype} [{n}, {m}] {kind}, alpha_prev {alpha0}, max(d) {d_max}: "
                  f"record {rec} | "
                  f"host loop {tuple(host)}, bad {bad}; one-call form {tuple(lone)}; plain {plain}")
            ok = ok and same and near
            if host.alpha >= 1:
                err = max(err, abs(rec[0] - plain[0]))
    y, z, dy, dz = search_state(n, "far", 1, dtype, m)
    dm0, ap, out = (torch.zeros((), dtype=dtype, device=dev), torch.ones(1, dtype=torch.float64, device=dev),
                    torch.empty(5, dtype=torch.float64, device=dev))

    def search():
        return K.binary_search(y, dy, z, dz, eta, EPS, ap, d_max=dm0, out=out, p_keep=p_keep, c_keep=c_keep)

    probes = int(search()[1].item())
    ms = device_ms(search, 50)
    plain_ms = host_ms(lambda: binary_step_ref(y, dy, z, dz, eta, EPS, dm0, ap, p_keep, c_keep).tolist())
    loop_ms = host_ms(lambda: stepsize._binary_search_step_host(y, z, dy, dz, eta, p_keep, c_keep, ls_eps=EPS,
                                                                alpha0=1.0))
    # bound: the inputs (and the mask) read once; the operations of every sweep the search took
    b_ms, b_by = bound(2 * (n + m) * size + (0 if p_keep is None else n) + (0 if c_keep is None else m),
                       9 * (n + m) * (probes + 2), dtype)
    r = dict(name="binary_search", form="step" + masked, dtype=str(dtype).removeprefix("torch."), shape=[n, m],
             max_abs_err=err, bar=EPS, within_bar=ok, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=None, call_ms=call_ms(search, 50), plain_call_ms=plain_ms, host_loop_ms=loop_ms,
             probes=probes, ms_per_sweep=ms / (probes + 2), path=plan["path"])
    print(f"  binary_search{masked} step form {r['dtype']} [{n}, {m}]: path {plan_text(plan)}; {probes + 2} sweeps, "
          f"{r['ms_per_sweep']:.5f} ms a sweep", flush=True)
    check(failures, ok, f"binary_search{masked} step form {r['dtype']} [{n}, {m}]: {probes} probes; device ms a search "
                        f"{ms:.4f} ({r['ms_per_sweep']:.4f} a sweep, {probes + 2} sweeps), bound {b_ms:.4f} ({b_by}); "
                        f"host clock ms a search: plain {plain_ms:.4f}, host loop over the probe kernel {loop_ms:.4f}; "
                        f"eager call {r['call_ms']:.4f}")
    return [r]


FLASH_CASES = [  # tag, B, S, Hq, Hkv, d, causal, window, dtype
    ("a", 16, 1500, 16, 16, 80, False, None, torch.bfloat16),  # hubert-xlarge
    ("a", 16, 1500, 16, 16, 80, False, None, torch.float32),
    ("b", 1, 4096, 24, 8, 128, True, None, torch.bfloat16),  # minitron-4b at train_4k
    ("b", 1, 4096, 24, 8, 128, True, None, torch.float32),
    ("c", 1, 6144, 48, 8, 128, True, 4096, torch.bfloat16),  # mixtral-8x22b, sliding window
    ("c", 1, 6144, 48, 8, 128, True, 4096, torch.float32),  # phase 10 (a)'s f32 prefill
    ("d", 2, 8192, 16, 1, 256, True, 2048, torch.bfloat16),  # recurrentgemma-9b at phase 5 (b)'s batch
    ("d", 2, 8192, 16, 1, 256, True, 2048, torch.float32),
    ("e", 1, 32768, 48, 8, 128, True, None, torch.bfloat16),  # internvl2-26b at phase 12 (d)'s forward
]
PLAIN_SCORES_BYTES = 8e9  # above this many bytes of f32 scores the plain version runs a query head at a time


def flash_ptxas(failures: list) -> None:
    """The flash kernels' ptxas lines (registers, spills, shared memory) from
    the loaded build's compiler log, one block per body and head dim; no
    spills at the models' head dims, 80 and 128, in either body, nor at 256
    in the bf16 body (the f32 body's d 256 is printed and may spill)."""
    import re

    from repro_torch.kernels import loader

    blocks, current = {}, None
    for line in loader.build_log().read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"flash_(bf16|f32)_kernelILi(\d+)E", line)
            current = f"flash_{m.group(1)}_kernel<{m.group(2)}>" if m else None
            if current is not None:
                blocks[current] = []
        elif current is not None and ("registers" in line or "spill" in line or "smem" in line):
            blocks[current].append(line.strip())
    for name in sorted(blocks):
        print(f"  ptxas, {name}: " + " | ".join(blocks[name]), flush=True)
    for body, dims in (("bf16", (80, 128, 256)), ("f32", (80, 128))):
        for d in dims:
            name = f"flash_{body}_kernel<{d}>"
            spills = [int(n) for line in blocks.get(name, []) for n in re.findall(r"(\d+) bytes spill", line)]
            check(failures, bool(spills) and not any(spills),
                  f"{name}: no spills in ptxas's report ({spills or 'no report'})")


def tail_fault_rel_l2(q, k, v, block_k: int, ref) -> float:
    """Relative L2, against ``ref``, of the output that a bidirectional
    kernel would give if the zero-filled keys past S in its last key tile
    scored 0 instead of being masked: what the whole-tensor bar must catch."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    S = q.shape[1]
    q, k, v = (F.pad(t, (0, 0, 0, 0, 0, -S % block_k)) for t in (q, k, v))
    fault = flash_attention_plain(q, k, v, causal=False)[:, :S].float()
    return ((fault - ref).norm() / ref.norm()).item()


def flash_rows(K, card: str, failures: list) -> list[dict]:
    """Flash attention vs its plain version at published widths; ``card`` is
    nvidia-smi's name and power limit, printed beside each f32 row."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import bf16_config, scored_pairs
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    flash_ptxas(failures)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for tag, B, S, Hq, Hkv, d, causal, window, dtype in FLASH_CASES:
        q = torch.randn(B, S, Hq, d, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, S, Hkv, d, generator=gen, device=dev).to(dtype) for _ in range(2))
        bar = 3e-5 if dtype == torch.float32 else 2e-2

        def kernel():
            return K.flash_attention(q, k, v, causal=causal, window=window)

        def plain():
            if B * Hq * S * S * 4 <= PLAIN_SCORES_BYTES:
                return flash_attention_plain(q, k, v, causal=causal, window=window)
            # (e): the scores of all 48 heads would take 206 GB; the same function a query head at a time
            g = Hq // Hkv
            return torch.cat([flash_attention_plain(q[:, :, h:h + 1], k[:, :, h // g:h // g + 1],
                                                    v[:, :, h // g:h // g + 1], causal=causal, window=window)
                              for h in range(Hq)], dim=2)

        mask = None
        if window is not None:
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

        def library():
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                  attn_mask=mask, is_causal=causal and mask is None,
                                                  enable_gqa=Hq != Hkv).transpose(1, 2)

        config = bf16_config(d) if dtype == torch.bfloat16 else None
        got, ref = kernel().float(), plain().float()
        diff = (got - ref).abs()
        err = diff.max().item()
        rel = (diff.norm() / ref.norm()).item()
        ok = bool((diff <= bar * (1 + ref.abs())).all())
        lib_diff = (library().float() - ref).abs()
        lib_ok = bool((lib_diff <= bar * (1 + ref.abs())).all())
        if config is not None:
            rel_ok = rel <= FLASH_REL_L2_BAR
            check(failures, rel_ok, f"flash_attention ({tag}) bfloat16: relative L2 vs plain {rel:.4g} "
                                    f"(bar {FLASH_REL_L2_BAR})")
            ok = ok and rel_ok
            if not causal and window is None and S % config["block_k"]:
                fault = tail_fault_rel_l2(q, k, v, config["block_k"], ref)
                check(failures, fault > FLASH_REL_L2_BAR,
                      f"flash_attention ({tag}): unmasked zero keys past S would give relative L2 {fault:.4g}, "
                      f"beyond the bar {FLASH_REL_L2_BAR}")
        del got, ref, diff, lib_diff
        size = torch.finfo(dtype).bits // 8
        flops = 4 * B * Hq * d * scored_pairs(S, causal, window)
        nbytes = 2 * B * S * (Hq + Hkv) * d * size
        f32 = dtype == torch.float32  # the f32 kernel's 3xTF32: 3x the flops on the TF32 tensor cores
        b_ms, b_by = bound(nbytes, 3 * flops, "tf32") if f32 else bound(nbytes, flops, dtype)
        plain_ms = call_ms(plain, 3 if B * Hq * S * S * 4 <= PLAIN_SCORES_BYTES else 1)
        r = dict(name="flash_attention", case=tag, dtype=str(dtype).removeprefix("torch."),
                 shape=[B, S, Hq, Hkv, d], causal=causal, window=window, max_abs_err=err, bar=bar, within_bar=ok,
                 rel_l2=rel, ms=device_ms(kernel, 20), plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=device_ms(library, 20), call_ms=call_ms(kernel, 20), plain_call_ms=plain_ms,
                 config=config)
        r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
        r["library_tflops"] = flops / (r["library_ms"] * 1e-3) / 1e12
        check(failures, ok, f"flash_attention ({tag}) {r['dtype']} B {B} S {S} heads {Hq}/{Hkv} d {d} causal {causal} "
                            f"window {window}: max_abs_err {err:.3g} (bar {bar}), relative L2 {rel:.3g}; "
                            f"device ms: kernel {r['ms']:.4f} "
                            f"({r['tflops']:.1f} TFLOP/s), plain {plain_ms:.4f}, SDPA {r['library_ms']:.4f} "
                            f"({r['library_tflops']:.1f} TFLOP/s, within bar: {lib_ok}), bound {b_ms:.4f} ({b_by}), "
                            f"{b_ms / r['ms']:.0%} of bound; eager call {r['call_ms']:.4f}; tiles {r['config']}")
        if f32:
            fma_ms, _ = bound(nbytes, flops, dtype)  # the same flops once at f32 FMA
            print(f"  f32 ({tag}) on {card}: kernel {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s), SDPA f32 "
                  f"{r['library_ms']:.4f} ms; bound {b_ms:.4f} ms at 3xTF32 (3 x {flops:.4g} flops over "
                  f"{PEAK_OPS_PER_S['tf32'] / 1e12:.0f} TFLOP/s, {b_ms / r['ms']:.0%} of it), {fma_ms:.4f} ms at "
                  f"f32 FMA ({PEAK_OPS_PER_S[dtype] / 1e12:.0f} TFLOP/s, {fma_ms / r['ms']:.0%})", flush=True)
        elif tag in ("d", "e"):
            print(f"  bf16 ({tag}) on {card}: kernel {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s), SDPA "
                  f"{r['library_ms']:.4f} ms; bound {b_ms:.4f} ms ({flops:.4g} flops over "
                  f"{PEAK_OPS_PER_S[dtype] / 1e12:.0f} TFLOP/s, {b_ms / r['ms']:.0%} of it); tiles {config}",
                  flush=True)
        rows.append(r)
        del q, k, v, mask
        torch.cuda.empty_cache()
    return rows


# -- phase 3 -----------------------------------------------------------------
def round_solver(opts, batch_width: int = 4, base=None, **kwargs):
    """A Solver (or a subclass ``base`` of it, built with ``kwargs``) that
    keeps, for each search round, its bounds, its lanes' iterations and its
    wall time, and the first batched round's result."""
    from repro_torch.api import Solver

    class RoundSolver(Solver if base is None else base):
        def __init__(self):
            super().__init__(opts, batch_width=batch_width, **kwargs)
            self.rounds, self.first_batch = [], None

        def solve_batch(self, problem, bounds, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = super().solve_batch(problem, bounds, **kw)
            torch.cuda.synchronize()
            self.rounds.append(dict(bounds=[float(b) for b in bounds], iters=res.iters.tolist(),
                                    wall_s=time.perf_counter() - t0))
            if self.first_batch is None:
                self.first_batch = res
            return res

        def feasible(self, problem, bound=None, trace=False):
            res = super().feasible(problem, bound, trace)
            self.rounds.append(dict(bounds=[float(bound)], iters=[res.iters], wall_s=None))
            return res

    return RoundSolver()


def full_solve(n_users: int, failures: list) -> tuple:
    """Phase 3; returns its numbers, the bmatch problem on the card and its
    host graph (phase 7 runs on both)."""
    from repro_torch import kernels as K
    from repro_torch.api import MWUOptions, Solver, Status
    from repro_torch.api.solver import certify_solution
    from repro_torch.graphs import baselines, bipartite_ratings, build

    t0 = time.perf_counter()
    g = bipartite_ratings(n_users, 17_770, avg_ratings=209, seed=0)
    t_graph = time.perf_counter() - t0
    print(f"  graph bipartite_ratings({n_users}, 17770, avg_ratings=209, seed=0): "
          f"{g.n} vertices, {g.m} edges, {t_graph:.1f} s on the host", flush=True)
    t0 = time.perf_counter()
    exact = baselines.hopcroft_karp_bmatch(g)
    t_exact = time.perf_counter() - t0
    t0 = time.perf_counter()
    prob = build("bmatch", g, device="cuda", dtype=torch.float64)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    print(f"  exact maximum matching {exact} ({t_exact:.1f} s); builder with greedy bounds "
          f"[{prob.lo}, {prob.hi}] ({t_build:.1f} s)", flush=True)

    # the scatter's CSR, built once per operator at its first card product
    # and shared by the lanes of a round (they share the operator)
    t0 = time.perf_counter()
    sides = prob.P.csr
    torch.cuda.synchronize()
    t_csr = time.perf_counter() - t0
    print(f"  scatter CSR of M: {sum(s.nbytes for s in sides) / 1e6:.1f} MB (u side "
          f"{sides[0].nbytes / 1e6:.1f} MB, permutation: {sides[0].src is not None}; v side "
          f"{sides[1].nbytes / 1e6:.1f} MB), built in {t_csr:.2f} s", flush=True)
    opts = MWUOptions(eps=EPS, step_rule="newton")
    # the lanes' state beyond one solve's: K - 1 more rows of x (E), y (V) and z (1)
    lane_gb = 3 * (g.m + g.n + 1) * 8 / 1e9
    print(f"  reckoned: 4 lanes hold {lane_gb:.2f} GB of state beyond one solve's (3 more rows of x, y, z); the "
          f"graph and the CSR are shared", flush=True)

    K.reset_launch_counts()
    solver = round_solver(opts)  # keeps round 1's batch (its x rows) for the check below
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solver.solve(prob)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    # round 1's lanes against four sequential solves at full size, bit for bit
    batch, seq = solver.first_batch, Solver(opts)
    for j, b in enumerate(solver.rounds[0]["bounds"] if batch is not None else []):
        res = seq.feasible(prob, b)
        same = (int(batch.status[j]), int(batch.iters[j]), int(batch.ls_probes[j]), float(batch.max_px[j]),
                float(batch.min_cx[j])) == (res.status, res.iters, res.ls_probes, res.max_px, res.min_cx)
        check(failures, same and torch.equal(batch.x[j], res.x),
              f"round 1, lane {j} (bound {b!r}): equal to feasible() bit for bit ({res.iters} iterations, "
              f"{res.ls_probes} probes, {Status.NAMES[res.status]}, x bits equal: {torch.equal(batch.x[j], res.x)})")
        del res
    check(failures, batch is not None, "the search ran a batched round")
    # free the first solve's lane rows, so that the second solve's peak is its own
    solver.first_batch = batch = sol.last_result = None
    torch.cuda.empty_cache()
    # the same solve again, by a plain Solver (its peak memory is the
    # solve's own): the scatter sums in a fixed order, so a card solve
    # repeats bit for bit
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    sol2 = Solver(opts, batch_width=4).solve(prob)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the solve's last step alone: the certificate of its best lane (x and
    # the objective to the host, the rescale and the objective's dot there)
    t0 = time.perf_counter()
    certify_solution(prob, sol2.last_result, sol2.bound, dict(calls=0, iters=0, probes=0))
    t_cert = time.perf_counter() - t0

    rounds = solver.rounds
    loop_iters = sum(max(r["iters"]) for r in rounds)
    loads = np.bincount(g.u, sol.x, g.n) + np.bincount(g.v, sol.x, g.n) if sol.found else np.array([np.inf])
    info = dict(n_vertices=g.n, n_edges=g.m, exact=exact, objective=sol.objective, bound=sol.bound,
                status=Status.NAMES[sol.status], calls=sol.feasibility_calls, iters=sol.mwu_iters_total,
                probes=sol.ls_probes_total, wall_s=wall, ms_per_iter=1e3 * wall / max(sol.mwu_iters_total, 1),
                rounds=len(rounds), lanes_per_round=[len(r["bounds"]) for r in rounds],
                round_loop_iters=[max(r["iters"]) for r in rounds], round_lane_iters=[r["iters"] for r in rounds],
                round_wall_s=[r["wall_s"] for r in rounds], loop_iters=loop_iters,
                ms_per_loop_iter=1e3 * wall / max(loop_iters, 1),
                max_memory_gb=peak_gb, memory_before_gb=base_gb, reckoned_lane_state_gb=lane_gb,
                max_Mx=float(loads.max()), x_sha256=sha256(sol.x) if sol.found else None,
                launches=launches, setup_s=dict(graph=t_graph, exact=t_exact, build=t_build, csr=t_csr),
                csr_mb=sum(s.nbytes for s in sides) / 1e6, certify_s=t_cert,
                rounds_wall_s=sum(r["wall_s"] or 0.0 for r in rounds), second_wall_s=wall2,
                second_ms_per_iter=1e3 * wall2 / max(sol2.mwu_iters_total, 1))
    print("  " + json.dumps(info), flush=True)
    print(f"sha256 bmatch x: {sha256(sol.x)} ({sol.mwu_iters_total} lane iterations, objective {sol.objective!r})",
          flush=True)
    for r in rounds:
        print(f"  round: {len(r['bounds'])} lanes at bounds {[round(b, 3) for b in r['bounds']]}, lane iterations "
              f"{r['iters']} (loop iterations {max(r['iters'])}), {r['wall_s']} s", flush=True)
    for k, sl in enumerate((sol, sol2)):
        check(failures, sl.feasible, f"bmatch solve {k + 1} is FEASIBLE ({Status.NAMES[sl.status]})")
        rel = abs(sl.objective - exact) / exact
        check(failures, rel <= 1.5 * EPS, f"solve {k + 1}: objective {sl.objective!r} within 1.5*eps of exact {exact} "
                                          f"(rel {rel:.4f})")
        loads = np.bincount(g.u, sl.x, g.n) + np.bincount(g.v, sl.x, g.n) if sl.found else np.array([np.inf])
        check(failures, loads.max() <= 1 + 1e-9, f"solve {k + 1}: host-recomputed max(Mx) = {loads.max()!r} <= 1 + 1e-9")
    first = (sol.feasibility_calls, sol.mwu_iters_total, sol.ls_probes_total, sol.objective)
    second = (sol2.feasibility_calls, sol2.mwu_iters_total, sol2.ls_probes_total, sol2.objective)
    same_x = sol.found and sol2.found and np.array_equal(sol.x, sol2.x)
    check(failures, first == second and same_x,
          f"two solves in one call repeat: (calls, iterations, probes, objective) {first} | {second}; x bits equal: "
          f"{same_x}; {wall:.2f} / {wall2:.2f} s")
    check(failures, sum(len(r["bounds"]) for r in rounds) == sol.feasibility_calls
          and all(r["wall_s"] is not None for r in rounds if len(r["bounds"]) > 1),
          f"the search's {sol.feasibility_calls} feasibility calls ran as {len(rounds)} rounds of "
          f"{[len(r['bounds']) for r in rounds]} lanes, every round of more than one through solve_batch")
    for name, count in launches.items():
        if name == "flash_attention":  # the LM plane's kernel, off this path
            check(failures, count == 0, f"{name} launched {count} times in the solve")
        elif name in ("linesearch_probe", "binary_search"):  # probes inside the search; the binary rule: phases 4, 7
            check(failures, count == 0, f"{name} launched {count} times in the solve")
        elif name == "incidence_gather":  # step_direction gathers M^T w itself (phase 4 runs the gather)
            check(failures, count == 0, f"{name} launched {count} times in the solve")
        elif name in ("newton_search", "step_direction"):
            check(failures, count == sol.mwu_iters_total,
                  f"{name} launched {count} times in the solve, once a lane iteration ({sol.mwu_iters_total})")
        elif name == "axpy_reduce":
            check(failures, count == 3 * sol.mwu_iters_total,
                  f"{name} launched {count} times in the solve, 3 a lane iteration ({sol.mwu_iters_total})")
        else:
            check(failures, count > 0, f"{name} launched {count} times in the solve")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
    print(f"  after the solve: sm clock, power draw, power limit, temperature = {smi}", flush=True)

    if sol.found:
        info["profile"] = profile_run(lambda: Solver(opts).feasible(prob, sol.bound), "one feasibility solve at "
                                      "the certified bound", failures)
        info["profile_round"] = profile_run(lambda: Solver(opts).solve_batch(prob, rounds[0]["bounds"]),
                                            "round 1's batch of 4 lanes", failures)
    return info, prob, g


def profile_run(run, what: str, failures: list) -> dict:
    """Where the time of ``run()`` (a feasibility solve or a batch of them)
    goes: the call timed alone, then again under torch.profiler for device
    time by kernel (the two take the same iterations: a card solve
    repeats). Lane iterations are the lanes' iterations summed, loop
    iterations the longest lane's; host reads are the device-to-host
    copies. The profile must show the scatter and step-direction kernels
    and no index_add_ / scatter_add kernel. It traces the device alone:
    every number here comes from device events, and tracing the host's
    operators too slows a long run several times over."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Status

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled = run()
        torch.cuda.synchronize()
    # device-side events only: the operators that launched them carry the
    # same device time again
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    port_ms = sum(k[0] for k in kernels if "rt::" in k[2])
    search = [k for k in kernels if "rt::search_kernel" in k[2]]  # the Newton or the binary search
    search_ms = sum(k[0] for k in search)
    # host reads: the device-to-host copies (.item(), .tolist()) the run made
    reads = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "DtoH" in e.key)
    iters = np.atleast_1d(res.iters)
    lane_iters, loop_iters = int(iters.sum()), int(iters.max())
    out = dict(lanes=len(iters), status=[Status.NAMES[int(s)] for s in np.atleast_1d(res.status)],
               lane_iters=lane_iters, loop_iters=loop_iters, probes=int(np.sum(res.ls_probes)),
               wall_ms=wall_ms, wall_ms_per_lane_iter=wall_ms / max(lane_iters, 1), device_busy_ms=busy_ms,
               device_ms_per_lane_iter=busy_ms / max(lane_iters, 1),
               device_idle_share=1.0 - busy_ms / wall_ms if busy_ms else None,
               port_kernels_ms=port_ms, other_device_ms=busy_ms - port_ms, search_ms=search_ms,
               search_launches=sum(k[1] for k in search), search_share=search_ms / busy_ms if busy_ms else None,
               host_reads=reads,
               host_reads_per_loop_iter=reads / max(loop_iters, 1))
    print(f"  profile of {what}: {json.dumps(out)}", flush=True)
    for ms, count, key in kernels[:20]:
        print(f"    {ms:10.2f} ms {count:7d} x  {key[:110]}", flush=True)
    same = np.array_equal(np.atleast_1d(profiled.iters), iters) and torch.equal(profiled.x, res.x)
    check(failures, same, f"{what}: the timed and the profiled run repeat ({iters.tolist()} / "
                          f"{np.atleast_1d(profiled.iters).tolist()} iterations, x bits equal)")
    check(failures, reads <= loop_iters + 3, f"{what}: {reads} host reads in {loop_iters} loop iterations "
                                             f"({out['host_reads_per_loop_iter']:.3f} a loop iteration)")
    atomic = [k for k in kernels if any(w in k[2] for w in ("indexFunc", "index_add", "scatter_add"))]
    check(failures, not atomic, f"no index_add_ / scatter_add kernel in the profile ({[k[2][:60] for k in atomic]})")
    for name in ("incidence_scatter_kernel", "step_direction_kernel"):
        hit = [k for k in kernels if f"rt::{name}" in k[2]]
        check(failures, bool(hit), f"rt::{name} in the profile: {sum(k[0] for k in hit):.2f} ms, "
                                   f"{sum(k[1] for k in hit)} launches")
    return out


# -- phase 4 -----------------------------------------------------------------
def small_solves(failures: list) -> dict:
    """The six families card vs CPU, and each card solve run twice: the
    second repeats the first bit for bit. Returns the card solves' launches
    (the gather's count in the kernels line: bmatch's Newton solve gathers
    inside the step-direction kernel)."""
    from repro_torch import kernels as K
    from repro_torch.api import MWUOptions, Solver, Status
    from repro_torch.graphs import bipartite_ratings, build, generalized_matching_problem, rgg

    g = rgg(12, seed=0)
    bg = bipartite_ratings(2_000, 500, avg_ratings=10.0, seed=0)
    s, deg = bg.bipartite_split, bg.degrees()
    lb, ub = np.zeros(bg.n), np.ones(bg.n)
    lb[:s] = np.minimum(1, deg[:s])
    ub[:s], ub[s:] = 5, 8
    print(f"  rgg(12, seed=0): {g.n} vertices, {g.m} edges; bipartite_ratings(2000, 500): {bg.m} edges", flush=True)
    opts = MWUOptions(eps=EPS, step_rule="newton")
    launches = {}
    for family in ("match", "bmatch", "vcover", "dom-set", "dense-sub", "gen-match"):
        sols = {}
        for device in ("cuda", "cpu"):
            if family == "gen-match":
                prob = generalized_matching_problem(bg, lb, ub, device=device)
            else:
                prob = build(family, bg if family == "bmatch" else g, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
                K.reset_launch_counts()
            t0 = time.perf_counter()
            sols[device] = Solver(opts).solve(prob)
            sols[device + "_s"] = time.perf_counter() - t0
            if device == "cuda":
                torch.cuda.synchronize()
                for name, count in K.launch_counts().items():
                    launches[name] = launches.get(name, 0) + count
                again = Solver(opts).solve(prob)
                same = (again.mwu_iters_total, again.ls_probes_total) == \
                    (sols["cuda"].mwu_iters_total, sols["cuda"].ls_probes_total) and \
                    np.array_equal(again.x, sols["cuda"].x)
                check(failures, same, f"{family}: a second card solve repeats the first ({again.mwu_iters_total} "
                                      f"iterations, x bits equal)")
        a, b = sols["cuda"], sols["cpu"]
        same = a.status == b.status == Status.FEASIBLE
        if family != "gen-match":
            same = same and abs(a.bound - b.bound) <= 1e-5 * abs(b.bound)
            same = same and abs(a.objective - b.objective) <= 2 * EPS * abs(b.objective)
        check(failures, same, f"{family}: card {Status.NAMES[a.status]} bound {a.bound:.6g} objective "
                              f"{a.objective:.6g} iters {a.mwu_iters_total} ({sols['cuda_s']:.1f} s) | cpu "
                              f"{Status.NAMES[b.status]} bound {b.bound:.6g} objective {b.objective:.6g} iters "
                              f"{b.mwu_iters_total} ({sols['cpu_s']:.1f} s)")
    print(f"  launches of the six card solves: {launches}", flush=True)
    check(failures, launches["incidence_gather"] > 0 and launches["incidence_scatter"] > 0,
          "the six card solves launched the gather and the scatter")
    return launches


def batch_solves(failures: list) -> None:
    """Batched lanes on the card against feasible() on the card, bit for bit:
    four bounds of each of the six families (gen-match has no bound: four
    lanes of one problem), and two stacked match instances, each lane over
    its own operators."""
    from repro_torch.api import MWUOptions, Solver, Status, stack_problems
    from repro_torch.graphs import bipartite_ratings, build, erdos, generalized_matching_problem, rgg

    g, bg = rgg(12, seed=0), bipartite_ratings(2_000, 500, avg_ratings=10.0, seed=0)
    s, deg = bg.bipartite_split, bg.degrees()
    lb, ub = np.zeros(bg.n), np.ones(bg.n)
    lb[:s] = np.minimum(1, deg[:s])
    ub[:s], ub[s:] = 5, 8
    solver = Solver(MWUOptions(eps=EPS, step_rule="newton"))
    cases = []
    for family in ("match", "bmatch", "vcover", "dom-set", "dense-sub", "gen-match"):
        if family == "gen-match":
            prob = generalized_matching_problem(bg, lb, ub, device="cuda")
            cases.append((family, prob, np.ones(4), False, [prob] * 4))
        else:
            prob = build(family, bg if family == "bmatch" else g, device="cuda")
            cases.append((family, prob, np.geomspace(prob.lo, prob.hi, 4), False, [prob] * 4))
    probs = [build("match", erdos(4_096, 40_000, seed=k), device="cuda") for k in (0, 1)]
    cases.append(("stacked match", stack_problems(probs), [p.lo for p in probs], True, probs))
    for family, prob, bounds, stacked, lanes in cases:
        t0 = time.perf_counter()
        batch = solver.solve_batch(prob, bounds, batched_problem=stacked)
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t0
        for j, (p, b) in enumerate(zip(lanes, bounds)):
            res = solver.feasible(p, float(b))
            same = (int(batch.status[j]), int(batch.iters[j]), int(batch.ls_probes[j]), float(batch.max_px[j]),
                    float(batch.min_cx[j])) == (res.status, res.iters, res.ls_probes, res.max_px, res.min_cx)
            check(failures, same and torch.equal(batch.x[j], res.x),
                  f"{family}, lane {j} of {len(lanes)} (bound {float(b):.6g}): equal to feasible() bit for bit "
                  f"({Status.NAMES[res.status]}, {res.iters} iterations, {res.ls_probes} probes); batch {t_batch:.2f} s")


def binary_solves(failures: list) -> dict:
    """The binary step rule, card vs CPU, on match and vcover of rgg(12):
    every lane iteration launches the binary search kernel once (its step
    form, no lone probe), and the loop reads the host once a loop iteration
    for all lanes (the reads, counted, include each round's start and
    finish and the certificate's copies of x and c). Prints each card
    solve's status, iterations, probes and the sha256 of x, to compare the
    bits with another tree (tools/binary_bits.py runs the same solves)."""
    from repro_torch import kernels as K
    from repro_torch.api import MWUOptions, Solver, Status
    from repro_torch.graphs import build, rgg

    g = rgg(12, seed=0)
    opts = MWUOptions(eps=EPS, step_rule="binary")
    families = ("match", "vcover")
    sols = {(f, "cpu"): Solver(opts).solve(build(f, g, device="cpu")) for f in families}
    probs = {f: build(f, g, device="cuda") for f in families}
    solvers = {f: round_solver(opts) for f in families}
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with counted_reads() as reads:
        for family in probs:
            sols[family, "cuda"] = solvers[family].solve(probs[family])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    for family in probs:
        a, b = sols[family, "cuda"], sols[family, "cpu"]
        same = a.status == b.status == Status.FEASIBLE and abs(a.bound - b.bound) <= 1e-5 * abs(b.bound)
        same = same and abs(a.objective - b.objective) <= 2 * EPS * abs(b.objective)
        check(failures, same, f"{family}, binary rule: card {Status.NAMES[a.status]} bound {a.bound:.6g} objective "
                              f"{a.objective:.6g} probes {a.ls_probes_total} | cpu {Status.NAMES[b.status]} bound "
                              f"{b.bound:.6g} objective {b.objective:.6g} probes {b.ls_probes_total}")
        print(f"sha256 binary x {family}: {sha256(a.x)} ({Status.NAMES[a.status]}, {a.feasibility_calls} calls, "
              f"{a.mwu_iters_total} lane iterations, {a.ls_probes_total} probes)", flush=True)
    lane_iters = sum(sols[f, "cuda"].mwu_iters_total for f in probs)
    rounds = [r for f in families for r in solvers[f].rounds]
    loop_iters = sum(max(r["iters"]) for r in rounds)
    probes = sum(sols[f, "cuda"].ls_probes_total for f in probs)
    check(failures, launches["binary_search"] == lane_iters and launches["linesearch_probe"] == 0
          and launches["newton_search"] == 0,
          f"binary-rule solves launched binary_search {launches['binary_search']} times for {lane_iters} lane "
          f"iterations ({probes} probes, {probes / max(lane_iters, 1):.2f} a lane iteration), linesearch_probe "
          f"{launches['linesearch_probe']}, newton_search {launches['newton_search']}")
    print(f"  binary-rule card solves: {reads[0]} host reads in {loop_iters} loop iterations over {len(rounds)} rounds "
          f"({reads[0] / max(loop_iters, 1):.3f} a loop iteration); {wall:.2f} s", flush=True)
    return launches


# -- phase 5 -----------------------------------------------------------------
def _device_kernels(prof) -> list[tuple[float, int, str]]:
    """(device ms, calls, name) of each kernel, device-side events only: the
    operators that launched them carry the same device time again. The
    device-side copies of the script's own profiler ranges (the profiler
    lists a range on the device too, spanning its kernels) are left out."""
    from torch.autograd import DeviceType

    ranges = (ATTENTION_RANGE, ATTN_RANGE, ADAMW_RANGE)
    return sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0 and e.key not in ranges),
                  reverse=True)


def _event_spans(mod, name: str, run) -> list[float]:
    """Device ms of each call of ``mod.<name>`` in one ``run()`` of the model,
    from CUDA events recorded around it on the stream: the calls of the real
    forward, unprofiled. (The profiler attributes kernels to the operators
    of a ``record_function`` range around a call, but it listed more of
    them under each range than one RG-LRU scan launches.)"""
    spans, fn = [], getattr(mod, name)

    def timed(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        spans.append((start, end))
        return out

    setattr(mod, name, timed)
    try:
        run()
    finally:
        setattr(mod, name, fn)
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in spans]


def _weight_cast_ms(prof, model) -> float:
    """Device ms of the dtype casts of ``model``'s parameters: the
    ``aten::_to_copy`` calls on a tensor of a parameter's shape (no
    activation of the forward has one: they are (B, S, ...))."""
    from torch.autograd import DeviceType

    shapes = {repr(list(p.shape)) for p in model.parameters()}
    return sum(e.device_time_total for e in prof.events()
               if e.name == "aten::_to_copy" and e.device_type == DeviceType.CPU and e.input_shapes
               and repr(list(e.input_shapes[0])) in shapes) / 1e3


def encoder_forward(K, failures: list) -> dict:
    """hubert-xlarge's encode forward at full width (phase 5)."""
    from dataclasses import replace

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get
    from repro_torch.models import Model

    cfg = replace(get("hubert-xlarge"), attn_impl="pallas")
    B, S = 16, 1500
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    frames = torch.randn(B, S, cfg.d_model, generator=torch.Generator(device="cuda").manual_seed(1),
                         device="cuda") * 0.02
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of d {cfg.d_head}, "
          f"d_ff {cfg.d_ff}, {n_params / 1e6:.1f}M f32 params, init {init_s:.1f} s; frames {B} x {S}", flush=True)

    def run(m):
        return m.logits(m({"frames": frames}))

    with torch.inference_mode():
        run(model)  # warm-up: cuBLAS handles and heuristics
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = run(model)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = K.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(model)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall_s = float(np.median(walls))

        V = cfg.vocab_size
        finite = bool(torch.isfinite(logits[..., :V]).all())
        pad_ok = bool((logits[..., V:] == -1e30).all())
        dense = Model(replace(cfg, attn_impl="dense"), device="cuda")
        dense.load_state_dict(model.state_dict())
        ref = run(dense)
        del dense
        rel = ((logits[..., :V] - ref[..., :V]).norm() / ref[..., :V].norm()).item()
        del ref
        torch.cuda.empty_cache()

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(model)
            torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    flash_ms = sum(k[0] for k in kernels if "rt::flash" in k[2])
    mm_ms = sum(k[0] for k in kernels if any(w in k[2].lower() for w in ("gemm", "nvjet", "xmma", "cutlass")))
    info = dict(config=cfg.name, batch=B, frames=S, layers=cfg.n_layers, first_forward_s=first_s,
                wall_ms=1e3 * wall_s, wall_ms_runs=[1e3 * w for w in walls], frames_per_s=B * S / wall_s,
                max_memory_gb=peak_gb, launches=launches, logits_shape=list(logits.shape), logits_finite=finite,
                pad_vocab_masked=pad_ok, rel_l2_vs_dense=rel,
                profile=dict(device_busy_ms=busy, flash_ms=flash_ms, matmul_ms=mm_ms, other_ms=busy - flash_ms - mm_ms,
                             device_idle_share=1.0 - busy / (1e3 * wall_s)))
    print("  " + json.dumps(info), flush=True)
    for ms, count, key in kernels[:14]:
        print(f"    {ms:10.2f} ms {count:7d} x  {key[:110]}", flush=True)
    check(failures, launches["flash_attention"] == cfg.n_layers,
          f"flash_attention launched {launches['flash_attention']} times in one forward ({cfg.n_layers} layers)")
    check(failures, all(n == 0 for name, n in launches.items() if name != "flash_attention"),
          f"no MWU kernel launched in the forward ({launches})")
    check(failures, finite and pad_ok and list(logits.shape) == [B, S, cfg.padded_vocab],
          f"logits {list(logits.shape)} finite over the vocab ({finite}), pad slots -1e30 ({pad_ok})")
    check(failures, rel <= LOGITS_REL_L2_BAR,
          f"logits vs the dense-attention forward: relative L2 {rel:.4g} (bar {LOGITS_REL_L2_BAR})")
    return info


def scan_checks(failures: list) -> dict:
    """Phase 5 (b)'s last checks, at recurrentgemma-9b's full width (d_model
    and rnn_width 4096), f32. (1) ``_scan`` at the forward's shape (B 2,
    S 8192) against a sequential f64 loop, with a in U(0.9, 0.999): the
    carry lives for hundreds of steps, so a wrong doubling step or product of
    a shows. (2) ``rglru_apply`` at B 2, S 256 against a loop of
    ``rglru_decode`` steps from an empty state (tests/test_layers.py's
    identity; the init's a is ~0.007, so it holds the block's wiring and
    the decode path, not the carry)."""
    from repro_torch.configs import get
    from repro_torch.models.layers import rglru as rg

    cfg = get("recurrentgemma-9b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    a = 0.9 + 0.099 * torch.rand(2, 8192, cfg.rnn_width, generator=gen, device=dev)
    b = torch.randn(2, 8192, cfg.rnn_width, generator=gen, device=dev)
    with torch.inference_mode():
        h = rg._scan(a, b).double()
        ad, ref, hd = a.double(), torch.empty_like(h), torch.zeros_like(h[:, 0])
        for t in range(a.shape[1]):
            hd = torch.addcmul(b[:, t].double(), ad[:, t], hd)
            ref[:, t] = hd
    diff = (h - ref).abs()
    loop = dict(shape=list(a.shape), max_abs_err=diff.max().item(), rel_l2=((h - ref).norm() / ref.norm()).item(),
                max_abs_h=ref.abs().max().item())
    loop["within_bar"] = loop["rel_l2"] <= SCAN_LOOP_BAR and bool((diff <= SCAN_LOOP_BAR * (1 + ref.abs())).all())
    check(failures, loop["within_bar"],
          f"_scan vs a sequential f64 loop at B 2, S 8192, w {cfg.rnn_width}, a in (0.9, 0.999): relative L2 "
          f"{loop['rel_l2']:.3g}, max_abs_err {loop['max_abs_err']:.3g} at max |h| {loop['max_abs_h']:.3g} "
          f"(bar {SCAN_LOOP_BAR}, relative L2 and elementwise of 1 + |h|)")
    del a, b, h, ad, ref, hd, diff
    torch.cuda.empty_cache()

    p = rg.rglru_init(torch.Generator(device=dev).manual_seed(2), cfg, torch.float32, dev)
    x = torch.randn(2, 256, cfg.d_model, generator=torch.Generator(device=dev).manual_seed(3), device=dev) * 0.3
    with torch.inference_mode():
        out, _ = rg.rglru_apply(p, x, cfg)
        state, outs = rg.init_rglru_state(cfg, 2, device=dev), []
        for t in range(x.shape[1]):
            o, state = rg.rglru_decode(p, x[:, t:t + 1], cfg, state)
            outs.append(o)
        ref = torch.cat(outs, dim=1)
    diff = (out - ref).abs()
    decode = dict(shape=[2, 256, cfg.rnn_width], max_abs_err=diff.max().item(),
                  rel_l2=((out - ref).norm() / ref.norm()).item(),
                  within_bar=bool((diff <= SCAN_BAR * (1 + ref.abs())).all()))
    check(failures, decode["within_bar"] and bool(torch.isfinite(out).all()),
          f"rglru_apply vs {x.shape[1]} rglru_decode steps at B 2, S 256, w {cfg.rnn_width}, f32: max_abs_err "
          f"{decode['max_abs_err']:.3g}, relative L2 {decode['rel_l2']:.3g} (bar {SCAN_BAR} abs and rel)")
    return dict(scan_vs_loop=loop, apply_vs_decode=decode)


def hybrid_forward(K, card: str, failures: list) -> dict:
    """recurrentgemma-9b's forward at full width and depth (phase 5 (b));
    ``card`` is nvidia-smi's name and power limit."""
    from dataclasses import replace

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get
    from repro_torch.models import Model
    from repro_torch.models.layers import rglru as rg

    cfg = replace(get("recurrentgemma-9b"), attn_impl="pallas")
    n_attn = cfg.pattern().count("attn")
    B, S = 2, 8192
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {cfg.n_layers} layers ({cfg.n_layers - n_attn} rglru, {n_attn} attn), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} of d {cfg.d_head}, window "
          f"{cfg.sliding_window}, rnn_width {cfg.rnn_width}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.3f}B f32 params ({torch.cuda.memory_allocated() / 1e9:.1f} GB on the card), "
          f"init {init_s:.1f} s; tokens {B} x {S}", flush=True)

    def run():
        h = model({"tokens": tokens})
        return h, model.logits(h[:, -1:])

    with torch.inference_mode():
        run()  # warm-up: cuBLAS handles and heuristics
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h, logits = run()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = K.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall_s = float(np.median(walls))

        V = cfg.vocab_size
        finite = bool(torch.isfinite(h).all()) and bool(torch.isfinite(logits[..., :V]).all())
        # the same module with the chunked attention: no second copy of 38 GB of weights
        model.cfg = replace(cfg, attn_impl="chunked")
        h_ref, logits_ref = run()
        model.cfg = cfg
        rel_h = ((h.float() - h_ref.float()).norm() / h_ref.float().norm()).item()
        rel_logits = ((logits[..., :V] - logits_ref[..., :V]).norm() / logits_ref[..., :V].norm()).item()
        del h_ref, logits_ref

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
            run()
            torch.cuda.synchronize()
        scan_spans = _event_spans(rg, "_scan", run)
    kernels = _device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    flash = [k for k in kernels if "rt::flash" in k[2]]
    flash_ms = sum(k[0] for k in flash)
    flash_256 = sum(k[1] for k in flash if "flash_bf16_kernel<256>" in k[2])
    mm_ms = sum(k[0] for k in kernels if any(w in k[2].lower() for w in ("gemm", "nvjet", "xmma", "cutlass")))
    scan_ms = sum(scan_spans)
    cast_ms = _weight_cast_ms(prof, model)
    n_rglru = cfg.n_layers - n_attn
    info = dict(config=cfg.name, batch=B, tokens=S, layers=cfg.n_layers, params=n_params, init_s=init_s,
                first_forward_s=first_s, wall_ms=1e3 * wall_s, wall_ms_runs=[1e3 * w for w in walls],
                tokens_per_s=B * S / wall_s, max_memory_gb=peak_gb, launches=launches,
                flash_d256_launches_profiled=flash_256, hidden_finite=finite, logits_shape=list(logits.shape),
                rel_l2_hidden_vs_chunked=rel_h, rel_l2_logits_vs_chunked=rel_logits,
                scan_calls=len(scan_spans), scan_ms_per_layer=scan_ms / n_rglru,
                profile=dict(device_busy_ms=busy, flash_ms=flash_ms, matmul_ms=mm_ms, rglru_scan_ms=scan_ms,
                             weight_cast_ms=cast_ms, other_ms=busy - flash_ms - mm_ms - scan_ms - cast_ms,
                             device_idle_share=1.0 - busy / (1e3 * wall_s)))
    print(f"  on {card}: " + json.dumps(info), flush=True)
    for ms, count, key in kernels[:14]:
        print(f"    {ms:10.2f} ms {count:7d} x  {key[:110]}", flush=True)
    check(failures, launches["flash_attention"] == n_attn and flash_256 == n_attn,
          f"flash_attention launched {launches['flash_attention']} times in one forward ({n_attn} attn layers); "
          f"the profiled forward ran flash_bf16_kernel<256> {flash_256} times")
    check(failures, all(n == 0 for name, n in launches.items() if name != "flash_attention"),
          f"no MWU kernel launched in the forward ({launches})")
    check(failures, len(scan_spans) == n_rglru,
          f"the timed forward ran the scan {len(scan_spans)} times ({n_rglru} rglru layers): {scan_ms:.2f} ms, "
          f"{scan_ms / (1e3 * wall_s):.1%} of the forward")
    check(failures, finite and list(h.shape) == [B, S, cfg.d_model] and list(logits.shape) == [B, 1, cfg.padded_vocab],
          f"hidden states {list(h.shape)} and last-position logits {list(logits.shape)} finite ({finite})")
    check(failures, rel_h <= LOGITS_REL_L2_BAR and rel_logits <= LOGITS_REL_L2_BAR,
          f"vs the chunked-attention forward: relative L2 hidden {rel_h:.4g}, logits {rel_logits:.4g} "
          f"(bar {LOGITS_REL_L2_BAR})")
    del h, logits
    info["decode"] = hybrid_decode(K, model, tokens, card, failures)
    del model
    torch.cuda.empty_cache()
    info["scan"] = scan_checks(failures)
    return info


def hybrid_decode(K, model, tokens: torch.Tensor, card: str, failures: list) -> dict:
    """Phase 5 (c): ``prefill`` of phase 5 (b)'s tokens, then RG_DECODE_STEPS
    ``decode_step``s; the last step's logits against the last row of a
    forward over all S + RG_DECODE_STEPS tokens, in bf16. One more step is
    profiled."""
    from torch.profiler import ProfilerActivity, profile

    cfg = model.cfg
    B, S = tokens.shape
    n, V = RG_DECODE_STEPS, cfg.vocab_size
    more = torch.randint(0, V, (B, n), generator=torch.Generator(device="cuda").manual_seed(2), device="cuda")
    with torch.inference_mode():
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, caches = model.prefill({"tokens": tokens}, S + n)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = K.launch_counts()
        K.reset_launch_counts()
        steps = []
        for t in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = model.decode_step(caches, more[:, t:t + 1])
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        decode_launches = K.launch_counts()
        # one more step, profiled (not part of the check), between CUDA events
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
            marks[0].record()
            model.decode_step(caches, more[:, -1:])
            marks[1].record()
            torch.cuda.synchronize()
        K.reset_launch_counts()
        del caches
        full = model.logits(model({"tokens": torch.cat([tokens, more], dim=1)})[:, -1:])
    finite = bool(torch.isfinite(lg[..., :V]).all()) and bool(torch.isfinite(full[..., :V]).all())
    rel = ((lg[..., :V] - full[..., :V]).norm() / full[..., :V].norm()).item()
    n_attn = cfg.pattern().count("attn")
    kernels = _device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    mm_ms = sum(k[0] for k in kernels if any(w in k[2].lower() for w in ("gemm", "nvjet", "xmma", "cutlass")))
    cast_ms = _weight_cast_ms(prof, model)
    step_ms = 1e3 * float(np.median(steps))
    info = dict(prefill_tokens=[B, S], prefill_ms=1e3 * prefill_s, decode_steps=n, decode_ms_per_step=step_ms,
                decode_ms_runs=[1e3 * t for t in steps], decode_tokens_per_s=B * 1e3 / step_ms,
                rel_l2_last_logits_vs_forward=rel,
                launches={k: prefill_launches[k] + decode_launches[k] for k in prefill_launches},
                profiled_step=dict(step_ms=marks[0].elapsed_time(marks[1]), device_busy_ms=busy,
                                   weight_cast_ms=cast_ms, matmul_ms=mm_ms, other_ms=busy - cast_ms - mm_ms,
                                   kernel_calls=sum(k[1] for k in kernels),
                                   device_idle_share=1.0 - busy / marks[0].elapsed_time(marks[1])))
    print(f"  (c) prefill + decode on {card}: " + json.dumps(info), flush=True)
    for ms, count, key in kernels[:8]:
        print(f"    {ms:10.3f} ms {count:5d} x  {key[:110]}", flush=True)
    check(failures, finite and rel <= LOGITS_REL_L2_BAR,
          f"(c) the last of {n} decode steps after a prefill of {B} x {S} vs the last row of a forward over "
          f"{S + n} tokens: relative L2 {rel:.4g} (bar {LOGITS_REL_L2_BAR}), finite {finite}")
    check(failures, prefill_launches["flash_attention"] == n_attn
          and all(v == 0 for k, v in prefill_launches.items() if k != "flash_attention")
          and all(v == 0 for v in decode_launches.values()),
          f"(c) prefill launched flash {prefill_launches['flash_attention']} times ({n_attn} attn layers), the decode "
          f"steps no kernel of the port ({decode_launches})")
    return info


# -- phase 6 -----------------------------------------------------------------
def serve_requests(n_requests: int, failures: list) -> dict:
    """Graph-LP serving at card size through the port's lpserve engine:
    match and vcover alternating, request i on erdos(n, m, seed=i) of
    SERVE_TIERS[i % 3], LPServeConfig(MWUOptions(eps=0.1, step_rule="newton"),
    lanes=4), the default BucketPolicy, float64. Returns the phase's numbers
    and its launches (counted from 0 over the engine's run alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as K
    from repro_torch.api import MWUOptions, Solver
    from repro_torch.graphs import build, erdos
    from repro_torch.lpserve import LPEngine, LPServeConfig
    from repro_torch.lpserve import engine as engine_mod

    opts = MWUOptions(eps=EPS, step_rule="newton")
    t0 = time.perf_counter()
    graphs = [erdos(*SERVE_TIERS[i % 3], seed=i) for i in range(n_requests)]
    probs = [build(("match", "vcover")[i % 2], g, device="cuda") for i, g in enumerate(graphs)]
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    print(f"  {n_requests} requests (match, vcover alternating; tiers {SERVE_TIERS}) generated and built in "
          f"{t_build:.1f} s on the host", flush=True)

    class RoundSolver(Solver):
        """Keeps each round's lanes, iterations and wall time."""

        def __init__(self):
            super().__init__(opts, batch_width=1)
            self.rounds = []

        def solve_stack(self, problems, bounds):
            t0 = time.perf_counter()
            batch = super().solve_stack(problems, bounds)
            self.rounds.append(dict(bucket=(problems[0].name, problems[0].P.shape if problems[0].P is not None
                                            else problems[0].C.shape), lanes=len(problems),
                                    iters=[int(i) for i in batch.iters], probes=int(np.sum(batch.ls_probes)),
                                    wall_s=time.perf_counter() - t0))
            self.last = batch
            return batch

    # the certificates' host time, inside the engine's rounds
    certify, cert = engine_mod.certify_solution, dict(s=0.0, n=0)

    def timed_certify(*a, **kw):
        t0 = time.perf_counter()
        out = certify(*a, **kw)
        cert["s"], cert["n"] = cert["s"] + time.perf_counter() - t0, cert["n"] + 1
        return out

    engine = LPEngine(LPServeConfig(opts=opts, lanes=4))
    engine.solver = RoundSolver()
    torch.cuda.synchronize()
    engine_mod.certify_solution = timed_certify
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        sols = engine.solve_many(probs)
        torch.cuda.synchronize()
    finally:
        engine_mod.certify_solution = certify
    t_engine = time.perf_counter() - t0
    launches = K.launch_counts()
    stats = engine.stats()
    rounds = engine.solver.rounds

    seq = Solver(opts, batch_width=1)
    t0 = time.perf_counter()
    refs = [seq.solve(p) for p in probs]
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0

    lane_iters = sum(sum(r["iters"]) for r in rounds)
    loop_iters = sum(max(r["iters"]) for r in rounds)
    info = dict(requests=n_requests, build_s=t_build, engine_wall_s=t_engine, sequential_wall_s=t_seq,
                batches=stats["batches"], feasibility_calls=stats["feasibility_calls"],
                mwu_iters=stats["mwu_iters"], lane_iters_launched=lane_iters, loop_iters=loop_iters,
                lane_occupancy=stats["lane_occupancy"], padding_waste=stats["padding_waste"],
                latency_p50_s=stats["latency_p50_s"], latency_p99_s=stats["latency_p99_s"],
                rounds_wall_s=sum(r["wall_s"] for r in rounds), certify_s=cert["s"], certificates=cert["n"],
                compiles=stats["compiles"],
                compile_cache_hits=stats["compile_cache_hits"], launches=launches,
                buckets={k: {f: b[f] for f in ("requests", "batches", "lane_occupancy", "padding_waste",
                                               "feasibility_calls", "mwu_iters", "batch_seconds")}
                         for k, b in stats["buckets"].items()})
    print("  " + json.dumps(info), flush=True)
    for key, b in stats["buckets"].items():
        print(f"  bucket {key:24s} requests={b['requests']:3d} batches={b['batches']:3d} "
              f"occupancy={b['lane_occupancy']:.0%} waste={b['padding_waste']:.1%} "
              f"batch_seconds={b['batch_seconds']:.2f}", flush=True)
    print(f"  engine {t_engine:.2f} s ({stats['batches']} batches, {stats['feasibility_calls']} calls, "
          f"{stats['mwu_iters']} lane iterations of real lanes, {lane_iters} launched, {loop_iters} loop "
          f"iterations): rounds {info['rounds_wall_s']:.2f} s, {cert['n']} certificates {cert['s']:.2f} s, the rest "
          f"(x copies, padding at submit, bookkeeping) {t_engine - info['rounds_wall_s'] - cert['s']:.2f} s; latency "
          f"p50 {stats['latency_p50_s']:.2f} s, p99 {stats['latency_p99_s']:.2f} s; sequential Solver(batch_width=1) "
          f"{t_seq:.2f} s", flush=True)
    for r in rounds:
        print(f"    round {r['bucket'][0]} {list(r['bucket'][1])}: {r['lanes']} lanes, iterations {r['iters']}, "
              f"{r['probes']} probes, {r['wall_s']:.3f} s", flush=True)

    for i, (g, p, sol, ref) in enumerate(zip(graphs, probs, sols, refs)):
        ok = sol.found and sol.feasible
        if ok and p.name == "match":  # packing: max Mx <= 1 on the host
            loads = np.bincount(g.u, sol.x, g.n) + np.bincount(g.v, sol.x, g.n)
            cert, ok = f"max Mx {loads.max()!r}", loads.max() <= 1 + 1e-9
        elif ok:  # covering: min M^T x >= 1 on the host
            cover = sol.x[g.u] + sol.x[g.v]
            cert, ok = f"min M^T x {cover.min()!r}", cover.min() >= 1 - 1e-9
        else:
            cert = "not found"
        rel = abs(sol.objective - ref.objective) / max(abs(ref.objective), 1e-12)
        check(failures, ok and ref.feasible and rel <= 3 * EPS,
              f"request {i:2d}: {p.name:6s} erdos{SERVE_TIERS[i % 3]} calls {sol.feasibility_calls}, objective "
              f"{sol.objective:.3f} (sequential {ref.objective:.3f}, rel {rel:.4f}, bar {3 * EPS}); {cert}")
    print(f"sha256 served answers: {served_digest(sols)} ({len(sols)} requests)", flush=True)
    check(failures, stats["batches"] < stats["feasibility_calls"],
          f"batches {stats['batches']} < feasibility calls {stats['feasibility_calls']}")
    check(failures, stats["completed"] == n_requests and stats["not_found"] == 0,
          f"{stats['completed']} of {n_requests} requests completed, {stats['not_found']} not found")
    check(failures, launches["newton_search"] == launches["step_direction"] == lane_iters
          and launches["axpy_reduce"] == 3 * lane_iters and launches["softmax_weights"] == 2 * lane_iters
          and launches["linesearch_probe"] == 0 and launches["flash_attention"] == 0,
          f"every lane iteration on the card: launches {launches} for {lane_iters} lane iterations (the search, the "
          f"step direction once each, the axpy 3x, softmax 2x, no lone probe)")
    # served match lanes gather their packing gradient inside the step
    # direction, with the padded edges' mask: no lone gather; a vcover lane's
    # covering product M^T d is one (one a lane iteration, one at its start)
    vcover = [r for r in rounds if r["bucket"][0] == "vcover"]
    covering = sum(sum(r["iters"]) + r["lanes"] for r in vcover)
    check(failures, launches["incidence_gather"] == covering,
          f"served match lanes launch no lone gather: incidence_gather {launches['incidence_gather']} = the vcover "
          f"lanes' covering products ({covering}: {sum(sum(r['iters']) for r in vcover)} lane iterations and "
          f"{sum(r['lanes'] for r in vcover)} lanes' starts)")

    # one round profiled: a fresh engine's second round over the four
    # requests of the first tier-0/1 match bucket (its first round built
    # their CSR); reads are the device-to-host copies. The same round of a
    # second fresh engine, timed without the profiler (a card solve repeats:
    # the same iterations), gives the wall time the idle share is taken of.
    quad = [p for i, p in enumerate(probs) if i % 2 == 0 and i % 3 != 2][:4]

    def second_round(profiled: bool):
        eng = LPEngine(LPServeConfig(opts=opts, lanes=4))
        eng.solver = RoundSolver()
        for p in quad:
            eng.submit(p)
        eng.step()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled else None
        if prof is not None:
            prof.__enter__()
        eng.step()
        torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
        check(failures, len(eng.solver.rounds) == 2, f"the fresh engine ran {len(eng.solver.rounds)} rounds (2)")
        return eng.solver.rounds[-1], 1e3 * (time.perf_counter() - t0), K.launch_counts(), prof

    timed, wall_ms, _, _ = second_round(False)
    r, prof_wall_ms, prof_launches, prof = second_round(True)
    check(failures, r["iters"] == timed["iters"], f"the timed and the profiled round repeat ({timed['iters']} / "
                                                  f"{r['iters']} iterations)")
    events = prof.key_averages()
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in events
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels)
    reads = sum(e.count for e in events if e.device_type == DeviceType.CUDA and "DtoH" in e.key)
    loop = max(r["iters"])
    copy_ms = sum(k[0] for k in kernels if "Memcpy DtoH" in k[2])
    prof_info = dict(lanes=r["lanes"], lane_iters=sum(r["iters"]), loop_iters=loop, probes=r["probes"],
                     wall_ms=wall_ms, profiled_wall_ms=prof_wall_ms, device_busy_ms=busy, dtoh_copy_ms=copy_ms,
                     device_idle_share=1.0 - busy / wall_ms,
                     kernel_ms_per_lane_iter=(busy - copy_ms) / max(sum(r["iters"]), 1), host_reads=reads,
                     host_reads_per_loop_iter=reads / max(loop, 1), launches=prof_launches)
    info["profile_round"] = prof_info
    print(f"  profile of one engine round: {json.dumps(prof_info)}", flush=True)
    for ms, count, key in kernels[:14]:
        print(f"    {ms:10.2f} ms {count:7d} x  {key[:110]}", flush=True)
    check(failures, reads <= loop + 3,
          f"profiled round: {reads} host reads in {loop} loop iterations ({r['probes']} probes; bar: loop "
          f"iterations + 3)")
    check(failures, prof_launches["linesearch_probe"] == 0 and prof_launches["newton_search"] == sum(r["iters"])
          and prof_launches["incidence_gather"] == 0 and prof_launches["step_direction"] == sum(r["iters"]),
          f"profiled round: no probe read back one by one (linesearch_probe {prof_launches['linesearch_probe']}, "
          f"newton_search {prof_launches['newton_search']} for {sum(r['iters'])} lane iterations); match lanes: "
          f"step_direction {prof_launches['step_direction']}, no lone gather ({prof_launches['incidence_gather']})")
    return info


# -- phase 7 -----------------------------------------------------------------
def table3(prob, bound: float, failures: list) -> dict:
    """Table 3 at full width: one profiled feasibility solve of phase 3's
    bmatch problem at its certified bound per step rule (newton, binary,
    std; std cut to TABLE3_STD_CAP iterations), each through ``profile_run``: its
    iterations, probes an iteration, device ms a lane iteration, ms a
    search launch, host reads a loop iteration (at most 1.01 for every
    rule) and the device's idle share."""
    from repro_torch import kernels as K
    from repro_torch.api import MWUOptions, Solver

    out = {}
    for rule in ("newton", "binary", "std"):
        cap = TABLE3_STD_CAP if rule == "std" else MWUOptions().max_iter
        if rule == "std":
            print(f"  cut: the std rule's solve is capped at {cap} iterations (MWUOptions' default cap: "
                  f"{MWUOptions().max_iter})", flush=True)
        opts = MWUOptions(eps=EPS, step_rule=rule, max_iter=cap)
        t0 = time.perf_counter()
        K.reset_launch_counts()
        p = profile_run(lambda: Solver(opts).feasible(prob, bound), f"Table 3, the {rule} rule at bound {bound!r}",
                        failures)
        # the searches' launches as their wrappers count them, over profile_run's two solves (timed, then
        # profiled); the profiler's own count can miss an event of a long trace
        counted = K.launch_counts()
        launches = counted["newton_search"] + counted["binary_search"]
        print(f"  Table 3 {rule}: launches of the timed and the profiled solve: {json.dumps(counted)}", flush=True)
        p["phase_s"] = time.perf_counter() - t0
        p["probes_per_iter"] = p["probes"] / max(p["lane_iters"], 1)
        p["ms_per_search_launch"] = p["search_ms"] / p["search_launches"] if p["search_launches"] else None
        out[rule] = p
        print(f"  Table 3 {rule}: {p['status'][0]}, {p['lane_iters']} iterations, {p['probes_per_iter']:.3f} probes an "
              f"iteration, {p['device_ms_per_lane_iter']:.4f} device ms a lane iteration, ms a search launch "
              f"{p['ms_per_search_launch']}, {p['host_reads_per_loop_iter']:.4f} host reads a loop iteration, idle "
              f"share {p['device_idle_share']:.4f}; timed and profiled in {p['phase_s']:.1f} s", flush=True)
        launches_ok = launches == (0 if rule == "std" else 2 * p["lane_iters"])
        check(failures, p["host_reads_per_loop_iter"] <= 1.01 and launches_ok,
              f"Table 3 {rule}: {p['host_reads_per_loop_iter']:.4f} host reads a loop iteration (bar 1.01); "
              f"{launches} search launches for 2 x {p['lane_iters']} iterations (the profile's: "
              f"{p['search_launches']})")
    return out


def iters_to(viol: np.ndarray, eps: float):
    """Iterations until the violation first is at most eps
    (benchmarks/bench_convergence.py's iters_to), None if never."""
    idx = np.nonzero(viol <= eps)[0]
    return int(idx[0]) if len(idx) else None


def figure3(g, failures: list) -> dict:
    """Figure 3 at full width: generalized matching on phase 3's graph with
    ``benchmarks/bench_convergence.py::build_instance``'s bounds (users lb =
    min(3, deg), ub = 5; items ub = 200), eps FIG3_EPS, float64, by MWU with
    the Newton rule, MWU with the std rule (``solve_traced``) and MPCSolver
    (``mpc_solve``), each cut to FIG3_CAP iterations, the std rule to
    FIG3_STD_CAP. For each: iterations
    to eps ("not reached by the cap" where so), the final violation, ms an
    iteration (host clock) and host reads an iteration (counted). First
    ``mpc_solve`` on a small instance (build_instance cut to 300 users and
    140 items) on the card and on the CPU: the same iterations, x within
    rel 1e-9."""
    from repro_torch import kernels as K
    from repro_torch.core import MPCOptions, mpc_solve
    from repro_torch.core.mwu import MWUOptions, solve_traced
    from repro_torch.graphs import bipartite_ratings, generalized_matching_lp

    def bounds(graph):
        deg, s = graph.degrees(), graph.bipartite_split
        lb, ub = np.zeros(graph.n), np.ones(graph.n)
        lb[:s], ub[:s], ub[s:] = np.minimum(3, deg[:s]), 5, 200
        return lb, ub

    small = bipartite_ratings(300, 140, avg_ratings=18.0, seed=0)
    runs = {}
    for dev in ("cpu", "cuda"):
        sP, sC, s_mask = generalized_matching_lp(small, *bounds(small), device=dev)
        runs[dev] = mpc_solve(sP, sC, MPCOptions(eps=FIG3_EPS, max_iter=3000), c_mask=s_mask)
    (x_c, tr_c), (x_g, tr_g) = runs["cpu"], runs["cuda"]
    rel = float(np.max(np.abs(x_g - x_c) / np.maximum(np.abs(x_c), 1e-300)))
    check(failures, tr_g["iters"] == tr_c["iters"] and rel <= 1e-9,
          f"mpc_solve on the small instance: card {tr_g['iters']} / cpu {tr_c['iters']} iterations, x within rel "
          f"{rel:.3g} (bar 1e-9)")

    lb, ub = bounds(g)
    t0 = time.perf_counter()
    P, C, cm = generalized_matching_lp(g, lb, ub, device="cuda")
    # build the operators' CSR before timing (at their first card products)
    x = torch.full((g.m,), 1e-6, dtype=torch.float64, device="cuda")
    P.rmatvec(P.matvec(x))
    C.rmatvec(C.matvec(x))
    del x
    torch.cuda.synchronize()
    print(f"  generalized matching on {g.n} vertices, {g.m} edges: P {P.shape}, C {C.shape}, {int(cm.sum())} covering "
          f"rows kept; built in {time.perf_counter() - t0:.1f} s. cut: Newton and MPCSolver capped at {FIG3_CAP} "
          f"iterations, std at {FIG3_STD_CAP} (bench_convergence.py: 6000)", flush=True)
    out = {}
    methods = (("mwu-newton", "newton", FIG3_CAP), ("mwu-std", "std", FIG3_STD_CAP), ("mpcsolver-gd", None, FIG3_CAP))
    for name, rule, cap in methods:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with counted_reads() as reads:
            if rule is None:
                x, tr = mpc_solve(P, C, MPCOptions(eps=FIG3_EPS, max_iter=cap), c_mask=cm)
                iters = tr["iters"]
            else:
                res, tr = solve_traced(P, C, MWUOptions(eps=FIG3_EPS, step_rule=rule, max_iter=cap), c_mask=cm)
                x, iters = res.x, res.iters
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        viol = tr["max_violation"]
        reached = iters_to(viol, FIG3_EPS)
        r = dict(iters=iters, cap=cap, iters_to_eps=reached, final_violation=float(viol[-1]), wall_s=wall,
                 ms_per_iter=1e3 * wall / max(iters, 1), host_reads=reads[0],
                 host_reads_per_iter=reads[0] / max(iters, 1), launches=K.launch_counts())
        out[name] = r
        print(f"  Figure 3 {name}: iterations to eps {FIG3_EPS}: "
              f"{'not reached by the cap' if reached is None else reached}; {iters} iterations, final violation "
              f"{r['final_violation']!r}, {r['ms_per_iter']:.3f} ms an iteration, {r['host_reads_per_iter']:.4f} host "
              f"reads an iteration; launches {json.dumps(r['launches'])}", flush=True)
        finite = bool(np.isfinite(viol).all()) and bool(torch.isfinite(torch.as_tensor(x)).all())
        check(failures, finite and 0 < iters <= cap and len(viol) >= iters and reads[0] <= iters + 3,
              f"Figure 3 {name}: {iters} iterations, finite violations and x, {reads[0]} host reads")
        del x, tr
    del P, C, cm
    torch.cuda.empty_cache()
    return out


# -- phase 8 -----------------------------------------------------------------
DIST_RANKS = 2  # phase 8 (b): ranks sharing the one card over gloo
DIST_TIMEOUT_S = 600  # phase 8 (b): the ranks' time limit; their process group's timeout is half of it
DIST_REPORT = "DIST_RANK_REPORT "  # a rank's report line, read by the parent (never its own last line)


def bmatch_problem(u: np.ndarray, v: np.ndarray, n: int, lo: float, hi: float):
    """Phase 3's bmatch Problem on the card from its edges and search bounds:
    what ``graphs.build("bmatch", g)`` builds, without its greedy matching's
    host loop over the edges (the bounds come with the edges)."""
    from repro_torch.api import Problem
    from repro_torch.core.operators import Incidence

    P = Incidence(u=torch.as_tensor(u, device="cuda"), v=torch.as_tensor(v, device="cuda"), n_vertices=int(n))
    return Problem(name="bmatch", kind="packing", sense="max", bound_mode="objective_covering", P=P,
                   c=torch.ones(len(u), dtype=torch.float64, device="cuda"), lo=float(lo), hi=float(hi),
                   n_vars=len(u), nnz=P.nnz, device="cuda", dtype=torch.float64)


def identity_plan_solve(g, lo: float, hi: float, phase3: dict, failures: list) -> dict:
    """Phase 8 (a): ``DistSolver(plan=MeshPlan(), batch_width=4).solve`` of
    phase 3's bmatch problem equals phase 3's ``Solver(batch_width=4).solve``:
    x by sha256, objective, bound, rounds and lane iterations."""
    from repro_torch import kernels as K
    from repro_torch.api import MWUOptions
    from repro_torch.dist import DistSolver, MeshPlan

    prob = bmatch_problem(g.u, g.v, g.n, lo, hi)
    solver = round_solver(MWUOptions(eps=EPS, step_rule="newton"), base=DistSolver, plan=MeshPlan())
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solver.solve(prob)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    got = dict(x_sha256=sha256(sol.x), objective=sol.objective, bound=sol.bound, rounds=len(solver.rounds),
               iters=sol.mwu_iters_total)
    want = {k: phase3[k] for k in got}
    print(f"  (a) identity plan: {json.dumps(got)}; {wall:.2f} s (CSR built inside)", flush=True)
    check(failures, got == want, f"(a) DistSolver(plan=MeshPlan()) equals phase 3's Solver: {got} | {want}")
    del prob, solver, sol
    torch.cuda.empty_cache()
    return dict(launches=launches, wall_s=wall, **got)


def timed_collectives(*names: str):
    """Wrap the ``torch.distributed`` collectives ``names`` to time each call
    on the host clock, the device drained first, so only the collective
    counts (gloo stages a CUDA tensor through the host); returns
    ({name: {"calls", "ms"}}, restore)."""
    import torch.distributed as tdist

    stats, inner = {}, {name: getattr(tdist, name) for name in names}

    def timed(name):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner[name](*a, **k)
            torch.cuda.synchronize()
            stats[name]["ms"] += 1e3 * (time.perf_counter() - t0)
            stats[name]["calls"] += 1
            return out
        return call

    for name in names:
        stats[name] = {"calls": 0, "ms": 0.0}
        setattr(tdist, name, timed(name))
    return stats, lambda: [setattr(tdist, name, f) for name, f in inner.items()]


def dist_rank(rank: int, folder: Path) -> int:
    """Phase 8 (b), one rank: phase 3's bmatch over ``MeshPlan(pod=2)`` edge
    slabs with the other rank on the same card, over gloo. Prints its report
    as one line after ``DIST_REPORT``; the parent checks and prints it."""
    import datetime

    import torch.distributed as tdist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as K
    from repro_torch.api import MWUOptions, Status
    from repro_torch.dist import DistSolver, MeshPlan

    tdist.init_process_group("gloo", init_method=f"file://{folder / 'init'}", rank=rank, world_size=DIST_RANKS,
                             timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S / 2))
    try:
        meta = json.loads((folder / "meta.json").read_text())
        t0 = time.perf_counter()
        prob = bmatch_problem(np.load(folder / "u.npy"), np.load(folder / "v.npy"), meta["n"], meta["lo"], meta["hi"])
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        opts = MWUOptions(eps=EPS, step_rule="newton")
        solver = round_solver(opts, base=DistSolver, plan=MeshPlan(pod=DIST_RANKS))
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        # the results' gathers, once a round, timed (their drains cost nothing: a gather waits for the round)
        gathers, restore = timed_collectives("all_gather")
        try:
            tdist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = solver.solve(prob)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            restore()
        launches = K.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        x = sol.x
        report = dict(rank=rank, status=Status.NAMES[sol.status], objective=sol.objective, bound=sol.bound,
                      calls=sol.feasibility_calls, iters=sol.mwu_iters_total,
                      rounds=[dict(lanes=len(r["bounds"]), iters=r["iters"], wall_s=r["wall_s"]) for r in solver.rounds],
                      loop_iters=sum(max(r["iters"]) for r in solver.rounds), wall_s=wall, load_s=t_load,
                      peak_gb=peak_gb, launches=launches, dist_stats=solver.dist_stats,
                      all_gather=gathers["all_gather"],
                      x_sha256=sha256(x) if x is not None else None)
        if rank == 0 and x is not None:  # the ranks' x are compared by sha256
            report["max_Mx"] = float((np.bincount(np.load(folder / "u.npy"), x, meta["n"])
                                      + np.bincount(np.load(folder / "v.npy"), x, meta["n"])).max())
        # one feasibility solve at the certified bound, instrumented: device
        # time (profiler, this process's kernels), the collectives' time, the
        # program's host reads
        stats, restore = timed_collectives("all_reduce")
        try:
            tdist.barrier()
            with counted_reads() as reads, profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = DistSolver(opts, plan=MeshPlan(pod=DIST_RANKS)).feasible(prob, sol.bound)
                torch.cuda.synchronize()
                f_wall = time.perf_counter() - t0
        finally:
            restore()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0) / 1e3
        it = max(int(res.iters), 1)
        report["at_bound"] = dict(status=Status.NAMES[int(res.status)], iters=int(res.iters), wall_s=f_wall,
                                  device_ms=busy, device_ms_per_lane_iter=busy / it,
                                  all_reduce_calls=stats["all_reduce"]["calls"], all_reduce_ms=stats["all_reduce"]["ms"],
                                  all_reduce_ms_per_lane_iter=stats["all_reduce"]["ms"] / it, host_reads=reads[0],
                                  host_reads_per_loop_iter=reads[0] / it)
        print(DIST_REPORT + json.dumps(report), flush=True)
    finally:
        tdist.destroy_process_group()
    return 0


def dist_solve(g, lo: float, hi: float, exact: int, failures: list) -> dict:
    """Phase 8 (b): two ranks on the one card, each a ``chip_smoke.py
    --dist-rank`` process, solve phase 3's bmatch over ``MeshPlan(pod=2)``
    edge slabs (98,609,647 edges: one padded, masked edge). The parent hands
    them the edges and the search bounds through a temporary directory;
    checks that the Solution is FEASIBLE within 1.5*eps of the exact
    maximum, that max Mx <= 1 + 1e-9 on the host, that both ranks return
    the same x, status, bound and iterations, and that every lane iteration
    ran the search and the step direction once and three axpys, and no lone
    gather (the masked slab's gather runs inside the step direction)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        np.save(folder / "u.npy", g.u)
        np.save(folder / "v.npy", g.v)
        (folder / "meta.json").write_text(json.dumps(dict(n=g.n, lo=lo, hi=hi)))
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dist-rank", str(r),
                                   "--dist-dir", tmp], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(DIST_RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DIST_TIMEOUT_S))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            check(failures, False, f"(b) the ranks finished within {DIST_TIMEOUT_S} s")
            return {}
        wall = time.perf_counter() - t0
    reports = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith(DIST_REPORT)]
        check(failures, p.returncode == 0 and len(lines) == 1,
              f"(b) rank {r} exited {p.returncode} with its report" + ("" if p.returncode == 0 else f": {err[-2000:]}"))
        if lines:
            reports.append(json.loads(lines[0][len(DIST_REPORT):]))
    if len(reports) != DIST_RANKS:
        return {}
    a = reports[0]
    print(f"  (b) {DIST_RANKS} ranks on one card over gloo, MeshPlan(pod={DIST_RANKS}) edge slabs, both processes in "
          f"{wall:.1f} s (start, load, solve, profile). Not a speed-up figure: the ranks share one card.", flush=True)
    for rep in reports:
        ab = rep["at_bound"]
        print(f"  (b) rank {rep['rank']}: {rep['status']}, objective {rep['objective']!r}, bound {rep['bound']!r}, "
              f"{rep['calls']} calls, {rep['iters']} lane iterations in {rep['loop_iters']} loop iterations; time to "
              f"solution {rep['wall_s']:.2f} s (slab cut and CSR inside; edges loaded in {rep['load_s']:.1f} s); "
              f"rounds {[(x['lanes'], x['iters'], round(x['wall_s'] or 0.0, 2)) for x in rep['rounds']]}, of which "
              f"gathering the results {rep['all_gather']['ms'] / 1e3:.2f} s ({rep['all_gather']['calls']} all_gather "
              f"calls); peak {rep['peak_gb']:.2f} GB", flush=True)
        print(f"  (b) rank {rep['rank']} at the certified bound: {ab['status']}, {ab['iters']} iterations, "
              f"{ab['device_ms_per_lane_iter']:.4f} device ms a lane iteration (this rank's kernels), all_reduce "
              f"{ab['all_reduce_ms_per_lane_iter']:.4f} ms a lane iteration ({ab['all_reduce_calls']} calls, "
              f"{ab['all_reduce_ms']:.1f} ms), {ab['host_reads_per_loop_iter']:.4f} host reads a loop iteration, "
              f"{ab['wall_s']:.2f} s", flush=True)
        print(f"  (b) rank {rep['rank']} launches: {json.dumps(rep['launches'])}; dist_stats "
              f"{json.dumps(rep['dist_stats'])}", flush=True)
    keys = ("x_sha256", "status", "bound", "iters", "objective", "calls")
    same = all({k: rep[k] for k in keys} == {k: a[k] for k in keys} for rep in reports)
    check(failures, same, f"(b) every rank returns the same x (sha256 {a['x_sha256']}), status, bound and iterations")
    rel = abs(a["objective"] - exact) / exact
    check(failures, a["status"] == "FEASIBLE" and rel <= 1.5 * EPS,
          f"(b) {a['status']}, objective {a['objective']!r} within 1.5*eps of exact {exact} (rel {rel:.4f})")
    check(failures, a.get("max_Mx", np.inf) <= 1 + 1e-9, f"(b) host-recomputed max(Mx) = {a.get('max_Mx')!r} <= 1 + 1e-9")
    for rep in reports:
        n, L = rep["iters"], rep["launches"]
        ok = (L["newton_search"] == L["step_direction"] == n and L["incidence_gather"] == 0
              and L["axpy_reduce"] == 3 * n and L["incidence_scatter"] > 0 and L["softmax_weights"] > 0
              and L["flash_attention"] == 0)
        check(failures, ok, f"(b) rank {rep['rank']}: search and step direction once a lane iteration ({n}; the "
                            f"masked slab gathers inside the step direction: no lone gather), the axpy three times: "
                            f"{json.dumps(L)}")
    launches = {name: sum(rep["launches"][name] for rep in reports) for name in a["launches"]}
    return dict(wall_s=wall, reports=reports, launches=launches)


# -- phase 9 -----------------------------------------------------------------
MOE_LAYERS = 4  # mixtral-8x22b's 56 layers cut to 4: ~42 GB of f32 params
MOE_TOKENS = 6144  # B 1 x S 6144, past the 4,096-key window
LAYER_TOL = 2e-4  # (b): dispatch and combine vs the expert loop (tests/test_layers.py:172)
ROUTER_X_TOL = 1e-4  # (a): the router's x, tests/test_kernels.py's f32 bar
ROUTE_MARGIN = 1e-4  # (a): routes compared on tokens whose k-th / (k+1)-th margin exceeds this
# (a) in f32: the iterations before rounding grows. The f32 routing LP
# amplifies an ulp about threefold an iteration (the Newton step is a
# cancellation at eta ~ 300): on the CPU the port's own x moves by up to
# 4.9e-2 over 16 iterations at T 6,144 when the tokens are permuted (an LP
# symmetry), with alpha within 2.6e-5 of itself through iteration 3.
ROUTER_F32_ITERS = 3


class _Spans:
    """CUDA events around each call of the functions it wraps in a module:
    ``spans[name]`` lists (start, end) event pairs; ``calls[name]`` each
    call's (args, result) where ``keep`` names the function."""

    def __init__(self, module, names, keep=()):
        self.module, self.saved = module, {n: getattr(module, n) for n in names}
        self.spans = {n: [] for n in names}
        self.calls = {n: [] for n in names}
        for n in names:
            setattr(module, n, self._wrap(n, n in keep))

    def _wrap(self, name, keep):
        inner = self.saved[name]

        def timed(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*a, **kw)
            end.record()
            self.spans[name].append((start, end))
            if keep:
                self.calls[name].append((a, out))
            return out
        return timed

    def restore(self) -> None:
        for n, f in self.saved.items():
            setattr(self.module, n, f)

    def ms(self, name) -> list[float]:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.spans[name]]


def _route_sets(idx: torch.Tensor) -> torch.Tensor:
    return torch.sort(idx, dim=-1).values


def _margin(x: torch.Tensor, probs: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's gap between its k-th and (k+1)-th rounding score."""
    s = torch.sort(x + 1e-6 * probs, dim=-1, descending=True).values
    return s[..., k - 1] - s[..., k]


def replace_moe(cfg, **kw):
    from dataclasses import replace

    return replace(cfg, moe=replace(cfg.moe, **kw))


def router_checks(moe, logits: torch.Tensor, res_card, cfg, layer: int, failures: list,
                  hold_f32: bool = True) -> dict:
    """(a) for one layer: the layer's routing LP on the card vs the same LP on
    the CPU (the kernels' plain versions). In f64 (the same operators at
    f64) over the whole budget: x within 1e-4, the same iterations, probes
    and status, the same routes past the margin. In f32, the forward's own
    LP: over its first ROUTER_F32_ITERS iterations x within 1e-4 and the
    same probes (printed only, where ``hold_f32`` is False: phase 11's
    logits, whose f32 search parts card from CPU at its first iteration);
    over the whole budget (``res_card``, the forward's own solve) printed:
    rounding decides it (ROUTER_F32_ITERS's note)."""
    from repro_torch.core import solve_lanes

    m = cfg.moe
    _, cap = moe.dispatch_shape(cfg, logits.shape[0] * logits.shape[1])
    opts = moe.router_options(m.mwu_iters)
    out = {}
    # f64: the affinities from the card's softmax, so both sides solve one LP
    p64 = torch.softmax(logits[0].double(), dim=-1)
    card = solve_lanes([(*moe.routing_ops(p64, m.top_k, cap), None, None)], opts).lane(0)
    cpu = solve_lanes([(*moe.routing_ops(p64.cpu(), m.top_k, cap), None, None)], opts).lane(0)
    x_card, x_cpu = card.x.cpu().reshape(p64.shape), cpu.x.reshape(p64.shape)
    dx = (x_card - x_cpu).abs().max().item()
    idx_card, _ = moe.round_plan(x_card, p64.cpu(), m.top_k, torch.float64)
    idx_cpu, _ = moe.round_plan(x_cpu, p64.cpu(), m.top_k, torch.float64)
    past = _margin(x_cpu, p64.cpu(), m.top_k) > ROUTE_MARGIN
    flips = int(((_route_sets(idx_card) != _route_sets(idx_cpu)).any(-1) & past).sum())
    out["f64"] = dict(max_abs_dx=dx, iters=[card.iters, cpu.iters], probes=[card.ls_probes, cpu.ls_probes],
                      status=[card.status, cpu.status], route_flips_past_margin=flips, near_ties=int((~past).sum()))
    check(failures, dx <= ROUTER_X_TOL and card.iters == cpu.iters and card.ls_probes == cpu.ls_probes
          and card.status == cpu.status and flips == 0,
          f"(a) layer {layer}, f64: the routing LP on the card vs the CPU over {m.mwu_iters} iterations: x max "
          f"|diff| {dx:.3g} (bar {ROUTER_X_TOL}), iterations {card.iters} / {cpu.iters}, probes {card.ls_probes} / "
          f"{cpu.ls_probes}, status {card.status} / {cpu.status}; routes differ on {flips} tokens past the margin "
          f"{ROUTE_MARGIN} ({out['f64']['near_ties']} near ties)")
    # f32, the forward's LP: its first iterations in lockstep
    _, card3 = moe.routing_lp(logits, m.top_k, cap, ROUTER_F32_ITERS)
    _, cpu3 = moe.routing_lp(logits.cpu(), m.top_k, cap, ROUTER_F32_ITERS)
    dx3 = (card3.x.cpu() - cpu3.x).abs().max().item()
    same3 = (card3.iters.tolist(), card3.ls_probes.tolist()) == (cpu3.iters.tolist(), cpu3.ls_probes.tolist())
    out["f32_first"] = dict(iters=ROUTER_F32_ITERS, max_abs_dx=dx3, probes=[int(card3.ls_probes[0]),
                                                                           int(cpu3.ls_probes[0])])
    what = (f"(a) layer {layer}, f32: the forward's routing LP on the card vs the CPU over its first "
            f"{ROUTER_F32_ITERS} iterations: x max |diff| {dx3:.3g} (bar {ROUTER_X_TOL}), probes "
            f"{out['f32_first']['probes']}")
    if hold_f32:
        check(failures, dx3 <= ROUTER_X_TOL and same3, what)
    else:
        print(f"  {what} (not a check here: rounding decides it)", flush=True)
    # f32 over the whole budget: printed
    probs, cpu16 = moe.routing_lp(logits.cpu(), m.top_k, cap, m.mwu_iters)
    x_card = res_card.x.cpu().reshape(probs.shape)
    x_cpu = cpu16.x.reshape(probs.shape)
    idx_card, _ = moe.round_plan(x_card, probs, m.top_k, torch.float32)
    idx_cpu, _ = moe.round_plan(x_cpu, probs, m.top_k, torch.float32)
    past = _margin(x_cpu, probs, m.top_k) > ROUTE_MARGIN
    flips = int(((_route_sets(idx_card) != _route_sets(idx_cpu)).any(-1) & past).sum())
    out["f32_whole"] = dict(max_abs_dx=(x_card - x_cpu).abs().max().item(),
                            iters=[int(res_card.iters[0]), int(cpu16.iters[0])],
                            status=[int(res_card.status[0]), int(cpu16.status[0])],
                            route_flips_past_margin=flips, near_ties=int((~past).sum()))
    print(f"  (a) layer {layer}, f32 over the whole budget (not a check: rounding decides it): "
          f"{json.dumps(out['f32_whole'])}", flush=True)
    return out


def expert_oracle_check(moe, x: torch.Tensor, p: dict, cfg, router: str, failures: list) -> dict:
    """(b): ``moe_apply`` on layer 0's input at capacity_factor = E (no
    token dropped), in f32 with TF32 off, against a loop over the experts
    that runs every token through every expert, on the card."""
    import torch.nn.functional as F

    m = replace_moe(cfg, router=router, capacity_factor=float(cfg.moe.n_experts))
    x32 = x.float()
    T, d = x32.shape[1], x32.shape[2]
    got = moe.moe_apply(p, x32, m).reshape(T, d)
    # the layer's own routes: its logits by the same product, then its router
    logits = (x32.reshape(1, T, d) @ p["router"]).float()
    _, cap = moe.dispatch_shape(m, T)
    idx, gate = (moe.topk_route(logits, m.moe.top_k) if router == "topk"
                 else moe.mwu_route(logits, m.moe.top_k, cap, m.moe.mwu_iters))
    idx, gate = idx[0], gate[0]
    xt = x32[0]
    y = torch.zeros_like(xt)
    for e in range(m.moe.n_experts):
        oe = (F.silu(xt @ p["wg"][e]) * (xt @ p["wu"][e])) @ p["wd"][e]
        for j in range(m.moe.top_k):
            sel = idx[:, j] == e
            y[sel] += gate[sel, j, None] * oe[sel]
        del oe
    diff = (got - y).abs()
    err = diff.max().item()
    ok = bool((diff <= LAYER_TOL * (1 + y.abs())).all())
    check(failures, ok, f"(b) {router}: moe_apply on layer 0's input ({T} tokens) at capacity_factor "
                        f"{m.moe.capacity_factor:g}, f32 (TF32 off), vs the per-expert loop on the card: max_abs_err "
                        f"{err:.3g} (bar {LAYER_TOL} abs and rel)")
    return dict(router=router, max_abs_err=err, within_bar=ok)


def router_rows(K, moe, logits: torch.Tensor, cfg, failures: list) -> list[dict]:
    """The router's kernels at the shapes its LP gives them, f32, each
    against its plain version: the state of the first iteration of the
    routing LP of ``logits`` (x from ``init_x``, y = Px of 49,160 rows,
    z = Cx of 6,145, the weights of both, g = P^T w_p and h = C^T w_c, the
    step direction d and its images), as ``core.mwu._iteration`` computes
    it. Softmax weights within 1e-4 (tests/test_kernels.py's f32 bar); the
    step direction (g form) and the three device-step axpys bit for bit;
    the Newton search bit for bit the host loop over the probe kernel and
    within ls_eps * alpha of its plain version. Device ms of one launch
    (CUDA graph replay; the plain search on the host clock), the bound of
    each (bytes once over HBM's rate, or the operations)."""
    import struct

    from repro_torch.core import stepsize
    from repro_torch.core.mwu import init_x, make_eta
    from repro_torch.kernels.axpy_reduce.ref import axpy_reduce_ref
    from repro_torch.kernels.linesearch_probe.ref import newton_search_ref
    from repro_torch.kernels.softmax_weights.ref import softmax_weights_ref
    from repro_torch.kernels.step_direction.ref import step_direction_ref

    m = cfg.moe
    _, cap = moe.dispatch_shape(cfg, logits.shape[0] * logits.shape[1])
    opts = moe.router_options(m.mwu_iters)
    P, C = moe.routing_ops(torch.softmax(logits[0].float(), dim=-1), m.top_k, cap)
    dt, size, tol, ls = torch.float32, 4, 1e-4, opts.ls_tol
    eta = float(torch.tensor(make_eta(P.shape[0] + C.shape[0], opts.eps, opts.eta_factor), dtype=dt))
    scale = float(torch.tensor(0.5 / eta, dtype=dt))  # mixed packing/covering: half the pure step scale
    x = init_x(P, opts.eps, dt)
    y, z = P.matvec(x), C.matvec(x)
    wp, wc = K.softmax_weights(y, eta, 1.0)[1], K.softmax_weights(z, eta, -1.0)[1]
    g, h = P.rmatvec(wp), C.rmatvec(wc)
    d, dmax = K.step_direction(h, x, scale, g=g)
    dy, dz = P.matvec(d), C.matvec(d)
    rows = []

    def row(name, shape, err, bar, ok, kernel, plain_ms, nbytes, ops, form=None):
        b_ms, b_by = bound(nbytes, ops, dt)
        r = dict(name=name, form=form, dtype="float32", shape=shape, max_abs_err=err, bar=bar, within_bar=ok,
                 ms=device_ms(kernel, 200), plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        check(failures, ok, f"router {name}{'' if form is None else f' ({form})'} float32 {shape}: max_abs_err "
                            f"{err:.3g} (bar {bar}); device ms: kernel {r['ms']:.4f}, plain {plain_ms:.4f}, bound "
                            f"{b_ms:.4f} ({b_by})")
        rows.append(r)

    for v, sign in ((y, 1.0), (z, -1.0)):
        lse, w = K.softmax_weights(v, eta, sign)
        lse_r, w_r = softmax_weights_ref(v, eta, sign)
        lse_err, w_err = abs(lse.item() - lse_r.item()), (w - w_r).abs().max().item()
        n = v.shape[0]
        row("softmax_weights", [n], max(lse_err, w_err), tol, lse_err <= tol * max(1.0, abs(lse_r.item()))
            and w_err <= tol, lambda: K.softmax_weights(v, eta, sign),
            device_ms(lambda: softmax_weights_ref(v, eta, sign), 200), 2 * n * size, 7 * n)
    n = x.shape[0]
    d_r, dmax_r = step_direction_ref(h, x, scale, g=g)
    same = torch.equal(d, d_r) and dmax.item() == dmax_r.item()
    row("step_direction", [n], (d - d_r).abs().max().item(), 0.0, same, lambda: K.step_direction(h, x, scale, g=g),
        device_ms(lambda: step_direction_ref(h, x, scale, g=g), 200), 4 * n * size, 4 * n, form="g")
    # the first iteration's search: warm start 1 (the loop's alpha_prev)
    host = stepsize._newton_step_host(y, z, dy, dz, eta, ls_eps=ls, alpha0=1.0)
    card = stepsize.newton_step(y, z, dy, dz, eta, ls_eps=ls, alpha0=1.0)
    p_alpha, _, p_completes = newton_search_ref(y, dy, z, dz, eta, ls, 1.0).tolist()
    same = (struct.pack("d", card.alpha), card.probes, card.completes) == \
        (struct.pack("d", host.alpha), host.probes, host.completes)
    bar = ls * max(card.alpha, p_alpha)
    near = card.completes == bool(p_completes) and abs(card.alpha - p_alpha) <= bar
    ny, nz = y.shape[0], z.shape[0]
    row("newton_search", [ny, nz], abs(card.alpha - p_alpha), bar, same and near,
        lambda: K.newton_search(y, dy, z, dz, eta, ls, 1.0),
        host_ms(lambda: newton_search_ref(y, dy, z, dz, eta, ls, 1.0).tolist()),
        2 * (ny + nz) * size, 9 * (ny + nz) * (card.probes + 1))
    rows[-1]["probes"] = card.probes
    step = torch.tensor([card.alpha], dtype=torch.float64, device=x.device)
    for a, da in ((x, d), (y, dy), (z, dz)):
        buf, red = torch.empty_like(a), torch.empty(2, dtype=torch.float64, device=a.device)
        got, mn, mx = K.axpy_reduce(a, da, step, out=buf, red=red)
        out_r, mn_r, mx_r = axpy_reduce_ref(a, da, card.alpha)
        same = torch.equal(got, out_r) and (mn.item(), mx.item()) == (mn_r.item(), mx_r.item())
        n = a.shape[0]
        row("axpy_reduce", [n], (got - out_r).abs().max().item(), 0.0, same,
            lambda: K.axpy_reduce(a, da, step, out=buf, red=red),
            device_ms(lambda: axpy_reduce_ref(a, da, card.alpha), 200), 3 * n * size, 4 * n, form="device step")
    return rows

def moe_forward(K, card: str, failures: list):
    """Phase 9: mixtral-8x22b's forward at full width on the card, cut to
    MOE_LAYERS layers, with both routers on the same seeded weights;
    ``card`` is nvidia-smi's name and power limit. Returns the phase's
    numbers and the model (phase 10 decodes with it)."""
    from dataclasses import replace

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get
    from repro_torch.models import Model
    from repro_torch.models.layers import moe

    base = get("mixtral-8x22b")
    cfg = replace(base, n_layers=MOE_LAYERS, attn_impl="pallas")
    m = cfg.moe
    B, S = 1, MOE_TOKENS
    G, cap = moe.dispatch_shape(cfg, B * S)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {cfg.n_layers} of {base.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} of d {cfg.d_head}, window {cfg.sliding_window}, {m.n_experts} experts of d_ff {m.d_ff}, "
          f"top-{m.top_k}, vocab {cfg.vocab_size}; {n_params / 1e9:.3f}B f32 params "
          f"({torch.cuda.memory_allocated() / 1e9:.1f} GB on the card), init {init_s:.1f} s; tokens {B} x {S}; "
          f"dispatch groups {G}, capacity {cap}: the routing LP has {S * m.n_experts} variables, "
          f"{m.n_experts + S * m.n_experts} packing and {S + 1} covering rows", flush=True)

    def run():
        return model({"tokens": tokens})

    out = {}
    for router in ("topk", "mwu"):
        model.cfg = replace_moe(cfg, router=router)
        with torch.inference_mode():
            run()  # warm-up: cuBLAS handles and heuristics
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            spans = _Spans(moe, ("topk_route", "mwu_route", "routing_lp", "_dispatch_group", "_combine_group",
                                 "moe_apply"), keep=("topk_route", "mwu_route", "routing_lp", "moe_apply"))
            torch.cuda.synchronize()
            try:
                with counted_reads() as reads:
                    t0 = time.perf_counter()
                    h = run()
                    torch.cuda.synchronize()
                    first_s = time.perf_counter() - t0
            finally:
                spans.restore()
            launches = K.launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h2 = run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            wall_s = float(np.median(walls))
            counted = counted_on_card(run) if router == "topk" else None  # phase 13 (b)
            digests = [sha256(h.view(torch.int16)), sha256(h2.view(torch.int16))]  # the bf16 bits
            del h2
            logits = model.logits(h[:, -1:])
            finite = bool(torch.isfinite(h).all()) and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
                run()
                torch.cuda.synchronize()
        kernels = _device_kernels(prof)
        busy = sum(k[0] for k in kernels)
        flash_ms = sum(k[0] for k in kernels if "rt::flash" in k[2])
        router_kernel_ms = sum(k[0] for k in kernels if "rt::" in k[2] and "rt::flash" not in k[2])
        mm_ms = sum(k[0] for k in kernels if any(w in k[2].lower() for w in ("gemm", "nvjet", "xmma", "cutlass")))
        cast_ms = _weight_cast_ms(prof, model)
        route_name = "mwu_route" if router == "mwu" else "topk_route"
        router_ms = spans.ms(route_name)
        dispatch_ms = sum(spans.ms("_dispatch_group")) + sum(spans.ms("_combine_group"))
        E = m.n_experts
        per_layer = []
        for a, (idx, _) in spans.calls[route_name]:
            load = moe.expert_load(idx, E).float()
            per_layer.append(dict(load_max_over_mean=(load.max() / load.mean()).item(),
                                  dropped=int(torch.clamp(load - cap, min=0).sum())))
        lp = [res for _, (_, res) in spans.calls["routing_lp"]]
        iters = [int(r.iters.sum()) for r in lp]
        info = dict(router=router, init_s=init_s, first_forward_s=first_s, wall_ms=1e3 * wall_s,
                    wall_ms_runs=[1e3 * w for w in walls], tokens_per_s=B * S / wall_s, max_memory_gb=peak_gb,
                    launches=launches, hidden_sha256=digests, hidden_finite=finite,
                    router_ms_per_layer=router_ms, mwu_iters_per_layer=iters, host_reads=reads[0],
                    host_reads_per_layer=reads[0] / cfg.n_layers, layers=per_layer,
                    profile=dict(device_busy_ms=busy, matmul_ms=mm_ms, flash_ms=flash_ms,
                                 router_kernel_ms=router_kernel_ms, dispatch_combine_ms=dispatch_ms,
                                 weight_cast_ms=cast_ms,
                                 other_ms=busy - mm_ms - flash_ms - router_kernel_ms - dispatch_ms - cast_ms,
                                 device_idle_share=1.0 - busy / (1e3 * wall_s)))
        print(f"  {router} on {card}: " + json.dumps(info), flush=True)
        info["counted"] = counted
        for ms, count, key in kernels[:14]:
            print(f"    {ms:10.2f} ms {count:7d} x  {key[:110]}", flush=True)
        check(failures, finite and list(h.shape) == [B, S, cfg.d_model],
              f"{router}: hidden states {list(h.shape)} and last-position logits finite ({finite})")
        check(failures, digests[0] == digests[1], f"(d) {router}: two forwards give the same hidden states "
                                                  f"(sha256 {digests[0][:16]}... / {digests[1][:16]}...)")
        # (f): flash once a layer; the router's kernels once (search, step
        # direction) or twice (softmax) or three times (axpy) a lane iteration
        n = sum(iters)
        want = dict(flash_attention=cfg.n_layers, newton_search=n, step_direction=n, softmax_weights=2 * n,
                    axpy_reduce=3 * n)
        got = {name: launches[name] for name in launches}
        ok = all(got[name] == want.get(name, 0) for name in got)
        check(failures, ok, f"(f) {router}: launches in one forward {json.dumps(got)}; want {json.dumps(want)} "
                            f"({n} router lane iterations over {cfg.n_layers} layers, the rest 0)")
        if router == "mwu":
            want_reads = sum(i + 2 for i in iters)  # the loop's start, one a loop iteration, its result
            check(failures, reads[0] <= want_reads,
                  f"mwu: {reads[0]} host reads in one forward ({reads[0] / cfg.n_layers:.2f} a layer; the routing "
                  f"loop's start, one a loop iteration and its result come to {want_reads})")
        out[router] = dict(info=info, h=h, routes=[i for _, (i, _) in spans.calls[route_name]],
                           logits=[a[0] for a, _ in spans.calls[route_name]], lp=lp,
                           moe_input=spans.calls["moe_apply"][0][0][1] if router == "topk" else None)
        del logits
    model.cfg = cfg

    # (e) the topk forward vs the chunked-attention forward of the same
    # module, given the flash forward's routes (each layer's experts as the
    # flash forward chose them, the gates from the chunked forward's own
    # probs): rounding in bf16 moves router logits across near-ties; the
    # same forward routing freely is printed with its route flips per layer
    topk = out["topk"]
    model.cfg = replace(replace_moe(cfg, router="topk"), attn_impl="chunked")
    route = moe.topk_route
    layer = iter(range(cfg.n_layers))

    def replay(lg, k):
        idx = topk["routes"][next(layer)]
        probs = torch.softmax(lg.float(), dim=-1)
        gate = torch.gather(probs, -1, idx)
        return idx, (gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)).to(lg.dtype)

    spans = _Spans(moe, ("topk_route",), keep=("topk_route",))
    try:
        with torch.inference_mode():
            h_free = run()
            moe.topk_route = replay
            h_same = run()
    finally:
        moe.topk_route = route
        spans.restore()
        model.cfg = cfg
    h = topk["h"].float()
    rel_same = ((h - h_same.float()).norm() / h_same.float().norm()).item()
    rel_free = ((h - h_free.float()).norm() / h_free.float().norm()).item()
    flips = [int((_route_sets(a) != _route_sets(i)).any(-1).sum())
             for a, (_, (i, _)) in zip(topk["routes"], spans.calls["topk_route"])]
    del h_free, h_same
    check(failures, rel_same <= LOGITS_REL_L2_BAR,
          f"(e) topk: vs the chunked-attention forward given the flash forward's routes: relative L2 hidden "
          f"{rel_same:.4g} (bar {LOGITS_REL_L2_BAR}); routing freely {rel_free:.4g}, with {flips} tokens routed to "
          f"other experts per layer")
    torch.cuda.empty_cache()

    # (a) every layer's routing LP, card vs CPU
    mwu = out["mwu"]
    t_a = time.perf_counter()
    lp_checks = [router_checks(moe, lg, res, cfg, i, failures) for i, (lg, res) in
                 enumerate(zip(mwu["logits"], mwu["lp"]))]
    print(f"  (a) {time.perf_counter() - t_a:.1f} s", flush=True)

    # (c) layer 0's logits as two dispatch groups: two lanes, each its own G 1 solve bit for bit
    cfg2 = replace(cfg, moe_dispatch_groups=2)
    G2, cap2 = moe.dispatch_shape(cfg2, B * S)
    lg2 = mwu["logits"][0].reshape(G2, -1, m.n_experts)
    _, both = moe.routing_lp(lg2, m.top_k, cap2, m.mwu_iters)
    lanes = []
    for g in range(G2):
        _, alone = moe.routing_lp(lg2[g:g + 1], m.top_k, cap2, m.mwu_iters)
        lanes.append(dict(x_equal=bool(torch.equal(both.x[g], alone.x[0])),
                          iters=[int(both.iters[g]), int(alone.iters[0])],
                          probes=[int(both.ls_probes[g]), int(alone.ls_probes[0])]))
    check(failures, all(ln["x_equal"] and ln["iters"][0] == ln["iters"][1] and ln["probes"][0] == ln["probes"][1]
                        for ln in lanes),
          f"(c) layer 0's logits as {G2} groups (capacity {cap2}): each lane equals its own G 1 solve bit for bit: "
          f"{json.dumps(lanes)}")

    # the router's kernels at its shapes against their plain versions
    rrows = router_rows(K, moe, mwu["logits"][0], cfg, failures)

    # the router alone, profiled: its kernels, its plain ops and the device's
    # idle time a layer (the device traced alone: tracing the host's
    # operators too would slow the host-bound loop)
    lg0 = mwu["logits"][0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        moe.mwu_route(lg0, m.top_k, cap, m.mwu_iters)
        end.record()
        torch.cuda.synchronize()
    rk = _device_kernels(prof)
    span = start.elapsed_time(end)
    r_kernels = sum(k[0] for k in rk if "rt::" in k[2])
    r_plain = sum(k[0] for k in rk if "rt::" not in k[2])
    router_alone = dict(span_ms=span, kernel_ms=r_kernels, plain_ms=r_plain, idle_ms=span - r_kernels - r_plain,
                        launches={k[2].split("(")[0][-60:]: k[1] for k in rk})
    print(f"  the router alone on layer 0's logits on {card}: {json.dumps(router_alone)}", flush=True)

    # (b) dispatch and combine at capacity_factor = E against the expert loop, f32 with TF32 off
    x0 = topk["moe_input"]
    p0 = {name: t for name, t in model.blocks[0].moe.items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            oracle = [expert_oracle_check(moe, x0, p0, cfg, r, failures) for r in ("topk", "mwu")]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for r in out.values():
        del r["h"]
    del topk, mwu
    torch.cuda.empty_cache()
    return dict(topk=out["topk"]["info"], mwu=out["mwu"]["info"], rel_l2_vs_chunked_same_routes=rel_same,
                rel_l2_vs_chunked_free=rel_free, chunked_route_flips=flips, router_lp=lp_checks, lanes=lanes,
                router_alone=router_alone, oracle=oracle, router_rows=rrows), model



# -- phase 10 ----------------------------------------------------------------
DECODE_STEPS = 16  # (a): greedy decode steps after the prefill of MOE_TOKENS tokens
DECODE_BAR = 1e-3  # (a): relative L2 of the last decode logits vs the forward's last row, f32 with TF32 off
SERVE_LENGTHS = (24, 40, 56, 64)  # (b): the engine's four prompts, one slot each
SERVE_NEW = 32  # (b): tokens generated a prompt
SERVE_MAX_LEN = 512  # (b): the engine's caches (a ring of 512 slots: below the window)


def _take_launches(K, total: dict) -> dict:
    """The launch counts since the last reset, added into ``total``; resets them."""
    got = K.launch_counts()
    for name, n in got.items():
        total[name] = total.get(name, 0) + n
    K.reset_launch_counts()
    return got


def decode_past_window(K, model, card: str, total: dict, failures: list) -> dict:
    """Phase 10 (a): prefill B 1 x MOE_TOKENS (past the window), then
    DECODE_STEPS greedy decode steps, in f32 with TF32 off, the topk router
    at capacity_factor = E; the last step's logits against the last row of
    a forward over all the tokens. Then the bf16 prefill's time."""
    from dataclasses import replace

    from repro_torch.models.common import Dtypes
    from repro_torch.models.layers import moe

    cfg9 = model.cfg
    cfg = replace(replace_moe(cfg9, router="topk", capacity_factor=float(cfg9.moe.n_experts)), dtype="float32")
    S, W, n, L, V = MOE_TOKENS, cfg.sliding_window, DECODE_STEPS, cfg.n_layers, cfg.vocab_size
    prompt = torch.randint(0, V, (1, S), generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    model.cfg, model.dt = cfg, Dtypes(cfg)
    spans = _Spans(moe, ("topk_route",), keep=("topk_route",))
    try:
        with torch.inference_mode():
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = model.prefill({"tokens": prompt}, S + n)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            prefill_launches = _take_launches(K, total)
            ring_ok = all(sorted(c.slot_pos.tolist()) == list(range(S - W, S)) for c in caches.layers)
            toks, steps, advance_ok = [], [], True
            for t in range(n):
                cur = torch.argmax(lg[:, -1, :V], dim=-1, keepdim=True)
                toks.append(cur)
                want = caches.layers[0].slot_pos.clone()
                want[(S + t) % W] = S + t
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, caches = model.decode_step(caches, cur)
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t0)
                advance_ok &= all(torch.equal(c.slot_pos, want) for c in caches.layers)
            decode_launches = _take_launches(K, total)
            del caches
            full = model.logits(model({"tokens": torch.cat([prompt] + toks, dim=1)})[:, -1:])
            forward_launches = _take_launches(K, total)
    finally:
        spans.restore()
        model.cfg, model.dt = cfg9, Dtypes(cfg9)
        torch.backends.cuda.matmul.allow_tf32 = tf32
    finite = bool(torch.isfinite(lg[..., :V]).all()) and bool(torch.isfinite(full[..., :V]).all())
    rel = ((lg[..., :V] - full[..., :V]).norm() / full[..., :V].norm()).item()
    # each layer's routes: prefill and decode steps against the forward's
    idx = [out[0][0] for _, out in spans.calls["topk_route"]]  # (T, k) a call: L prefill, n * L decode, L forward
    flips = []
    for layer in range(L):
        inc = torch.cat([idx[layer]] + [idx[L + t * L + layer] for t in range(n)], dim=0)
        flips.append(int((_route_sets(inc) != _route_sets(idx[L + n * L + layer])).any(-1).sum()))
    del full, lg, spans
    torch.cuda.empty_cache()
    # the prefill in the forward's bf16 (phase 9's config: topk at capacity 1.25)
    bf16 = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, caches = model.prefill({"tokens": prompt}, S)
            torch.cuda.synchronize()
            bf16.append(time.perf_counter() - t0)
            del caches
    bf16_launches = _take_launches(K, total)
    info = dict(prompt=[1, S], window=W, decode_steps=n, prefill_ms_f32=1e3 * prefill_s,
                decode_ms_per_step_f32=1e3 * float(np.median(steps)), prefill_ms_bf16=1e3 * float(np.median(bf16)),
                prefill_ms_bf16_runs=[1e3 * t for t in bf16], rel_l2_last_logits_vs_forward=rel,
                tokens_routed_differently_per_layer=flips, prefill_flash=prefill_launches["flash_attention"],
                prefill_flash_bf16=bf16_launches["flash_attention"],
                flash_f32=prefill_launches["flash_attention"] + forward_launches["flash_attention"])
    print(f"  (a) on {card}: " + json.dumps(info), flush=True)
    check(failures, ring_ok, f"(a) after the prefill of {S} tokens every layer's ring of {W} slots holds positions "
                             f"{S - W}..{S - 1}")
    check(failures, advance_ok, f"(a) each of {n} decode steps wrote one slot, (S + t) mod {W}, in every layer")
    check(failures, finite and rel <= DECODE_BAR,
          f"(a) the last decode step's logits vs the last row of the forward over {S + n} tokens (f32, TF32 off, "
          f"capacity E): relative L2 {rel:.4g} (bar {DECODE_BAR}); tokens routed differently a layer {flips}")
    check(failures, prefill_launches["flash_attention"] == forward_launches["flash_attention"] == L
          and bf16_launches["flash_attention"] == 3 * L and decode_launches["flash_attention"] == 0,
          f"(a) each prefill launched flash once a layer (f32 {prefill_launches['flash_attention']}, bf16 "
          f"{bf16_launches['flash_attention']} in 3), the f32 forward {forward_launches['flash_attention']} times, "
          f"the decode steps {decode_launches['flash_attention']} times")
    return info


ATTENTION_RANGE = "phase10::attention_over_cache"


def _split_step(prof, model) -> dict:
    """Phase 10 (b): one profiled decode step's device time by part."""
    from torch.autograd import DeviceType

    kernels = _device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    router = sum(k[0] for k in kernels if "rt::" in k[2] and "rt::flash" not in k[2])
    # the kernels launched inside the cache write and _sdpa_dense (a profiler range around each call)
    attention_ms = sum(e.device_time_total for e in prof.events()
                       if e.name == ATTENTION_RANGE and e.device_type == DeviceType.CPU) / 1e3
    # the expert products: the einsums' bmm calls over an expert weight, (E, d, d_ff) or (E, d_ff, d)
    E, d, f = model.cfg.moe.n_experts, model.cfg.d_model, model.cfg.moe.d_ff
    weights = ([E, d, f], [E, f, d])
    experts = sum(e.device_time_total for e in prof.events()
                  if e.name == "aten::bmm" and e.device_type == DeviceType.CPU and len(e.input_shapes) == 2
                  and list(e.input_shapes[1]) in weights) / 1e3
    casts = _weight_cast_ms(prof, model)
    return dict(device_busy_ms=busy, weight_cast_ms=casts, expert_matmul_ms=experts,
                attention_over_cache_ms=attention_ms, router_kernel_ms=router,
                other_ms=busy - casts - experts - attention_ms - router)


def _in_range(fn):
    """fn inside a profiler range named ATTENTION_RANGE."""
    def ranged(*a, **kw):
        with torch.profiler.record_function(ATTENTION_RANGE):
            return fn(*a, **kw)
    return ranged


def serve_decode(K, model, card: str, seed: int, total: dict, failures: list) -> dict:
    """Phase 10 (b): ``Engine.generate`` on the card, greedy, bf16, with
    each router on phase 9's weights."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.layers import attention as att
    from repro_torch.models.layers import moe
    from repro_torch.serve import Engine, ServeConfig

    cfg9 = model.cfg
    V, L, E = cfg9.vocab_size, cfg9.n_layers, cfg9.moe.n_experts
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, V, n).astype(np.int32) for n in SERVE_LENGTHS]
    B, maxp = len(prompts), max(SERVE_LENGTHS)
    n_steps = maxp + SERVE_NEW - 1
    padded = np.zeros((B, maxp), np.int32)  # as the engine pads them
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    out = {}
    for router in ("topk", "mwu"):
        cfg = replace_moe(cfg9, router=router)
        model.cfg = cfg
        route_name = "mwu_route" if router == "mwu" else "topk_route"
        # a hand loop of decode_step + argmax from empty caches (the engine's
        # shapes warm up here); the middle generated step profiled, with a
        # profiler range (ATTENTION_RANGE) around the attention over the cache
        with torch.inference_mode():
            toks = torch.from_numpy(padded).cuda()
            caches = model.init_caches(B, SERVE_MAX_LEN)
            for t in range(maxp):
                lg, caches = model.decode_step(caches, toks[:, t:t + 1])
            hand = []
            cur = torch.argmax(lg[:, -1, :V], dim=-1)
            for step in range(SERVE_NEW):
                if step == SERVE_NEW // 2:
                    saved = {name: getattr(att, name) for name in ("_cache_write", "_sdpa_dense")}
                    for name, fn in saved.items():
                        setattr(att, name, _in_range(fn))
                    torch.cuda.synchronize()
                    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    try:
                        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                     record_shapes=True) as prof:
                            marks[0].record()
                            lg, caches = model.decode_step(caches, cur[:, None])
                            marks[1].record()
                            torch.cuda.synchronize()
                    finally:
                        for name, fn in saved.items():
                            setattr(att, name, fn)
                    cur = torch.argmax(lg[:, -1, :V], dim=-1)
                elif step:
                    lg, caches = model.decode_step(caches, cur[:, None])
                    cur = torch.argmax(lg[:, -1, :V], dim=-1)
                hand.append(cur)
            hand = [list(c) for c in zip(*torch.stack(hand).tolist())]
            del caches
        _take_launches(K, total)
        split = _split_step(prof, model)
        check(failures, split["other_ms"] >= 0,
              f"(b) {router}: the profiled step's parts do not overlap (device busy {split['device_busy_ms']:.3f} ms, "
              f"the rest {split['other_ms']:.3f} ms)")
        # the engine, twice: the first timed a step (CUDA events around each
        # decode_step), its launches, host reads and the router's spans
        runs = []
        for run in range(2):
            eng = Engine(cfg, ServeConfig(max_len=SERVE_MAX_LEN, slots=B), device="cuda")
            eng.load(model)
            events, last = [], []
            step = model.decode_step

            def timed_step(caches, tokens):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                lg, new = step(caches, tokens)
                end.record()
                events.append((start, end))
                last[:] = [lg]
                return lg, new

            model.decode_step = timed_step
            spans = _Spans(moe, (route_name, "routing_lp"), keep=(route_name, "routing_lp"))
            K.reset_launch_counts()
            try:
                with counted_reads() as reads:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    tokens_out = eng.generate(prompts, max_new=SERVE_NEW)
                    torch.cuda.synchronize()
                    wall_s = time.perf_counter() - t0
            finally:
                del model.decode_step
                spans.restore()
            torch.cuda.synchronize()
            runs.append(dict(tokens=tokens_out, wall_s=wall_s, reads=reads[0], launches=_take_launches(K, total),
                             step_ms=[s.elapsed_time(e) for s, e in events], spans=spans,
                             logits_sha256=sha256(last[0])))
        first, second = runs
        spans = first["spans"]
        iters = [int(res.iters.sum()) for _, (_, res) in spans.calls["routing_lp"]]
        loads = torch.zeros(L, E, dtype=torch.int64)
        for i, (_, (idx, _)) in enumerate(spans.calls[route_name]):
            loads[i % L] += moe.expert_load(idx, E).cpu()
        # the tokens a step the mwu router sent to other experts than top-k would, on the same logits
        other_than_topk = sum(int((_route_sets(idx) != _route_sets(moe.topk_route(a[0], cfg.moe.top_k)[0]))
                                  .any(-1).sum()) for a, (idx, _) in spans.calls.get("mwu_route", []))
        step_ms = float(np.median(first["step_ms"]))
        router_ms = spans.ms(route_name)
        info = dict(router=router, slots=B, prompt_lengths=list(SERVE_LENGTHS), max_new=SERVE_NEW,
                    decode_steps=len(first["step_ms"]), decode_ms_per_step=step_ms,
                    decode_ms_per_step_p10_p90=[float(np.percentile(first["step_ms"], q)) for q in (10, 90)],
                    tokens_per_s=B * 1e3 / step_ms, generate_wall_s=[first["wall_s"], second["wall_s"]],
                    generated_tokens_per_s=B * SERVE_NEW / first["wall_s"],
                    router_ms_per_layer_step=float(np.median(router_ms)),
                    router_ms_per_layer_step_mean=float(np.mean(router_ms)),
                    mwu_iters_per_layer_step=float(np.mean(iters)) if iters else 0.0,
                    host_reads=first["reads"], host_reads_per_layer_step=(first["reads"] - SERVE_NEW) / (n_steps * L),
                    expert_load_per_layer=loads.tolist(), tokens_routed_other_than_topk=other_than_topk,
                    launches=first["launches"],
                    profiled_step=dict(split, step_ms=marks[0].elapsed_time(marks[1]),
                                       device_idle_share=1.0 - split["device_busy_ms"] / marks[0].elapsed_time(marks[1])),
                    logits_sha256=[first["logits_sha256"], second["logits_sha256"]])
        print(f"  (b) {router} on {card}: " + json.dumps(info), flush=True)
        for ms, count, key in _device_kernels(prof)[:10]:
            print(f"    {ms:10.3f} ms {count:5d} x  {key[:110]}", flush=True)
        check(failures, first["tokens"] == second["tokens"] and first["logits_sha256"] == second["logits_sha256"],
              f"(b) {router}: two engines give the same tokens and last logits (sha256 "
              f"{first['logits_sha256'][:16]}... / {second['logits_sha256'][:16]}...)")
        check(failures, first["tokens"] == hand,
              f"(b) {router}: the engine's tokens equal a hand loop of decode_step + argmax")
        check(failures, len(first["step_ms"]) == n_steps and len(iters) == (n_steps * L if router == "mwu" else 0),
              f"(b) {router}: {len(first['step_ms'])} decode steps ({n_steps}), {len(iters)} routing LPs")
        n = sum(iters)
        want = dict(newton_search=n, step_direction=n, softmax_weights=2 * n, axpy_reduce=3 * n)
        got = first["launches"]
        check(failures, all(got[name] == want.get(name, 0) for name in got),
              f"(b) {router}: launches in one generate {json.dumps(got)}; want {json.dumps(want)} ({n} router "
              f"lane iterations over {n_steps} steps x {L} layers; no flash, the rest 0)")
        want_reads = sum(i + 2 for i in iters) + SERVE_NEW
        check(failures, first["reads"] <= want_reads,
              f"(b) {router}: {first['reads']} host reads in one generate; the routing loops' starts, iterations "
              f"and results and one a sampled step come to {want_reads}")
        out[router] = info
        del runs, first, second, spans, prof
    model.cfg = cfg9
    return out


def moe_decode(K, model, card: str, seed: int, failures: list) -> dict:
    """Phase 10: mixtral-8x22b decode on phase 9's module (a), (b); returns
    the phase's numbers and its launches (every run of the phase is a main
    path run: prefill, decode steps, the engine)."""
    total: dict = {}
    K.reset_launch_counts()
    info = dict(prefill_decode=decode_past_window(K, model, card, total, failures))
    info["engine"] = serve_decode(K, model, card, seed, total, failures)
    info["launches"] = total
    return info

# -- phase 11 ----------------------------------------------------------------
TRAIN_LAYERS = 1  # mixtral-8x22b's 56 layers cut to 1: 2.907B f32 params, 46.5 GB with grads and AdamW moments
TRAIN_STEPS = 8  # (a): steps on one fixed batch
TRAIN_LOSS_CHUNK = 512
TRAIN_LOSS_REL = 1e-6  # (a): the first step's loss vs chunked_ce_loss of the same batch under inference_mode
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=1000)
TRAINER_STEPS, TRAINER_EVERY, TRAINER_STOP = 8, 2, 5  # (b): 8 steps, a checkpoint every 2, interrupted after 5
ATTN_RANGE = "phase11::chunked_attention"
ADAMW_RANGE = "phase11::adamw"


def _under(e, name: str) -> bool:
    while e is not None:
        if e.name == name:
            return True
        e = e.cpu_parent
    return False


def _split_train_step(prof, model) -> dict:
    """Phase 11 (a): one profiled train step's device time by part. Every
    operator's own kernels (``self_device_time_total``) go to one part:
    weight casts (a copy of a parameter's shape, both ways), expert bmm
    (a bmm with d_ff among its dims), attention (inside the chunked
    attention's range, the forward and the recompute, and the other bmm
    calls: its backward's products), the optimizer (its range), the vocab
    side (an operator with the padded vocab among its dims: the loss's head
    product, logsumexp and gather, the embedding's gather and their
    backward); the router's kernels are the ``rt::`` launches; the rest is
    what is left of the busy time."""
    from torch.autograd import DeviceType

    kernels = _device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    router = sum(k[0] for k in kernels if "rt::" in k[2])
    shapes = {tuple(p.shape) for p in model.parameters()}
    f, V = model.cfg.moe.d_ff, model.cfg.padded_vocab
    parts = dict(weight_cast_ms=0.0, expert_bmm_ms=0.0, attention_ms=0.0, optimizer_ms=0.0, vocab_ms=0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CPU or e.self_device_time_total <= 0:
            continue
        ms, dims = e.self_device_time_total / 1e3, [tuple(s) for s in (e.input_shapes or []) if s]
        if _under(e, ADAMW_RANGE):
            parts["optimizer_ms"] += ms
        elif e.name == "aten::copy_" and any(s in shapes for s in dims):
            parts["weight_cast_ms"] += ms
        elif e.name == "aten::bmm" and any(f in s for s in dims):
            parts["expert_bmm_ms"] += ms
        elif e.name == "aten::bmm" or _under(e, ATTN_RANGE):
            parts["attention_ms"] += ms
        elif any(V in s for s in dims):
            parts["vocab_ms"] += ms
    parts["router_kernel_ms"] = router
    parts["rest_ms"] = busy - sum(parts.values())
    return dict(device_busy_ms=busy, **parts)


def _ranged(fn, name: str):
    def ranged(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return ranged


def _param_digests(model) -> list[str]:
    """sha256 of every parameter's bytes, in the model's order (hashed on
    host threads; hashlib releases the GIL on large buffers)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(sha256, model.parameters()))


def _to_cpu(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return type(a)(_to_cpu(b) for b in a) if isinstance(a, (tuple, list)) else a


def _bar_err(got, plain) -> float:
    """max |kernel - plain| / (1 + |plain|): the f32 bar's measure (phase 2)."""
    got, plain = torch.as_tensor(got).detach().cpu().double(), torch.as_tensor(plain).double()
    return float(((got - plain).abs() / (1 + plain.abs())).max()) if plain.numel() else 0.0


def _newton_next(a: float, p, tiny: float) -> float:
    """The Newton search's next alpha from probe ``p`` at ``a`` (``newton_search_loop``'s step)."""
    from repro_torch.kernels.linesearch_probe.ref import fmax, fmin

    fp = fmin((p.dphi * p.psi - p.phi * p.dpsi) / fmax(p.psi * p.psi, tiny), -tiny)
    return fmax(fmin(fmax(a - (p.f - 1.0) / fp, a * 0.125), a * 8.0), 1e-12)


def router_f32_held(K, moe, logits: torch.Tensor, res_fwd, cfg, layer: int, failures: list) -> dict:
    """Phase 11 (a), mwu: the forward's f32 routing LP solved again on the
    card over the whole budget, every kernel call held against its plain
    version on the call's own inputs (copied to the CPU before the launch),
    so that card and CPU never drift apart: softmax weights, step direction
    and axpy within ROUTER_X_TOL (phase 2's f32 bar, |kernel - plain| <= bar
    (1 + |plain|)); each search launch bit for bit equal to its oracle, the
    host loop over the probe kernel, and each of that loop's probes within
    the bar of the plain probe at the same alpha; the solve's x equal to the
    forward's. Where the plain search on the same inputs takes another
    number of probes, the first probe at which the two sides part is
    printed: a comparison of the loop decided otherwise (f >= 1, min z >=
    1, Newton's |alpha' - alpha| <= ls_eps alpha) or Newton's next alpha
    further apart than ls_eps alpha; the first iteration's probes are
    printed with f, min z and Newton's next alpha from either side."""
    from repro_torch.core import mwu, smoothing, stepsize
    from repro_torch.kernels.linesearch_probe.ref import linesearch_probe2_ref, newton_search_loop, two_sided_probe_fn

    m = cfg.moe
    _, cap = moe.dispatch_shape(cfg, logits.shape[0] * logits.shape[1])
    errs = dict(softmax_weights=[], step_direction=[], axpy_reduce=[], probe=[])
    searches = []
    saved = dict(softmax=smoothing.softmax_weights, step=mwu.step_direction, axpy=mwu.axpy_reduce,
                 search=stepsize.newton_search)

    def softmax(v, eta, sign=1.0, keep=None):
        plain = saved["softmax"](_to_cpu(v), eta, sign, _to_cpu(keep))
        got = saved["softmax"](v, eta, sign, keep)
        errs["softmax_weights"].append(max(_bar_err(got[0], plain[0]), _bar_err(got[1], plain[1])))
        return got

    def step(h, x, scale, g=None, gather=None):
        plain = saved["step"](_to_cpu(h), _to_cpu(x), scale, _to_cpu(g), _to_cpu(gather))
        got = saved["step"](h, x, scale, g, gather)
        errs["step_direction"].append(max(_bar_err(got[0], plain[0]), _bar_err(got[1], plain[1])))
        return got

    def axpy(y, dy, alpha, *, out=None, red=None, keep=None):
        plain = saved["axpy"](_to_cpu(y).clone(), _to_cpu(dy), _to_cpu(alpha), keep=_to_cpu(keep))
        got = saved["axpy"](y, dy, alpha, out=out, red=red, keep=keep)
        errs["axpy_reduce"].append(max(_bar_err(a, b) for a, b in zip(got, plain)))
        return got

    def search(y, dy, z, dz, eta, ls_eps, alpha0=None, *, d_max=None, out=None, p_keep=None, c_keep=None):
        a0, tiny = float(alpha0), torch.finfo(y.dtype).tiny
        cpu_in, pk, ck = [_to_cpu(t) for t in (y, dy, z, dz)], _to_cpu(p_keep), _to_cpu(c_keep)
        buf, raw = torch.empty(6, dtype=y.dtype, device=y.device), []

        def card_sweep(a):
            got = K.linesearch_probe2(y, dy, z, dz, a, eta, out=buf, p_keep=p_keep, c_keep=c_keep).tolist()
            raw.append(got)
            return got

        def cpu_sweep(a):
            got = linesearch_probe2_ref(*cpu_in, a, eta, pk, ck)
            if raw:
                errs["probe"].append(_bar_err(raw[-1], got))
            return got.tolist()

        log = []
        on_card, on_cpu = two_sided_probe_fn(card_sweep, eta, tiny), two_sided_probe_fn(cpu_sweep, eta, tiny)

        def probe(a):
            pair = (on_card(a), on_cpu(a))
            log.append((a, *pair))
            return pair[0]

        loop = newton_search_loop(probe, tiny, ls_eps, a0)
        plain = newton_search_loop(two_sided_probe_fn(
            lambda a: linesearch_probe2_ref(*cpu_in, a, eta, pk, ck).tolist(), eta, tiny), tiny, ls_eps, a0)
        got = saved["search"](y, dy, z, dz, eta, ls_eps, alpha0, d_max=d_max, out=out, p_keep=p_keep, c_keep=c_keep)
        rec = got.tolist()
        parting = None
        for j, (a, c, p) in enumerate(log):
            nc, npl = _newton_next(a, c, tiny), _newton_next(a, p, tiny)
            tests = dict(f_ge_1=[c.f >= 1, p.f >= 1], min_z_ge_1=[c.min_z >= 1, p.min_z >= 1],
                         converged=[abs(nc - a) <= ls_eps * a, abs(npl - a) <= ls_eps * a])
            otherwise = [k for k, (on, off) in tests.items() if on != off]
            if abs(nc - npl) > ls_eps * a:  # the next probes further apart than the search's own width
                otherwise.append("next_alpha")
            if otherwise:
                parting = dict(probe=j, alpha=a, f=[c.f, p.f], min_z=[c.min_z, p.min_z], next_alpha=[nc, npl],
                               ls_eps=ls_eps, decided_otherwise=otherwise)
                break
        searches.append(dict(kernel=rec[:3], loop=list(loop), plain=list(plain), parting=parting,
                             probes=[dict(alpha=a, f=[c.f, p.f], min_z=[c.min_z, p.min_z],
                                          next_alpha=[_newton_next(a, c, tiny), _newton_next(a, p, tiny)])
                                     for a, c, p in log]))
        return got

    smoothing.softmax_weights, mwu.step_direction, mwu.axpy_reduce = softmax, step, axpy
    stepsize.newton_search = search
    try:
        _, res = moe.routing_lp(logits, m.top_k, cap, m.mwu_iters)
    finally:
        smoothing.softmax_weights, mwu.step_direction, mwu.axpy_reduce = saved["softmax"], saved["step"], saved["axpy"]
        stepsize.newton_search = saved["search"]
    same_x = torch.equal(res.x, res_fwd.x)
    worst = {k: max(v, default=0.0) for k, v in errs.items()}
    oracle = all(s["kernel"][0] == s["loop"][0] and s["kernel"][1:] == [float(s["loop"][1]), float(s["loop"][2])]
                 for s in searches)
    parted = [i for i, s in enumerate(searches) if s["plain"][1] != s["loop"][1]]
    out = dict(iters=len(searches), calls={k: len(v) for k, v in errs.items()}, max_err=worst, bar=ROUTER_X_TOL,
               search_equals_loop=oracle, same_x_as_forward=same_x,
               probes=[[int(s["kernel"][1]), int(s["plain"][1])] for s in searches], parted_at=parted,
               first_parting=next((dict(iteration=i, **searches[i]["parting"]) for i in parted
                                   if searches[i]["parting"]), None))
    print(f"  (a) layer {layer}, f32, each kernel call held on its own inputs: {json.dumps(out)}", flush=True)
    if searches:
        print(f"  (a) layer {layer}, f32, iteration 0's probes, card / plain at the same alpha (thresholds: f 1, "
              f"min z 1; next_alpha: Newton's step from each): {json.dumps(searches[0]['probes'])}", flush=True)
    check(failures, all(v <= ROUTER_X_TOL for v in worst.values()) and all(errs.values()) and oracle and same_x,
          f"(a) layer {layer}, f32: the forward's routing LP over {len(searches)} iterations, every kernel against "
          f"its plain version on the same inputs: max errors {json.dumps(worst)} (bar {ROUTER_X_TOL} (1 + |plain|)); "
          f"each search launch equal to the host loop over the probe kernel bit for bit ({oracle}); x equal to the "
          f"forward's ({same_x})")
    return out


class _LPIters:
    """Wraps ``moe.routing_lp`` until ``restore``: ``iters`` lists each
    solve's lane iterations as the device tensor it returned, read after
    the block (nothing else of a call is kept: a recompute's logits would
    hold its whole graph)."""

    def __init__(self, moe):
        self.moe, self.inner, self.iters = moe, moe.routing_lp, []

        def counted(*a, **kw):
            probs, res = self.inner(*a, **kw)
            self.iters.append(res.iters)
            return probs, res
        moe.routing_lp = counted

    def restore(self) -> None:
        self.moe.routing_lp = self.inner


def _lp_launches(K, total: dict, lps: _LPIters, what: str, failures: list) -> dict:
    """The launch counts since the last reset, added into ``total``, held
    to the routing LPs that ``lps`` saw: a lane iteration launches the
    search and the step direction once, softmax weights twice, axpy three
    times; nothing else launches."""
    got = _take_launches(K, total)
    iters = [int(t.sum()) for t in lps.iters]
    n = sum(iters)
    want = dict(newton_search=n, step_direction=n, softmax_weights=2 * n, axpy_reduce=3 * n)
    ok = all(got.get(k, 0) == want.get(k, 0) for k in set(got) | set(want))
    check(failures, ok, f"{what}: launches {json.dumps(got)}; want {json.dumps(want)} ({len(iters)} routing LPs, "
                        f"iterations {iters})")
    return got


def train_router(K, cfg, router: str, card: str, total: dict, failures: list) -> dict:
    """Phase 11 (a), one router: a fresh model from seed 0 and fresh AdamW
    state; steps on one fixed batch (the first counted, timed, held to the
    inference loss; the rest timed with CUDA events; one profiled); one
    step at B 2 in two microbatches; then the first step again from a new
    model of the same seed, which must repeat bit for bit. Launches of every
    step go into ``total``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import shapes
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Model
    from repro_torch.models.layers import attention as att
    from repro_torch.models.layers import moe
    from repro_torch.train import AdamWConfig, chunked_ce_loss, make_train_state, make_train_step
    from repro_torch.train import step as step_mod

    cfg = replace_moe(cfg, router=router)
    S = shapes.SHAPES["train_4k"].seq_len
    opt = AdamWConfig(**TRAIN_OPT)
    pipe = TokenPipeline(cfg.vocab_size, S, 1, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(0).items()}
    batch2 = {k: torch.from_numpy(v).cuda() for k, v in TokenPipeline(cfg.vocab_size, S, 2, seed=1).batch_at(0).items()}
    route_name = "mwu_route" if router == "mwu" else "topk_route"
    out = dict(router=router)

    def first_step():
        """A new model from seed 0 and its first step, counted."""
        base_gb = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        model = Model(cfg, device="cuda", seed=0)
        state = make_train_state(model)
        step_fn = make_train_step(model, opt, 1, TRAIN_LOSS_CHUNK)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        with torch.inference_mode():
            loss_inf = float(chunked_ce_loss(model, batch, TRAIN_LOSS_CHUNK))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        spans = _Spans(moe, (route_name, "routing_lp"), keep=(route_name, "routing_lp"))
        try:
            with counted_reads() as reads:
                t0 = time.perf_counter()
                state, m = step_fn(state, batch)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
        finally:
            spans.restore()
        launches = _take_launches(K, total)
        first = dict(init_s=init_s, first_step_s=first_s, loss_inference=loss_inf, loss=float(m["loss"]),
                     grad_norm=float(m["grad_norm"]), lr=m["lr"], host_reads=reads[0], launches=launches,
                     max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, allocated_before_gb=base_gb)
        return model, state, step_fn, first, spans

    model, state, step_fn, first, spans = first_step()
    out["first"] = first
    print(f"  {router}: first step {json.dumps(first)}", flush=True)
    rel = abs(first["loss"] - first["loss_inference"]) / abs(first["loss_inference"])
    check(failures, rel <= TRAIN_LOSS_REL,
          f"(a) {router}: the first step's loss {first['loss']!r} vs chunked_ce_loss under inference_mode "
          f"{first['loss_inference']!r}: relative {rel:.3g} (bar {TRAIN_LOSS_REL})")
    check(failures, np.isfinite(first["loss"]) and np.isfinite(first["grad_norm"]),
          f"(a) {router}: loss {first['loss']:.6g} and grad norm {first['grad_norm']:.6g} finite")
    # the router in the forward and the recompute (remat="full"): each layer's route twice
    calls, L = spans.calls[route_name], cfg.n_layers
    check(failures, len(calls) == 2 * L,
          f"(a) {router}: the router ran {len(calls)} times in the step (the forward and the recompute of "
          f"{L} layer(s): {2 * L})")
    out["routes"] = [idx.cpu() for _, (idx, _) in calls[:L]]  # the forward's, layer by layer
    out["router_ms"] = spans.ms(route_name)
    lp = [res for _, (_, res) in spans.calls["routing_lp"]]
    iters = [int(r.iters.sum()) for r in lp]
    n = sum(iters)
    want = dict(newton_search=n, step_direction=n, softmax_weights=2 * n, axpy_reduce=3 * n)
    ok = all(first["launches"][name] == want.get(name, 0) for name in first["launches"])
    check(failures, ok and (router == "topk" or (len(lp) == 2 * cfg.n_layers and n > 0)),
          f"(a) {router}: launches in the first step {json.dumps(first['launches'])}; want {json.dumps(want)} "
          f"({len(lp)} routing LPs, the forward's and the recompute's, iterations {iters})")
    if router == "mwu":
        # the forward runs the layers in order, the backward recomputes them in reverse
        fwd, rec = spans.calls["routing_lp"][:L], spans.calls["routing_lp"][L:][::-1]
        same = all(torch.equal(a[0], b[0]) and torch.equal(r.x, s.x) for (a, (_, r)), (b, (_, s)) in zip(fwd, rec))
        check(failures, same, "(a) mwu: the recompute's routing LP saw the forward's logits and gave its x bit for bit")
        check(failures, first["host_reads"] <= sum(i + 2 for i in iters) + 2,
              f"(a) mwu: {first['host_reads']} host reads in the step (the routing loops' iterations + 2 a solve, "
              f"+ 2: {sum(i + 2 for i in iters) + 2})")
        t_a = time.perf_counter()
        # card vs CPU solved apart: in f64 over the whole budget; in f32
        # printed, since these logits' f32 solves part at the first
        # iteration (tools/router_lp_parts.py prints it by iteration budget).
        # The f32 kernels are held call by call on the same inputs instead
        out["router_lp"] = [router_checks(moe, a[0].detach(), res, cfg, i, failures, hold_f32=False)
                            for i, (a, (_, res)) in enumerate(fwd)]
        out["router_f32_held"] = [router_f32_held(K, moe, a[0].detach(), res, cfg, i, failures)
                                  for i, (a, (_, res)) in enumerate(fwd)]
        print(f"  (a) mwu: the LPs card vs CPU in {time.perf_counter() - t_a:.1f} s", flush=True)
        del fwd, rec
    del spans, calls, lp
    K.reset_launch_counts()  # the checks' own solves are not training launches
    digests = _param_digests(model)

    # the rest of the steps on the same batch, each between CUDA events
    losses, step_ms = [first["loss"]], []
    lps = _LPIters(moe)
    try:
        for _ in range(TRAIN_STEPS - 1):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step_fn(state, batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
    finally:
        lps.restore()
    out["steps_launches"] = _lp_launches(K, total, lps, f"(a) {router}: steps 2-{TRAIN_STEPS}", failures)
    if router == "topk":  # phase 13 (b): one more step under the op counter (topk launches no kernel of the port)
        done = []
        out["counted"] = counted_on_card(lambda: done.append(step_fn(state, batch)))
        state = done.pop()[0]  # the list keeps no state alive
    med = float(np.median(step_ms))
    out.update(losses=losses, step_ms=step_ms, ms_per_step=med, tokens_per_s=S / (med / 1e3),
               grad_norms_finite=bool(np.isfinite(float(m["grad_norm"]))))
    print(f"  {router} on {card}: {json.dumps(dict(losses=losses, step_ms=step_ms, ms_per_step=med))}", flush=True)
    check(failures, all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"(a) {router}: {TRAIN_STEPS} steps on one batch: loss {losses[0]:.6g} -> {losses[-1]:.6g}")

    # one profiled step: the split, the idle share against its own time
    spans, lps = _Spans(moe, (route_name,)), _LPIters(moe)
    sdpa, update = att._sdpa_chunked, step_mod.adamw_update
    att._sdpa_chunked, step_mod.adamw_update = _ranged(sdpa, ATTN_RANGE), _ranged(update, ADAMW_RANGE)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step_fn(state, batch)
            end.record()
            end.synchronize()
    finally:
        att._sdpa_chunked, step_mod.adamw_update = sdpa, update
        lps.restore()
        spans.restore()
    _lp_launches(K, total, lps, f"(a) {router}: the profiled step", failures)
    split = _split_train_step(prof, model)
    span = start.elapsed_time(end)
    split.update(step_ms=span, device_idle_share=1.0 - split["device_busy_ms"] / span,
                 router_span_ms=sum(spans.ms(route_name)))
    out["profile"] = split
    print(f"  {router}: a profiled step on {card}: {json.dumps(split)}", flush=True)
    for ms, count, key in _device_kernels(prof)[:12]:
        print(f"    {ms:10.2f} ms {count:7d} x  {key[:110]}", flush=True)
    del prof
    check(failures, split["rest_ms"] >= 0, f"(a) {router}: the profiled step's parts do not overlap (rest "
                                           f"{split['rest_ms']:.2f} ms >= 0)")

    # B 2 in two microbatches: the loss is the mean of the two halves' losses
    with torch.inference_mode():
        halves = [float(chunked_ce_loss(model, {k: v[i:i + 1] for k, v in batch2.items()}, TRAIN_LOSS_CHUNK))
                  for i in range(2)]
    K.reset_launch_counts()  # the halves' forwards are not training launches
    lps = _LPIters(moe)
    try:
        state, m = make_train_step(model, opt, 2, TRAIN_LOSS_CHUNK)(state, batch2)
    finally:
        lps.restore()
    out["microbatch_launches"] = _lp_launches(K, total, lps, f"(a) {router}: B 2 in 2 microbatches", failures)
    mb_loss, mean = float(m["loss"]), (halves[0] + halves[1]) / 2
    out["microbatches"] = dict(loss=mb_loss, halves=halves, grad_norm=float(m["grad_norm"]))
    check(failures, abs(mb_loss - mean) <= TRAIN_LOSS_REL * abs(mean) and np.isfinite(float(m["grad_norm"])),
          f"(a) {router}: B 2 in 2 microbatches: loss {mb_loss!r} vs the halves' mean {mean!r} (relative "
          f"{abs(mb_loss - mean) / abs(mean):.3g}, bar {TRAIN_LOSS_REL}); grad norm {float(m['grad_norm']):.6g}")
    del model, state, step_fn, m
    gc.collect()
    torch.cuda.empty_cache()

    # the first step again, from a new model of the same seed
    model, state, _, again, spans = first_step()
    del spans
    digests2 = _param_digests(model)
    same = (again["loss"], again["grad_norm"], digests2) == (first["loss"], first["grad_norm"], digests)
    check(failures, same, f"(a) {router}: the first step twice from the same state: loss {again['loss']!r} / "
                          f"{first['loss']!r}, grad norm {again['grad_norm']!r} / {first['grad_norm']!r}, "
                          f"{sum(a == b for a, b in zip(digests, digests2))} of {len(digests)} parameters' sha256 "
                          f"equal")
    out["repeat"] = dict(loss=again["loss"], grad_norm=again["grad_norm"], params_equal=digests2 == digests)
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def trainer_restart(K, total: dict, failures: list) -> dict:
    """Phase 11 (b): ``Trainer`` on the card at mixtral-8x22b-mwu reduced(),
    TRAINER_STEPS steps with a checkpoint every TRAINER_EVERY, against the
    same run interrupted after TRAINER_STOP steps and restarted from its
    checkpoint: the final parameters bit for bit."""
    import tempfile

    from repro_torch.configs import get
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get("mixtral-8x22b-mwu").reduced()
    t0 = time.perf_counter()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(steps, where):
            tc = TrainerConfig(steps=steps, ckpt_every=TRAINER_EVERY, seq_len=64, global_batch=4,
                               ckpt_dir=str(Path(tmp) / where), log_every=100)
            t = Trainer(cfg, tc, device="cuda")
            t.run()
            return t

        K.reset_launch_counts()
        runs["whole"] = trainer(TRAINER_STEPS, "whole")
        runs["interrupted"] = trainer(TRAINER_STOP, "cut")
        runs["restarted"] = trainer(TRAINER_STEPS, "cut")
        launches = _take_launches(K, total)
    a, b = runs["whole"], runs["restarted"]
    same = all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
    info = dict(steps=TRAINER_STEPS, interrupted_after=TRAINER_STOP, params_equal=same,
                loss=[a.last_metrics["loss"], b.last_metrics["loss"]], launches=launches,
                seconds=time.perf_counter() - t0)
    print(f"  (b) Trainer {cfg.name}: {json.dumps(info)}", flush=True)
    check(failures, same and b.final_state.step == TRAINER_STEPS,
          f"(b) the run interrupted after {TRAINER_STOP} steps and restarted from its checkpoint ends with the "
          f"uninterrupted run's parameters bit for bit ({same}), at step {b.final_state.step}")
    check(failures, launches.get("newton_search", 0) > 0, f"(b) the router's kernels ran: {json.dumps(launches)}")
    return info


def train_phase(K, card: str, failures: list) -> dict:
    """Phase 11: (a) mixtral-8x22b at full width, one layer, both routers;
    (b) the Trainer's restart. Returns the numbers and the launches."""
    from dataclasses import replace

    from repro_torch.configs import get, shapes

    base = get("mixtral-8x22b")
    cfg = replace(base, n_layers=TRAIN_LAYERS)
    S = shapes.SHAPES["train_4k"].seq_len
    reckon = {r: reckoned(replace_moe(cfg, router=r), 1, S, "train") for r in ("topk", "mwu")}  # the dry run's
    peaks = {r: rec["memory"]["peak_bytes"] / 1e9 for r, rec in reckon.items()}
    print(f"  {cfg.name}: {cfg.n_layers} of {base.n_layers} layers, {cfg.n_params() / 1e9:.3f}B f32 params, "
          f"{cfg.dtype} compute, remat {cfg.remat}, attention {cfg.attn_impl}; B 1 x S {S} (train_4k's sequence; "
          f"its global batch 256 cut to 1); the dry run's reckoned peak {json.dumps(peaks)} GB "
          f"({json.dumps(reckon['topk']['memory'])} bytes, topk); "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before the phase", flush=True)
    total: dict = {}
    info = dict(reckoned=reckon)
    for router in ("topk", "mwu"):
        info[router] = train_router(K, cfg, router, card, total, failures)
        end_phase(f"11 (a) {router}", failures)
    routes = [int((_route_sets(a) != _route_sets(b)).any(-1).sum())
              for a, b in zip(info["topk"].pop("routes"), info["mwu"].pop("routes"))]
    info["tokens_routed_otherwise"] = routes
    print(f"  (a) tokens mwu routes to other experts than topk in the first forward, a layer: {routes}", flush=True)
    for r in ("topk", "mwu"):
        print(f"  (a) {r}: peak {info[r]['first']['max_memory_gb']:.2f} GB (reckoned {peaks[r]:.2f}); "
              f"{info[r]['ms_per_step']:.2f} ms a step, {info[r]['tokens_per_s']:.1f} tokens/s", flush=True)
    info["trainer"] = trainer_restart(K, total, failures)
    info["launches"] = total
    return info


# -- phase 12 ----------------------------------------------------------------
SSM_TOKENS = 32_768  # (a): prefill_32k's sequence; its global batch of 32 cut to 1
SSD_LOOP_BAR = 1e-4  # (a): layer 0's _ssd_chunked vs a sequential f64 recurrence, relative L2
SSM_DECODE_B = 128  # (b): decode_32k's batch
SSM_DECODE_PROMPT = 512  # (b): a step's work and state do not depend on the context: 32,768 cut to 512
SSM_DECODE_STEPS = 32
SSM_CHECK_B, SSM_CHECK_STEPS = 4, 16  # (b): the f32 check, prefill of SSM_DECODE_PROMPT then steps vs the forward
SSM_LONG_STEPS = 8  # (b): long_500k's per-step cost, B 1
LM12_TRAIN_STEPS = 8  # (c): steps on one batch; ms a step is the median of the 7 after the first
VLM_LAYERS = 4  # (d): internvl2-26b's 48 layers cut to 4 (2.70B f32 params, 10.8 GB)
VLM_DECODE_B, VLM_DECODE_TEXT, VLM_DECODE_STEPS = 4, 512, 32  # (d): after a prefill of the patches and the text
VLM_CHECK_STEPS = 8  # (d): the f32 check's decode steps
VLM_TRAIN_LAYERS = 2  # (e): cut to 2 (1.92B f32 params, ~31 GB with grads and moments)
VLM_TRAIN_STEPS = 5  # (e): ms a step is the median of the 4 after the first
# the splits' parts timed with CUDA events: (part, module attribute), the SSD's parts inside "ssd"
PHASE12_PARTS = {"ssd": "_ssd_chunked", "ssd_intra": "_ssd_intra", "ssd_states": "_ssd_states",
                 "ssd_scan": "_ssd_scan", "ssd_out": "_ssd_out", "ssd_step": "_ssd_step", "conv": "_causal_conv",
                 "norm": "apply_norm"}


def _part_spans(run, *mods) -> dict:
    """Device ms of each PHASE12_PARTS function of ``mods`` (those a module
    has) summed over its calls in one ``run()``, from CUDA events recorded
    around each call on the stream (as phase 5 (b) times the RG-LRU scan)."""
    part = {attr: key for key, attr in PHASE12_PARTS.items()}
    saved = [(mod, attr, getattr(mod, attr)) for mod in mods for attr in part if hasattr(mod, attr)]
    spans = []

    def timed(fn, key):
        def call(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            spans.append((key, start, end))
            return out
        return call

    for mod, attr, fn in saved:
        setattr(mod, attr, timed(fn, part[attr]))
    try:
        run()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    torch.cuda.synchronize()
    out = {}
    for key, start, end in spans:
        out[key] = out.get(key, 0.0) + start.elapsed_time(end)
    return out


def _split(run, model, *mods) -> tuple[dict, list]:
    """A run's device time by part: the PHASE12_PARTS of ``mods`` from CUDA
    events (``_part_spans``, one run; the SSD's rest is its span less its
    parts'); from a profiled run, the busy time, flash, the matmuls by
    kernel name (f32 ones: the SSD's einsums, inside its span; the others:
    the projections, attention's and the MLP's products, the LM head) and
    the weight casts (``_weight_cast_ms``); the rest is what is left of the
    busy time. The idle share is against the profiled run's own time (CUDA
    events around it). Returns the split and the profiled kernels."""
    from torch.profiler import ProfilerActivity, profile

    spans = _part_spans(run, *mods)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    gemm = [k for k in kernels if any(w in k[2].lower() for w in ("gemm", "nvjet", "xmma", "cutlass"))]
    f32_gemm = sum(k[0] for k in gemm if "f32" in k[2] or "sgemm" in k[2])
    split = {f"{k}_ms": v for k, v in spans.items()}
    if "ssd" in spans:
        split["ssd_rest_ms"] = spans["ssd"] - sum(spans.get(k, 0.0) for k in ("ssd_intra", "ssd_states", "ssd_scan",
                                                                            "ssd_out"))
    split.update(f32_matmul_ms=f32_gemm, matmul_ms=sum(k[0] for k in gemm) - f32_gemm,
                 weight_cast_ms=_weight_cast_ms(prof, model),
                 flash_ms=sum(k[0] for k in kernels if "rt::flash" in k[2]))
    outside = ("ssd", "ssd_step", "conv", "norm", "matmul", "weight_cast", "flash")
    split["rest_ms"] = busy - sum(split.get(f"{k}_ms", 0.0) for k in outside)
    split.update(device_busy_ms=busy, run_ms=start.elapsed_time(end))
    split["device_idle_share"] = 1.0 - busy / split["run_ms"]
    return split, kernels


def _step_events(fn, n: int) -> list[float]:
    """Device ms of each of n calls of fn() between CUDA events."""
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in marks]


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def ssm_forward(K, card: str, failures: list) -> tuple[dict, object]:
    """Phase 12 (a): mamba2-1.3b's forward at full width and depth, B 1 x S
    SSM_TOKENS, bf16 over f32 params; the SSD's share (CUDA events around
    each ``_ssd_chunked``), a profiled split, and layer 0's SSD against a
    sequential f64 recurrence. Returns the numbers and the model."""
    from repro_torch.configs import get
    from repro_torch.models import Model
    from repro_torch.models.layers import mamba2 as m2
    from repro_torch.models.layers import norms

    cfg = get("mamba2-1.3b")
    s, B, S, V = cfg.ssm, 1, SSM_TOKENS, cfg.vocab_size
    H, Q = s.n_heads(cfg.d_model), s.chunk
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    tokens = torch.randint(0, V, (B, S), generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  (a) {cfg.name}: {cfg.n_layers} ssm layers, d_model {cfg.d_model}, d_inner {s.d_inner(cfg.d_model)}, "
          f"{H} heads of {s.head_dim}, d_state {s.d_state}, chunk {Q}, vocab {cfg.vocab_size} (tied); "
          f"{n_params / 1e9:.3f}B f32 params ({torch.cuda.memory_allocated() / 1e9:.1f} GB on the card), init "
          f"{init_s:.1f} s; tokens {B} x {S}; the SSD's (B, nc, H, Q, Q) f32 tensors "
          f"{B * (S // Q) * H * Q * Q * 4 / 1e9:.2f} GB each", flush=True)

    def run():
        h = model({"tokens": tokens})
        return h, model.logits(h[:, -1:])

    with torch.inference_mode():
        run()  # warm-up: cuBLAS handles and heuristics
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        h, logits = run()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = K.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall_ms = 1e3 * float(np.median(walls))
        counted = counted_on_card(lambda: model({"tokens": tokens}))  # phase 13 (b)
        finite = bool(torch.isfinite(h).all()) and bool(torch.isfinite(logits[..., :V]).all())
        shape_ok = list(h.shape) == [B, S, cfg.d_model] and list(logits.shape) == [B, 1, cfg.padded_vocab]
        del h, logits
        ssd_spans = _event_spans(m2, "_ssd_chunked", run)
        split, kernels = _split(run, model, m2, norms)
        # layer 0's SSD inputs at this shape, from the forward's own activations
        seen, chunked = [], m2._ssd_chunked

        def record(*a):
            seen.append(a)
            return chunked(*a)

        m2._ssd_chunked = record
        try:
            model._apply_block(model.blocks[0], model.embed({"tokens": tokens}))
        finally:
            m2._ssd_chunked = chunked
        loop = ssd_vs_recurrence(*seen[0], failures)
        del seen
    ssd_ms = sum(ssd_spans)
    info = dict(config=cfg.name, batch=B, tokens=S, layers=cfg.n_layers, params=n_params, init_s=init_s,
                first_forward_s=first_s, wall_ms=wall_ms, wall_ms_runs=[1e3 * w for w in walls],
                tokens_per_s=B * S / (wall_ms * 1e-3), max_memory_gb=peak_gb, launches=launches,
                ssd_calls=len(ssd_spans), ssd_ms=ssd_ms, ssd_share=ssd_ms / wall_ms, profile=split,
                ssd_vs_recurrence=loop)
    print(f"  (a) on {card}: " + json.dumps(info), flush=True)
    info["counted"] = counted
    for ms, count, key in kernels[:12]:
        print(f"    {ms:10.2f} ms {count:7d} x  {key[:110]}", flush=True)
    check(failures, all(n == 0 for n in launches.values()), f"(a) no kernel of the port in the forward ({launches})")
    check(failures, len(ssd_spans) == cfg.n_layers,
          f"(a) the timed forward ran the SSD {len(ssd_spans)} times ({cfg.n_layers} layers): {ssd_ms:.2f} ms, "
          f"{ssd_ms / wall_ms:.1%} of the forward")
    check(failures, finite and shape_ok, f"(a) hidden states and last-position logits finite ({finite}), shapes "
                                         f"as expected ({shape_ok})")
    return info, model


def ssd_vs_recurrence(x, dt, A, Bm, Cm, chunk: int, failures: list) -> dict:
    """Phase 12 (a): ``_ssd_chunked`` (f32, TF32 off) on layer 0's inputs
    against the sequential recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t ⊗ x_t,
    y_t = C_t . h_t in f64, token by token over the whole sequence: y and
    the final state within SSD_LOOP_BAR relative L2."""
    from repro_torch.models.layers import mamba2 as m2

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y, h = m2._ssd_chunked(x, dt, A, Bm, Cm, chunk)
        t0 = time.perf_counter()
        xd, dtd, Bd, Cd = (t[0].double() for t in (x, dt, Bm, Cm))  # B 1
        S, H, P = xd.shape
        G, N = Bd.shape[1], Bd.shape[2]
        decay = torch.exp(-torch.exp(A.double()) * dtd).view(S, G, H // G, 1, 1)
        dx = (xd * dtd[..., None]).view(S, G, H // G, 1, P)
        Bd, Cd = Bd.view(S, G, 1, N, 1), Cd.view(S, G, 1, 1, N)
        hd = torch.zeros(G, H // G, N, P, dtype=torch.float64, device=x.device)
        ref = torch.empty(S, G, H // G, 1, P, dtype=torch.float64, device=x.device)
        for t in range(S):
            hd.mul_(decay[t]).addcmul_(Bd[t], dx[t])
            torch.matmul(Cd[t], hd, out=ref[t])
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    rel_y = _rel_l2(y[0], ref.view(S, H, P))
    rel_h = _rel_l2(h[0], hd.view(H, N, P))
    out = dict(shape=[1, S, H, P], d_state=N, groups=G, chunk=chunk, rel_l2_y=rel_y, rel_l2_state=rel_h,
               max_abs_y=ref.abs().max().item(), loop_s=loop_s)
    check(failures, rel_y <= SSD_LOOP_BAR and rel_h <= SSD_LOOP_BAR,
          f"(a) layer 0's _ssd_chunked (f32) vs a sequential f64 recurrence over {S} tokens, H {H}, P {P}, N {N}: "
          f"relative L2 y {rel_y:.3g}, final state {rel_h:.3g} (bar {SSD_LOOP_BAR}); the loop {loop_s:.1f} s")
    return out


def ssm_decode(K, model, card: str, failures: list) -> dict:
    """Phase 12 (b) on (a)'s model: prefill B SSM_DECODE_B x SSM_DECODE_PROMPT,
    SSM_DECODE_STEPS greedy steps in bf16 (CUDA events), a profiled step and
    the SSD step's share; B 1 steps (long_500k's per-step cost); the f32
    check at B SSM_CHECK_B against the forward; ``Engine.generate`` at 4
    slots."""
    from dataclasses import replace

    from repro_torch.models.common import Dtypes
    from repro_torch.models.layers import mamba2 as m2
    from repro_torch.models.layers import norms
    from repro_torch.serve import Engine, ServeConfig

    cfg, V = model.cfg, model.cfg.vocab_size
    Bd, P, n = SSM_DECODE_B, SSM_DECODE_PROMPT, SSM_DECODE_STEPS
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (b) {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before; B {Bd}: the SSM state "
          f"{Bd * cfg.n_layers * m2.init_ssm_state(cfg, 1, device='meta').ssm.numel() * 4 / 1e9:.2f} GB", flush=True)
    prompt = torch.randint(0, V, (Bd, P), generator=torch.Generator(device="cuda").manual_seed(4), device="cuda")
    out = {}
    with torch.inference_mode():
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = model.prefill({"tokens": prompt}, P + n)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        state_gb = sum(c.ssm.nbytes + c.conv.nbytes for c in caches.layers) / 1e9
        box = [lg, caches]

        def step():
            cur = torch.argmax(box[0][:, -1, :V], dim=-1, keepdim=True)
            box[0], box[1] = model.decode_step(box[1], cur)

        steps = _step_events(step, n)
        ssd_spans = _event_spans(m2, "_ssd_step", step)
        split, kernels = _split(step, model, m2, norms)
        finite = bool(torch.isfinite(box[0][..., :V]).all())
        del box, lg, caches
        torch.cuda.empty_cache()
        step_ms = float(np.median(steps))
        out.update(batch=Bd, prompt=P, prefill_ms=1e3 * prefill_s, state_gb=state_gb, decode_steps=n,
                   decode_ms_per_step=step_ms, decode_ms_runs=steps, decode_tokens_per_s=Bd * 1e3 / step_ms,
                   ssd_step_ms=sum(ssd_spans), ssd_step_share=sum(ssd_spans) / step_ms, profiled_step=split)

        # long_500k's per-step cost: B 1 (a step's work does not depend on the context's length)
        lg, caches = model.prefill({"tokens": prompt[:1]}, P + SSM_LONG_STEPS)
        box = [lg, caches]
        long_steps = _step_events(step, SSM_LONG_STEPS)
        out.update(long_b1_ms_per_step=float(np.median(long_steps)), long_b1_ms_runs=long_steps)
        del box, lg, caches

        # the f32 check (TF32 off): prefill and SSM_CHECK_STEPS steps vs the forward's last row
        cfg32 = replace(cfg, dtype="float32")
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        model.cfg, model.dt = cfg32, Dtypes(cfg32)
        try:
            p4 = prompt[:SSM_CHECK_B]
            lg, caches = model.prefill({"tokens": p4}, P + SSM_CHECK_STEPS)
            toks = []
            for _ in range(SSM_CHECK_STEPS):
                toks.append(torch.argmax(lg[:, -1, :V], dim=-1, keepdim=True))
                lg, caches = model.decode_step(caches, toks[-1])
            del caches
            full = model.logits(model({"tokens": torch.cat([p4] + toks, dim=1)})[:, -1:])
        finally:
            model.cfg, model.dt = cfg, Dtypes(cfg)
            torch.backends.cuda.matmul.allow_tf32 = tf32
        rel = _rel_l2(lg[..., :V], full[..., :V])
        finite32 = bool(torch.isfinite(lg[..., :V]).all()) and bool(torch.isfinite(full[..., :V]).all())
        del lg, full
        out["rel_l2_f32_last_step_vs_forward"] = rel

    # the serving engine at 4 slots, bf16, phase 10's prompt lengths
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, V, m).astype(np.int32) for m in SERVE_LENGTHS]
    eng = Engine(cfg, ServeConfig(max_len=SERVE_MAX_LEN, slots=4), device="cuda")
    eng.load(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = eng.generate(prompts, max_new=SERVE_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches_all = K.launch_counts()
    engine_steps = max(SERVE_LENGTHS) + SERVE_NEW - 1
    out.update(engine=dict(slots=4, prompts=list(SERVE_LENGTHS), new=SERVE_NEW, decode_steps=engine_steps,
                           wall_s=gen_s, ms_per_step=1e3 * gen_s / engine_steps,
                           generated_tokens_per_s=4 * SERVE_NEW / gen_s), launches=launches_all)
    print(f"  (b) on {card}: " + json.dumps(out), flush=True)
    for ms, count, key in kernels[:8]:
        print(f"    {ms:10.3f} ms {count:5d} x  {key[:110]}", flush=True)
    check(failures, finite and finite32 and rel <= DECODE_BAR,
          f"(b) f32 (TF32 off): the last of {SSM_CHECK_STEPS} decode steps after a prefill of {SSM_CHECK_B} x {P} "
          f"vs the last row of a forward over {P + SSM_CHECK_STEPS} tokens: relative L2 {rel:.4g} (bar {DECODE_BAR})")
    check(failures, len(ssd_spans) == cfg.n_layers,
          f"(b) a decode step ran the SSD step {len(ssd_spans)} times ({cfg.n_layers} layers)")
    check(failures, [len(g) for g in gen] == [SERVE_NEW] * 4 and all(0 <= t < V for g in gen for t in g),
          f"(b) Engine.generate: {SERVE_NEW} tokens a prompt, in the vocab")
    check(failures, all(v == 0 for v in launches_all.values()), f"(b) no kernel of the port launched ({launches_all})")
    return out


def lm_train(K, cfg, batch: dict, steps: int, card: str, what: str, failures: list, *mods) -> dict:
    """Phase 12 (c)/(e): a fresh model of ``cfg`` from seed 0 and fresh AdamW
    state (TRAIN_OPT), ``steps`` steps on ``batch`` (the first counted and
    timed on the host, the rest between CUDA events), one more step's split
    (``_split`` over the parts of ``mods``: their spans in the forward and
    the recompute), then the first step again from a new model of the same
    seed, which must give the same loss, grad norm and sha256 of every
    parameter."""
    from repro_torch.models import Model
    from repro_torch.train import AdamWConfig, make_train_state, make_train_step

    opt = AdamWConfig(**TRAIN_OPT)
    B, S = batch["targets"].shape
    reckon = reckoned(cfg, B, S, "train")  # the dry run's
    print(f"  {what} {cfg.name}: {cfg.n_layers} layers at full width, {cfg.n_params() / 1e9:.3f}B f32 params, "
          f"{cfg.dtype} compute, remat {cfg.remat}, attention {cfg.attn_impl}; B {B} x S {S}; the dry run's "
          f"reckoned peak {reckon['memory']['peak_bytes'] / 1e9:.2f} GB ({json.dumps(reckon['memory'])} bytes); "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before", flush=True)

    def first_step():
        base_gb = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        model = Model(cfg, device="cuda", seed=0)
        state = make_train_state(model)
        step_fn = make_train_step(model, opt, 1, TRAIN_LOSS_CHUNK)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        return model, state, step_fn, dict(init_s=init_s, first_step_s=time.perf_counter() - t0,
                                           loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                           allocated_before_gb=base_gb)

    model, state, step_fn, first = first_step()
    digests = _param_digests(model)
    box, seen = [state], []

    def step():
        box[0], m = step_fn(box[0], batch)
        seen.append(m["loss"])

    step_ms = _step_events(step, steps - 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = K.launch_counts()
    counted = counted_on_card(step)  # phase 13 (b)
    seen.pop()
    losses = [first["loss"]] + [float(x) for x in seen]
    split, kernels = _split(step, model, *mods)
    del model, state, step_fn, box
    gc.collect()
    torch.cuda.empty_cache()
    model, state, _, again = first_step()
    same = _param_digests(model) == digests and (again["loss"], again["grad_norm"]) == (first["loss"],
                                                                                        first["grad_norm"])
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    ms = float(np.median(step_ms))
    out = dict(config=cfg.name, layers=cfg.n_layers, batch=B, seq=S, first=first, losses=losses, ms_per_step=ms,
               ms_runs=step_ms, tokens_per_s=B * S / (ms * 1e-3), max_memory_gb=peak,
               reckoned_peak_gb=reckon["memory"]["peak_bytes"] / 1e9, launches=launches, repeats_bit_for_bit=same,
               profiled_step=split)
    print(f"  {what} on {card}: " + json.dumps(out), flush=True)
    out.update(reckoned=reckon, counted=counted)
    for kms, count, key in kernels[:8]:
        print(f"    {kms:10.2f} ms {count:7d} x  {key[:110]}", flush=True)
    check(failures, same, f"{what} the first step from a new model of the same seed repeats bit for bit (loss "
                          f"{again['loss']!r} | {first['loss']!r}, sha256 of every parameter)")
    check(failures, bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"{what} {steps} steps on one batch: losses finite and falling, {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(failures, all(v == 0 for v in launches.values()), f"{what} no kernel of the port launched ({launches})")
    return out


def vlm_forward(K, card: str, failures: list) -> dict:
    """Phase 12 (d): internvl2-26b at full width, VLM_LAYERS layers, flash
    attention (``pallas``), bf16 over f32 params: the forward over
    n_vision_patches patches and the text of SSM_TOKENS positions against
    the same module's chunked forward; then prefill and text-only decode."""
    from dataclasses import replace

    from repro_torch.configs import get
    from repro_torch.models import Model
    from repro_torch.models.layers import norms

    base = get("internvl2-26b")
    cfg = replace(base, n_layers=VLM_LAYERS, attn_impl="pallas")
    B, S, npt, V, L = 1, SSM_TOKENS, cfg.n_vision_patches, cfg.vocab_size, cfg.n_layers
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = {"patches": torch.randn(B, npt, cfg.d_model, generator=gen, device="cuda") * 0.02,
             "tokens": torch.randint(0, V, (B, S - npt), generator=gen, device="cuda")}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  (d) {cfg.name}: {L} of {base.n_layers} layers at full width, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads over {cfg.n_kv_heads} of d {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.3f}B f32 params ({torch.cuda.memory_allocated() / 1e9:.1f} GB on the card), init "
          f"{init_s:.1f} s; {npt} patches and {S - npt} tokens", flush=True)

    def run():
        h = model(batch)
        return h, model.logits(h[:, -1:])

    with torch.inference_mode():
        run()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        h, logits = run()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = K.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall_ms = 1e3 * float(np.median(walls))
        counted = counted_on_card(lambda: model(batch))  # phase 13 (b)
        finite = bool(torch.isfinite(h).all()) and bool(torch.isfinite(logits[..., :V]).all())
        model.cfg = replace(cfg, attn_impl="chunked")  # the same module: no second copy of the weights
        h_ref, logits_ref = run()
        model.cfg = cfg
        rel_h, rel_logits = _rel_l2(h, h_ref), _rel_l2(logits[..., :V], logits_ref[..., :V])
        del h, logits, h_ref, logits_ref
        split, kernels = _split(run, model, norms)
        K.reset_launch_counts()
    info = dict(config=cfg.name, layers=L, batch=B, patches=npt, tokens=S, params=n_params, init_s=init_s,
                first_forward_s=first_s, wall_ms=wall_ms, wall_ms_runs=[1e3 * w for w in walls],
                tokens_per_s=B * S / (wall_ms * 1e-3), max_memory_gb=peak_gb, launches=launches,
                rel_l2_hidden_vs_chunked=rel_h, rel_l2_logits_vs_chunked=rel_logits, profile=split)
    print(f"  (d) on {card}: " + json.dumps(info), flush=True)
    info["counted"] = counted
    for ms, count, key in kernels[:10]:
        print(f"    {ms:10.2f} ms {count:7d} x  {key[:110]}", flush=True)
    check(failures, launches["flash_attention"] == L and all(v == 0 for k, v in launches.items()
                                                             if k != "flash_attention"),
          f"(d) flash_attention launched {launches['flash_attention']} times in one forward ({L} layers), no other "
          f"kernel of the port ({launches})")
    check(failures, finite and rel_h <= LOGITS_REL_L2_BAR and rel_logits <= LOGITS_REL_L2_BAR,
          f"(d) vs the chunked-attention forward: relative L2 hidden {rel_h:.4g}, last logits {rel_logits:.4g} "
          f"(bar {LOGITS_REL_L2_BAR}), finite {finite}")
    info["decode"] = vlm_decode(K, model, card, failures)
    info["flash_launches"] = launches["flash_attention"] + info["decode"]["flash_launches"]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return info


def vlm_decode(K, model, card: str, failures: list) -> dict:
    """Phase 12 (d)'s decode on its model: prefill VLM_DECODE_B x (patches +
    VLM_DECODE_TEXT tokens), VLM_DECODE_STEPS text-only greedy steps in bf16
    (CUDA events); then in f32 with TF32 off the prefill and VLM_CHECK_STEPS
    steps against the forward's last row."""
    from dataclasses import replace

    from repro_torch.models.common import Dtypes

    cfg, V, L = model.cfg, model.cfg.vocab_size, model.cfg.n_layers
    Bd, T, n, npt = VLM_DECODE_B, VLM_DECODE_TEXT, VLM_DECODE_STEPS, cfg.n_vision_patches
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompt = {"patches": torch.randn(Bd, npt, cfg.d_model, generator=gen, device="cuda") * 0.02,
              "tokens": torch.randint(0, V, (Bd, T), generator=gen, device="cuda")}
    with torch.inference_mode():
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = model.prefill(prompt, npt + T + n)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = K.launch_counts()
        K.reset_launch_counts()
        box = [lg, caches]

        def step():
            cur = torch.argmax(box[0][:, -1, :V], dim=-1, keepdim=True)
            box[0], box[1] = model.decode_step(box[1], cur)

        steps = _step_events(step, n)
        decode_launches = K.launch_counts()
        finite = bool(torch.isfinite(box[0][..., :V]).all())
        del box, lg, caches
        cfg32 = replace(cfg, dtype="float32")
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        model.cfg, model.dt = cfg32, Dtypes(cfg32)
        try:
            K.reset_launch_counts()
            lg, caches = model.prefill(prompt, npt + T + VLM_CHECK_STEPS)
            toks = []
            for _ in range(VLM_CHECK_STEPS):
                toks.append(torch.argmax(lg[:, -1, :V], dim=-1, keepdim=True))
                lg, caches = model.decode_step(caches, toks[-1])
            del caches
            full = model.logits(model({"patches": prompt["patches"],
                                       "tokens": torch.cat([prompt["tokens"]] + toks, dim=1)})[:, -1:])
            f32_launches = K.launch_counts()
            K.reset_launch_counts()
        finally:
            model.cfg, model.dt = cfg, Dtypes(cfg)
            torch.backends.cuda.matmul.allow_tf32 = tf32
    rel = _rel_l2(lg[..., :V], full[..., :V])
    finite32 = bool(torch.isfinite(lg[..., :V]).all()) and bool(torch.isfinite(full[..., :V]).all())
    del lg, full
    step_ms = float(np.median(steps))
    out = dict(batch=Bd, patches=npt, text=T, prefill_ms=1e3 * prefill_s, decode_steps=n, decode_ms_per_step=step_ms,
               decode_ms_runs=steps, decode_tokens_per_s=Bd * 1e3 / step_ms, rel_l2_f32_last_step_vs_forward=rel,
               launches=dict(prefill=prefill_launches, decode=decode_launches, f32=f32_launches),
               flash_launches=prefill_launches["flash_attention"] + f32_launches["flash_attention"],
               flash_f32_launches=f32_launches["flash_attention"])
    print(f"  (d) decode on {card}: " + json.dumps(out), flush=True)
    check(failures, finite and finite32 and rel <= DECODE_BAR,
          f"(d) f32 (TF32 off): the last of {VLM_CHECK_STEPS} text-only steps after a prefill of {Bd} x ({npt} patches "
          f"+ {T} tokens) vs the last row of the forward: relative L2 {rel:.4g} (bar {DECODE_BAR})")
    check(failures, prefill_launches["flash_attention"] == L and f32_launches["flash_attention"] == 2 * L
          and all(v == 0 for v in decode_launches.values()),
          f"(d) the prefill launched flash {prefill_launches['flash_attention']} times ({L} layers), the f32 prefill "
          f"and forward {f32_launches['flash_attention']} (2 x {L}), the decode steps no kernel ({decode_launches})")
    return out


def lm_phase(K, card: str, failures: list) -> dict:
    """Phase 12: mamba2-1.3b (a) forward, (b) decode, (c) training;
    internvl2-26b (d) forward and decode, (e) training. Returns the numbers
    and every kernel's launches in its counted runs."""
    from dataclasses import replace

    from repro_torch.configs import get, shapes
    from repro_torch.data import TokenPipeline
    from repro_torch.models.layers import mamba2 as m2
    from repro_torch.models.layers import norms

    info = {}
    t = time.perf_counter()
    info["ssm_forward"], model = ssm_forward(K, card, failures)
    end_phase("12 (a)", failures)
    info["ssm_decode"] = ssm_decode(K, model, card, failures)
    end_phase("12 (b)", failures)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (a), (b): {time.perf_counter() - t:.1f} s", flush=True)

    S = shapes.SHAPES["train_4k"].seq_len  # train_4k's sequence; its global batch of 256 cut to 1
    cfg = get("mamba2-1.3b")
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenPipeline(cfg.vocab_size, S, 1, seed=0).batch_at(0).items()}
    info["ssm_train"] = lm_train(K, cfg, batch, LM12_TRAIN_STEPS, card, "(c)", failures, m2, norms)
    end_phase("12 (c)", failures)
    print(f"  (c): {time.perf_counter() - t:.1f} s", flush=True)

    info["vlm_forward"] = vlm_forward(K, card, failures)
    end_phase("12 (d)", failures)
    print(f"  (d): {time.perf_counter() - t:.1f} s", flush=True)

    cfg = replace(get("internvl2-26b"), n_layers=VLM_TRAIN_LAYERS)
    npt = cfg.n_vision_patches
    gen = torch.Generator(device="cuda").manual_seed(8)
    batch = {"patches": torch.randn(1, npt, cfg.d_model, generator=gen, device="cuda") * 0.02,
             "tokens": torch.randint(0, cfg.vocab_size, (1, S - npt), generator=gen, device="cuda"),
             "targets": torch.randint(0, cfg.vocab_size, (1, S), generator=gen, device="cuda"),
             "loss_mask": torch.ones(1, S, device="cuda")}
    batch["loss_mask"][:, :npt] = 0.0  # no loss on the patches' positions
    info["vlm_train"] = lm_train(K, cfg, batch, VLM_TRAIN_STEPS, card, "(e)", failures, norms)
    end_phase("12 (e)", failures)
    info["flash_launches"] = info["vlm_forward"]["flash_launches"]
    print(f"  (e): {time.perf_counter() - t:.1f} s", flush=True)
    return info


# -- phase 13 ----------------------------------------------------------------
DRYRUN_ARCHS = ("mixtral-8x22b", "mixtral-8x22b-mwu", "mamba2-1.3b", "internvl2-26b")  # the configs of phases 9-12
DRYRUN_WORKERS = 8  # (a): the cells run in this many processes (the host's 8 cores)
COUNT_REL = 0.01  # (b): FLOPs and HBM bytes, the dry run's count vs the counter around the card's run
PEAK_REL = 0.15  # (b): the dry run's peak vs the run's max_memory_allocated (less what was allocated before it)


def _worker_init(src: str) -> None:
    sys.path.insert(0, src)
    torch.set_num_threads(1)


def _dryrun_cell(job: tuple) -> dict:
    from repro_torch.launch import dryrun

    return dryrun.run_mwu_cell(job[2]) if job[0] == "mwu-graph" else dryrun.run_cell(*job)


def dryrun_phase(card: str, moe9: dict, train11: dict, lm12: dict, failures: list) -> dict:
    """Phase 13: (a) the dry run's cells of the configs phases 9-12 run, on
    both production meshes, in DRYRUN_WORKERS processes on the host; (b) its
    counts on a (1, 1) mesh at the shapes phases 9, 11 and 12 ran against
    the op counter around those runs on the card (FLOPs and HBM bytes within
    COUNT_REL), and its reckoned peaks against the phases' measured ones
    (within PEAK_REL); (c) each run's roofline lower bound against its
    measured time (a share over 1 fails: the count leaves out work)."""
    import concurrent.futures
    import multiprocessing
    from dataclasses import replace

    from repro_torch.configs import get
    from repro_torch.configs.shapes import SHAPES, skip_reason
    from repro_torch.launch.dryrun import summary
    from repro_torch.utils.roofline import PEAK_FLOPS

    print(f"  on {card}", flush=True)
    t0 = time.perf_counter()
    jobs = [(a, s, m) for s in ("prefill_32k", "train_4k", "decode_32k", "long_500k") for a in DRYRUN_ARCHS
            for m in ("single", "pod2")] + [("mwu-graph", "match", m) for m in ("single", "pod2")]
    src = str(Path(__file__).resolve().parent / "src")
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(DRYRUN_WORKERS, mp_context=ctx, initializer=_worker_init,
                                                initargs=(src,)) as pool:
        recs = list(pool.map(_dryrun_cell, jobs))
    cells = {}
    for (a, s, m), rec in zip(jobs, recs):
        reason = None if a == "mwu-graph" else skip_reason(get(a), SHAPES[s])
        ok = rec.get("ok") if reason is None else rec.get("reason") == reason
        check(failures, bool(ok), f"(a) {a} / {s} / {m}: " + (summary(rec) if rec.get("ok") else
                                                              f"skipped: {rec.get('reason')}"))
        cells[f"{a}/{s}/{m}"] = rec
    print(f"  (a) {len(jobs)} cells in {time.perf_counter() - t0:.1f} s", flush=True)

    # (b), (c): each run as the dry run counts it and as the card ran it
    moe_cfg = replace(get("mixtral-8x22b"), n_layers=MOE_LAYERS, attn_impl="pallas")
    vlm_cfg = replace(get("internvl2-26b"), n_layers=VLM_LAYERS, attn_impl="pallas")
    t9, t11, ssm, vlm = moe9["topk"], train11["topk"], lm12["ssm_train"], lm12["vlm_train"]

    def step_peak(first: dict, peak_gb: float) -> float:  # the run's peak less what was allocated before its model
        return peak_gb - first["allocated_before_gb"]

    # (name, the dry run's record, the card's counts, the phase's ms, the phase's peak GB)
    runs = [("9: mixtral-8x22b forward", reckoned(moe_cfg, 1, MOE_TOKENS, "forward"), t9["counted"], t9["wall_ms"],
             None),
            ("11 (a): mixtral-8x22b train step, topk", train11["reckoned"]["topk"], t11["counted"], t11["ms_per_step"],
             step_peak(t11["first"], t11["first"]["max_memory_gb"])),
            ("11 (a): mixtral-8x22b train step, mwu", train11["reckoned"]["mwu"], None, None,
             step_peak(train11["mwu"]["first"], train11["mwu"]["first"]["max_memory_gb"])),
            ("12 (a): mamba2-1.3b forward", reckoned(get("mamba2-1.3b"), 1, SSM_TOKENS, "forward"),
             lm12["ssm_forward"]["counted"], lm12["ssm_forward"]["wall_ms"], None),
            ("12 (c): mamba2-1.3b train step", ssm["reckoned"], ssm["counted"], ssm["ms_per_step"],
             step_peak(ssm["first"], ssm["max_memory_gb"])),
            ("12 (d): internvl2-26b forward", reckoned(vlm_cfg, 1, SSM_TOKENS, "forward"),
             lm12["vlm_forward"]["counted"], lm12["vlm_forward"]["wall_ms"], None),
            ("12 (e): internvl2-26b train step", vlm["reckoned"], vlm["counted"], vlm["ms_per_step"],
             step_peak(vlm["first"], vlm["max_memory_gb"]))]
    out = {"cells": cells, "runs": {}}
    for name, rec, card_counts, ms, peak in runs:
        row = {"reckoned_peak_gb": rec["memory"]["peak_bytes"] / 1e9, "flops": rec["counts"]["flops"],
               "hbm_bytes": rec["counts"]["hbm_bytes"], "kernel_calls": rec["counts"]["kernel_calls"]}
        if card_counts is not None:
            rel_f = abs(rec["counts"]["flops"] - card_counts["flops"]) / card_counts["flops"]
            rel_b = abs(rec["counts"]["hbm_bytes"] - card_counts["hbm_bytes"]) / card_counts["hbm_bytes"]
            row.update(card_flops=card_counts["flops"], card_hbm_bytes=card_counts["hbm_bytes"],
                       card_kernel_calls=card_counts["kernel_calls"], flops_rel=rel_f, bytes_rel=rel_b)
            check(failures, rel_f <= COUNT_REL and rel_b <= COUNT_REL,
                  f"(b) {name}: FLOPs {rec['counts']['flops']:.6g} (dry run) vs {card_counts['flops']:.6g} (card), "
                  f"relative {rel_f:.3g}; HBM bytes {rec['counts']['hbm_bytes']:.6g} vs "
                  f"{card_counts['hbm_bytes']:.6g}, relative {rel_b:.3g} (bar {COUNT_REL})")
        if peak is not None:
            rel_p = (row["reckoned_peak_gb"] - peak) / peak
            row.update(measured_peak_gb=peak, peak_rel=rel_p)
            check(failures, abs(rel_p) <= PEAK_REL,
                  f"(b) {name}: reckoned peak {row['reckoned_peak_gb']:.3f} GB vs max_memory_allocated "
                  f"{peak:.3f} GB (less what was allocated before the run), {rel_p:+.1%} (bar {PEAK_REL:.0%})")
        if ms is not None:
            r = rec["roofline"]
            share = r["step_time_lb_s"] * 1e3 / ms
            row.update(measured_ms=ms, step_time_lb_ms=r["step_time_lb_s"] * 1e3, roofline_share=share,
                       bottleneck=r["bottleneck"], mfu_upper_bound=r.get("mfu_upper_bound"),
                       mfu=rec["model_flops"]["total"] / (ms * 1e-3 * PEAK_FLOPS))
            check(failures, share <= 1.0,
                  f"(c) {name}: roofline lower bound {r['step_time_lb_s'] * 1e3:.2f} ms ({r['bottleneck']}; compute "
                  f"{r['compute_s'] * 1e3:.2f}, memory {r['memory_s'] * 1e3:.2f}) vs measured {ms:.2f} ms: share "
                  f"{share:.1%}; MFU {row['mfu']:.1%} (bound {r.get('mfu_upper_bound', 0):.1%})")
        out["runs"][name] = row
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 13 runs: {json.dumps(out['runs'])}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-users", type=int, default=480_189, help="users of the full-size bmatch graph")
    ap.add_argument("--serve-requests", type=int, default=12, help="requests of phase 6's serving run")
    ap.add_argument("--seed", type=int, default=0, help="seed of phase 10's prompts")
    ap.add_argument("--dist-rank", type=int, default=None, help=argparse.SUPPRESS)  # phase 8 (b)'s ranks
    ap.add_argument("--dist-dir", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    if args.dist_rank is not None:
        return dist_rank(args.dist_rank, args.dist_dir)
    from repro_torch import kernels as K
    from repro_torch.kernels import loader
    from repro_torch.kernels.axpy_reduce.ref import axpy_reduce_ref
    from repro_torch.kernels.incidence_gather.ref import incidence_gather_ref
    from repro_torch.kernels.incidence_scatter.ref import incidence_scatter_ref
    from repro_torch.kernels.linesearch_probe.ref import linesearch_probe2_ref
    from repro_torch.kernels.softmax_weights.ref import softmax_weights_ref
    from repro_torch.kernels.step_direction.ref import step_direction_ref
    from repro_torch.core.mwu import make_eta

    t_start = time.perf_counter()
    print("== phase 1: card and build", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    lib, build_s = loader.build()
    print(f"  nvcc build of {len(list(loader.CSRC.glob('*.cu')))} sources: {build_s:.1f} s -> {lib.name}", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)

    print("== phase 2: kernels vs plain versions on the card", flush=True)
    refs = dict(incidence_gather=incidence_gather_ref, softmax_weights=softmax_weights_ref,
                linesearch_probe2=linesearch_probe2_ref, axpy_reduce=axpy_reduce_ref,
                incidence_scatter=incidence_scatter_ref, step_direction=step_direction_ref)
    n_vertices, n_items, n_edges = 497_959, 17_770, 98_609_647  # the full-size bmatch graph
    eta = float(make_eta(n_vertices + 1, EPS))
    failures: list = []
    rows = []
    for dtype in (torch.float32, torch.float64):
        rows += kernel_rows(K, refs, n_vertices, n_items, n_edges, dtype, eta, failures)
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain attention's products in full f32
    rows += flash_rows(K, smi, failures)
    end_phase("2", failures)

    print("== phase 3: full-size bmatch solve", flush=True)
    info, bmatch, graph = full_solve(args.n_users, failures)
    end_phase("3", failures)

    print("== phase 4: small solves, card vs CPU", flush=True)
    small_launches = small_solves(failures)
    batch_solves(failures)
    binary_launches = binary_solves(failures)
    end_phase("4", failures)

    print("== phase 5: (a) hubert-xlarge encoder forward at full width", flush=True)
    enc = encoder_forward(K, failures)
    torch.cuda.empty_cache()
    print("== phase 5: (b) recurrentgemma-9b forward at full width and depth", flush=True)
    hybrid = hybrid_forward(K, smi, failures)
    end_phase("5", failures)

    print("== phase 6: graph-LP serving at card size (lpserve)", flush=True)
    serve = serve_requests(args.serve_requests, failures)
    end_phase("6", failures)

    print("== phase 7: the paper's comparison studies at full width (Table 3, Figure 3)", flush=True)
    t7 = time.perf_counter()
    table3(bmatch, info["bound"], failures)
    lo, hi = bmatch.lo, bmatch.hi
    del bmatch
    torch.cuda.empty_cache()
    figure3(graph, failures)
    print(f"  phase 7: {time.perf_counter() - t7:.1f} s", flush=True)
    end_phase("7", failures)

    print("== phase 8: the distributed solve (repro_torch.dist) on the card", flush=True)
    t8 = time.perf_counter()
    ident = identity_plan_solve(graph, lo, hi, info, failures)
    end_phase("8 (a)", failures)
    dist8 = dist_solve(graph, lo, hi, info["exact"], failures)
    print(f"  phase 8: {time.perf_counter() - t8:.1f} s", flush=True)
    end_phase("8", failures)
    del graph
    torch.cuda.empty_cache()

    print(f"== phase 9: {MOE_LAYERS} layers of mixtral-8x22b at full width, both routers (MoE, the MWU LP router)",
          flush=True)
    t9 = time.perf_counter()
    moe9, moe_model = moe_forward(K, smi, failures)
    print(f"  phase 9: {time.perf_counter() - t9:.1f} s", flush=True)
    end_phase("9", failures)

    print("== phase 10: mixtral-8x22b decode on phase 9's module (KV cache, prefill, the serving engine)", flush=True)
    t10 = time.perf_counter()
    decode10 = moe_decode(K, moe_model, smi, args.seed, failures)
    del moe_model
    torch.cuda.empty_cache()
    print(f"  phase 10: {time.perf_counter() - t10:.1f} s", flush=True)
    end_phase("10", failures)

    print(f"== phase 11: training on the card: {TRAIN_LAYERS} layer of mixtral-8x22b at full width, both routers; "
          "the Trainer's restart", flush=True)
    t11 = time.perf_counter()
    train11 = train_phase(K, smi, failures)
    print(f"  phase 11: {time.perf_counter() - t11:.1f} s", flush=True)
    end_phase("11", failures)

    print("== phase 12: mamba2-1.3b (the ssm block kind) and internvl2-26b (vision_text) forward, decode and "
          "training", flush=True)
    t12 = time.perf_counter()
    lm12 = lm_phase(K, smi, failures)
    print(f"  phase 12: {time.perf_counter() - t12:.1f} s", flush=True)
    end_phase("12", failures)

    print("== phase 13: the dry run (repro_torch.launch) held against the card", flush=True)
    t13 = time.perf_counter()
    dryrun_phase(smi, moe9, train11, lm12, failures)
    print(f"  phase 13: {time.perf_counter() - t13:.1f} s", flush=True)
    end_phase("13", failures)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)

    # one entry per kernel: for the MWU kernels their float64 row at the
    # solve's largest shape and the solve's launches (the binary search's and
    # the lone probe's from phase 4's binary-rule solves, where the probe
    # runs inside the search: 0; the gather's from its six Newton solves:
    # bmatch gathers inside step_direction); for flash attention row (a) in
    # bf16 and the launches of one forward of each of phase 5's models, row
    # (d) with recurrentgemma's launches (phase 5 (b), and (c)'s prefill),
    # row (c) with mixtral's in bf16 (phases 9 and 10) and row (c) f32 with
    # phase 10 (a)'s f32 prefill and forward; every entry adds phase 9's and
    # phase 10's launches
    kernels = []
    for name, (source, replaces) in K.KERNELS.items():
        if name == "flash_attention":
            r = next(r for r in rows if r["name"] == name and r["case"] == "a" and r["dtype"] == "bfloat16")
            launches = (enc["launches"][name] + hybrid["launches"][name] + hybrid["decode"]["launches"][name]
                        + lm12["flash_launches"])
        else:
            r = max((r for r in rows if r["name"] == name and r["dtype"] == "float64"
                     and r.get("form") in (None, MAIN_FORM.get(name))), key=lambda r: r["shape"][0])
            launches = {"linesearch_probe": binary_launches, "binary_search": binary_launches,
                        "incidence_gather": small_launches}.get(name, info["launches"])[name]
        moe_launches = moe9["topk"]["launches"][name] + moe9["mwu"]["launches"][name] + decode10["launches"][name]
        train_launches = train11["launches"].get(name, 0)
        launches += (serve["launches"][name] + ident["launches"][name] + dist8["launches"][name] + moe_launches
                     + train_launches)
        masked = min((m for m in rows if name in MASKED_FORM and m["name"] == name and m["dtype"] == "float64"
                      and m.get("form") == MASKED_FORM[name]), key=lambda m: m["shape"][0], default=None)
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                            serving_launches=serve["launches"][name], moe_launches=moe_launches,
                            train_launches=train_launches,
                            dist_launches=dict(identity=ident["launches"][name], ranks=dist8["launches"][name]),
                            **{k: r.get(k) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms", "call_ms", "plain_call_ms", "shape", "dtype", "bar",
                                                     "within_bar", "form")},
                            masked=None if masked is None else {k: masked.get(k) for k in (
                                "form", "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}))
        router = [{k: rr.get(k) for k in ("form", "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")} for rr in moe9["router_rows"] if rr["name"] == name]
        if router:  # the MWU kernels at the router's shapes (f32) and phase 9's launches
            kernels[-1]["router"] = dict(launches=moe_launches, rows=router)
        if name == "flash_attention":
            d = next(r for r in rows if r["name"] == name and r["case"] == "d" and r["dtype"] == "bfloat16")
            rg_launches = hybrid["launches"][name] + hybrid["decode"]["launches"][name]
            kernels[-1]["recurrentgemma"] = dict(launches=rg_launches, **{k: d.get(k) for k in (
                "shape", "dtype", "max_abs_err", "rel_l2", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "config")})
            e = next(r for r in rows if r["name"] == name and r["case"] == "e")
            vlm = lm12["vlm_forward"]
            kernels[-1]["internvl2"] = dict(
                launches=lm12["flash_launches"], forward=vlm["launches"][name],
                prefill=vlm["decode"]["launches"]["prefill"][name], f32=vlm["decode"]["flash_f32_launches"],
                **{k: e.get(k) for k in ("shape", "dtype", "max_abs_err", "rel_l2", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms", "config")})
            f32_launches = decode10["prefill_decode"]["flash_f32"]
            for key, dtype, n in (("mixtral", "bfloat16", moe_launches - f32_launches),
                                  ("mixtral_f32", "float32", f32_launches)):
                c = next(r for r in rows if r["name"] == name and r["case"] == "c" and r["dtype"] == dtype)
                kernels[-1][key] = dict(launches=n, **{k: c.get(k) for k in (
                    "shape", "dtype", "max_abs_err", "rel_l2", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "config")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
