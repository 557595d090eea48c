#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels CHECKOUT   # phase 7, phase 10,
        # phase 15's kernel part and B7b's time at the training shape
        # (beside SDPA's backward) alone, on the kernels of another
        # checkout (a parent commit unpacked with git archive), measured as
        # below; prints no result lines
    python3 chip_smoke.py --steps CHECKOUT     # host and device ms per
        # steady step of every MD cell of phase 16, in its pipeline mode
        # and the other, through another checkout's default path (a
        # same-call comparison of commits); prints no result lines
    python3 chip_smoke.py --serve              # phases 1, 2 and 17 alone;
        # prints no result lines
    python3 chip_smoke.py --drill              # phases 1, 2 and 18 alone;
        # prints no result lines
    python3 chip_smoke.py --train              # phases 1, 2 and 19 alone;
        # prints no result lines
    python3 chip_smoke.py --moe                # phases 1, 2 and 20 alone;
        # prints no result lines
    python3 chip_smoke.py --ssm                # phases 1, 2 and 21 alone;
        # prints no result lines
    python3 chip_smoke.py --ssm-train          # phases 1, 2 and 22 alone;
        # prints no result lines
    python3 chip_smoke.py --encdec             # phases 1, 2 and 23 alone;
        # prints no result lines
    python3 chip_smoke.py --vlm                # phases 1, 2 and 24 alone;
        # prints no result lines
    python3 chip_smoke.py --dryrun             # phases 1, 2 and 25 alone;
        # prints no result lines

The MD engine issues each block as a CUDA graph by default on the card
(``capture="block"``: the first block of a shape runs eagerly, the next
captures, later ones replay), so every MD phase runs the captured path;
its profiles and timed blocks come after two untimed blocks, so they
time replays.

Phases, each asserting (any failure exits non-zero with no result line):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc for
   sm_90a, printing the ptxas register / shared-memory / spill lines
   and any warning (a wgmma serialization among them);
3. kernels: ``halo_pack.pack`` and ``halo_pack.unpack_add`` against their
   plain PyTorch forms at the exact shapes of the grappa-45k main path
   (f32 payload, int32 index exchange, f32 force return; unpack_add with
   the plan's inverse maps) plus f64 cases, bitwise; timed with CUDA
   events beside the plain form, a one-call PyTorch yardstick and the
   byte bound; per case the host us per call with no sync (kernel and
   yardstick, ``perf_counter`` over 1,000 calls, then one sync), the
   device operations per launch from a CUDA graph capture of 10 calls
   (each kernel must be one operation a launch: B2 copies nothing
   before its kernel) and the device us per launch from torch.profiler
   ("not measured" when no session records every launch); the host
   us of each way to read the current stream, each checked to follow
   ``torch.cuda.stream(s)``; the host us of each part of one B1 call
   (checks, allocation, ctypes, launch) beside the whole call and
   ``index_select``;
4. a small reference: a 300-atom system on the card against the O(N^2)
   direct-force oracle and against the same run on the CPU;
5. the main path: grappa-45k (45,000 atoms) on a 2x2x2 virtual domain
   mesh, ``HaloSpec(backend="pallas")``, f32, ``simulate(40)`` (two
   nstlist=20 blocks with a rebin / migration between them), with the
   kernels' launch counters zeroed just before and read just after (and
   no inverse map built by ``unpack_add``: the plan passes its own); then
   the same run with ``backend="serialized"``, which must be bitwise equal;
6. a torch.profiler (CUPTI) window over steady steps: device time by
   kernel, the halo kernels' device time per launch, device busy share;
   the steady dense block must copy nothing from the host (no ``Memcpy
   HtoD``, no ``cudaStreamSynchronize``), and its host ms per step with
   the force pass's constants built per call (as before they were
   cached) against now, in turns;
7. the pruned kernels: ``nonbonded.pair_forces`` and
   ``nonbonded.scatter_accum`` against their plain forms at the six tier
   shapes of the grappa-45k pruned schedule (taken from the engine's own
   first prune): pair forces to 5e-6 of the force scale and PE to 5e-6
   relative in f32 (1e-12 in the f64 case), the same bits on a second
   run, the scatter bitwise; timed beside the plain form, the library
   call where one exists and the bound; per tier and kernel the device us
   per launch (torch.profiler) and its share of the bound, and the device
   operations per launch from a CUDA graph capture (must be its one
   kernel); per kernel one f32 step's events and device ms beside the
   bound; then every tier again with the received halo slab NaN'd (the
   ``halo_corrupt`` fault): ``pair_forces``' non-finite entries exactly
   where its plain form's are and its finite ones within 5e-6 of the
   scale, ``scatter_accum`` carrying the NaNs where its plain form does
   with its finite sums bitwise;
8. the pruned main path: grappa-45k, 2x2x2, ``HaloSpec(backend="pallas")``,
   ``force_backend="pallas"``, ``simulate(40)`` with all four kernels'
   counters zeroed just before and read just after; the first force pass
   against the dense pass (5e-6 of the force scale), NVE, migration, the
   ``serialized`` halo bitwise equal; then ``nstprune=5`` for 40 steps,
   which drives the rolling prune on the card;
9. the profile of a steady pruned step, as in 6;
10. the signal kernels: ``halo_pack.put_signal`` at every launch shape of
    the grappa-45k ``"signal"`` path (the three forward dims' f32 payload,
    the int32 ``cell_i`` exchange, the three reverse dims' f32 forces,
    then the reverse pulses at widths (2,2,2)) plus a 3x2x1 mesh along
    both axes and both shifts, and ``halo_pack.fused_pulses`` at the
    forward shapes of widths (2,2,2) / pulses (2,2,2), f32 and int32, and
    two crafted maps, 1,000 launches back to back each: one whose second
    pulse forwards rows of the first and has padding, and a three-pulse
    one whose pulses 1 and 2 forward from their first rows; all bitwise
    against the plain forms, with every arrival word equal to its chunk
    count (fused_pulses: the counters and the block ticket too); each
    put_signal shape also 200 launches back to back, the payload and
    every arrival word checked on the device after each; exactly one
    kernel node and one memset node a launch in a CUDA graph capture at
    every shape of both kernels and both crafted maps, put_signal in both
    forms (the wire form as float32 -> bfloat16 at the f32 shapes);
    timed beside the plain form, the library yardstick and the byte
    bound, with each shape's device us per launch (torch.profiler) and
    its share of the bound, and one step's launches summed;
11. the signal main path: grappa-45k, 2x2x2, f32, ``simulate(40)`` with
    ``HaloSpec(backend="signal")`` and ``pipeline="double_buffer"`` at
    depths 2, 3, 4 and depth 2 with ``overlap_rebin``; widths (2,2,2) /
    pulses (2,2,2); and the pruned path (``force_backend="pallas"``,
    ``nstprune=5``) at depth 3 and depth 2 with ``overlap_rebin``; each
    run with every kernel counter zeroed just before and read just
    after, bitwise equal in PE, KE, momentum, final state and migration
    (and, pruned, the schedule) to ``serialized`` / ``off`` in this
    process, NVE and migration bars as in 5;
12. the profile of a steady signal / double_buffer step (dense, pruned,
    and dense at widths (2,2,2) / pulses (2,2,2)), as in 6, and the host
    ms per steady step of off against double_buffer, in turns;
13. ``flash_attention``: the kernel against its plain form and the
    float64 oracle at the serve path's launch shape (BH = 4 x 8, L = S =
    1024, G = 2, hd = 128) in bf16 and f32, non-causal, ragged L = S =
    1000, hd 64 and hd 16 (L != S), and whisper-small's three shapes (G
    1, hd 64, BH 96: the encoder's L = S = 1500 and the cross attention's
    L 224 against S 1500, non-causal; the decoder's L = S = 448, causal);
    at the serve shape also against the plain form at the bf16 kernel's
    own tiling (``kernel_tiling``); the serve shape and whisper's timed in
    bf16 beside the plain form, SDPA as the yardstick and the bound;
    ``cuobjdump -sass`` of the built library must show HGMMA (tensor-core)
    instructions in every bf16 kernel;
14. the LM serving path: qwen3-1.7b at full width and depth (28 layers,
    2,031,739,904 parameters, bf16 compute, random weights from a seeded
    generator), ``BatchServer`` serving two waves of 4 requests (1024-token
    prompts, 32 new tokens) with every kernel counter zeroed just before
    and read just after (``flash_attention`` 56 = 28 layers x 2 prefills);
    all 32 teacher-forced decode logits against no-cache prefill of the
    same prefix (bf16 tolerance); prefill ms per wave, decode ms per token,
    tok/s, peak memory and a profiled wave; and a full-width model cut to
    2 layers in f32 on the card (kernel) against the CPU (plain form),
    TF32 off;
15. compressed halo payloads (``wire_dtype``) on grappa-45k in float64:
    the converting ``pack`` (B1w) and ``put_signal`` (B3w) at every
    forward launch shape of the f64 pallas / signal paths (f64 rows to
    f32), bitwise against their plain forms, timed beside the plain form,
    ``index_select`` + ``.to`` (+ ``roll``) and the byte bound, with the
    device us per launch and its share of the bound (B3w: one kernel node
    and one memset node a launch in a graph capture); every other
    conversion (f64 -> bf16 / f16, f32 -> bf16 / f16) on a crafted
    near-tie tensor at row widths 160, 10 and 6 (16-byte, 8-byte and
    element wire words), with ``1 + 2**-11 + 2**-40`` -> float16 rounded
    once;
    ``simulate(40)`` for each of None, float32, bfloat16, float16 and
    int8_ef through pallas / off, signal / double_buffer depth 2 and
    serialized / off (pruned forces), every counter zeroed just before
    and read just after: B1w launched on the pallas runs, B3w on the
    signal runs, the three bitwise equal per format, float32 unlike the
    dense payload, bfloat16 within 1e-1, NVE and migration bars; a dense
    pallas run at bfloat16 against its serialized twin; ``int8`` refused
    at build and built under ``verify="warn"``; each format's drift over
    200 steps held to the reference's classification; a profiled steady
    block per format (the converting kernels' device us per launch);
    host ms per steady step for the dense payload, bfloat16 and int8_ef,
    in turns;
16. step graphs: every MD cell (dense and pruned pallas, nstprune 0
    and 5; signal double_buffer at depths 2-4 with overlap_rebin; signal
    w2p2; f64 float32 / int8_ef wires through pallas and signal) runs
    ``simulate(40)`` on the default, captured path and with
    ``capture="off"``, bitwise equal in PE, KE, momentum, final state,
    migration and schedule, with the same launch counts and at least
    20 replayed steps; per cell the captures and replays (with each
    capture's ms), the steady block's host ms per step, its device ms per
    step, busy share and kernels per step (torch.profiler), the host API
    launches per step and one step graph's nodes;
17. MD serving (``SimServer``, replica lanes batched into one launch per
    kernel): (a) the ``--md`` defaults, 8 x 200-atom replicas in bucket
    256 on mesh (1,1,1), 40 steps at nstlist 10, dense and pruned
    ``pallas`` x ``off`` / ``double_buffer`` with the ``pallas`` halo,
    every lane bitwise equal to its solo run (``layout_atoms``, and
    pruned ``static_ladder``) in ``cell_f`` and ``cell_i``, one compiled
    shape, and a second wave of 8 on the warm shape capturing nothing;
    one 4-lane block launching each kernel as often as one solo block;
    (c) one NaN lane among three quarantined with a ``ReplicaFault``, its
    co-residents bitwise; (b) 4 grappa-45k replicas (seeds 0-3,
    ``box_atoms=45_000``) on the 2x2x2 mesh, bucket 45,000, 20-step
    blocks, 40 steps, pruned ``pallas`` with the ``pallas`` then the
    ``signal`` halo, every lane bitwise; replicas/s, step p50 / p99,
    captures and replays per shape; one 4-lane block's launches as one
    solo block's; the 4-lane batch's host and device ms per step beside
    the 4 solo runs', in turns.  Every drive runs with the kernel
    counters zeroed just before and read just after.
18. the self-healing MD runtime (``ResilientMDRunner``): grappa-45k f32 on
    2x2x2, ``HaloSpec(backend="signal")``, ``double_buffer`` depth 3,
    pruned ``pallas`` forces, ``nstprune=5``, 60 steps (three nstlist-20
    blocks), ``inject=True, health=True`` on the captured path, every
    drive with the kernel counters zeroed just before and read just
    after: (a) the disarmed runner bitwise equal to ``simulate(60)``
    (``cell_f``, ``cell_i``, ``pe``, ``ke``), health all zero, checkpoints
    [0, 20, 40, 60], the same launches and the same kernel nodes in
    every cached step graph as the plain engine's; host ms a step in
    turns (simulate, runner, runner, simulate) and each part of a
    checkpoint save (export, D2H, npz, fsync, sha256) with its bytes;
    (b) one-shot ``halo_corrupt`` at 27, ``force_nan`` at 43 and
    ``signal_drop`` at 7, each detected in its block with the
    reference's kind, one rollback, bitwise on (a), with its restore and
    run ms; (c) the same plan twice, the same report; (d) sticky
    ``signal_drop``: rollback, rollback, degrade ``serialized_halo``,
    bitwise on (a); sticky ``force_nan``: rollback, rollback, degrade
    ``dense_forces``, finite, atoms conserved, NVE spread < 5e-3 per
    atom; (e) ``inner_overflow`` at 0 and 20: two engine fallbacks, one
    warning, ``inner_disabled`` [False, True, True]; (f) ``proc_kill`` at
    40 and a fresh runner resuming bitwise; (g) ``device_loss`` at 40
    resharded onto (2, 2, 1) within 1e-4 (positions; velocities of their
    scale), ``DeviceLost`` without a spare; ``memory_reserved`` after (d)
    and (g); (h) ``trace=True`` bitwise with replayed step graphs, its
    ``obs/*`` counters equal to a host recount of the ledger.
19. training: (a) ``cuobjdump -sass`` of B7b: HGMMA in every bf16 dK / dV
    and dQ kernel at every head_dim, no atomic instruction in any
    backward kernel; B7b (``flash_attention_backward``) against its plain
    form (autograd through ``flash_attention_plain``) and the float64
    oracle at the training shape (BH = 4 x 8, L = S = 1024, G = 2, hd =
    128) in bf16 and f32, non-causal, ragged L = S = 1000, hd 64 and hd
    16 (L != S), and whisper-small's three shapes (phase 13's; each timed
    in bf16 beside the plain backward, SDPA's backward and the bound),
    each error a share of the oracle's max |grad| (2e-2 /
    2e-5 against the plain form, 0.06 / 2e-5 against the oracle); two
    launches bitwise equal; the forward's ``_lse`` entry's out bitwise
    equal to the serving entry's; timed beside the plain form, SDPA's
    backward and the bound; (b) qwen3-1.7b at full width and depth
    trained through ``launch.train.main`` (batch 4 x seq 1024, AdamW as
    the launcher sets it, 6 steps): two fresh runs bitwise equal (losses,
    grad norms, a digest of every parameter); at full width cut to 1
    layer (``--n-layers 1``: the checkpoint's I/O, 24.4 GB at full depth,
    took 211 s of a 1,186 s smoke), a run with a checkpoint every 3 steps
    killed after step 4 by ``--fail-at-step`` and resumed, equal to an
    uninterrupted 1-layer run; ``flash_attention`` / B7b launches = layers x
    (forward + remat recompute) / 28 x microbatches x steps; (c) a 2-layer
    full-width f32 model's loss and every gradient on the card (kernels)
    against the CPU (plain forms), 1e-4 of each leaf's max, TF32 off;
    (d) ms a step, tokens/s, peak memory, a profiled step, B7b's device us
    a launch beside SDPA's backward.
20. Mixture-of-Experts (olmoe-1b-7b: 16 q and 16 kv heads, 64 experts,
    top-8): (a) B7 at its prefill shape (BH = 4 x 16, L = S = 1024, G = 1,
    hd = 128, causal, bf16) against its plain form and the f64 oracle at
    phase 13's bars, and B7b at the same shape against its plain backward
    and the oracle at phase 19's, bitwise on repeat, each timed beside its
    plain form, SDPA (its backward) and the bound; (b) olmoe-1b-7b at
    full width and depth (6,919,100,416 parameters, bf16 compute, random
    weights from a seeded generator) served by ``BatchServer``, two waves
    of 4 x (1024 + 32) tokens, every kernel counter zeroed just before and
    read just after (``flash_attention`` 16 x 2, nothing else); the
    capacity dispatch's dropped assignments in the served prefills; every
    teacher-forced decode step (which drops nothing; the cache from a
    dense prefill) against a no-cache prefill through the ``dense``
    oracle: in bf16 printed with each layer's routing flips and the logit
    move of one bf16 ulp on the embeddings (~1x: not held), in f32 at
    full width held, 1e-3 of max |logit| where the routing agrees and at
    most 5 % of decode tokens routed otherwise; prefill ms, decode ms a
    step, tok/s, peak memory, a profiled prefill; a 1-layer full-width
    f32 prefill on the card against the CPU (1e-4), the same top-k
    experts in both asserted first and the smallest gap between a
    token's k-th and (k+1)-th router logit printed; (c)
    olmoe-1b-7b at full width cut to 4 of 16 layers (f32 state for 16
    does not fit 80 GB) trained through ``launch.train.main`` (4 x 1024
    tokens, lr 3e-3, warmup 10, 6 steps, no checkpoints) twice: one digest
    of losses, ``ce``, ``moe_lb``, ``moe_z``, grad norms and parameters;
    ``flash_attention`` 4 x 2 x 6 and B7b 4 x 6 launches a run; ms a step,
    tokens/s, peak memory; a 1-layer full-width f32 loss (its aux terms
    too) and every gradient on the card against the CPU (1e-4 of each
    leaf's max), the same routing asserted first.
21. state-space models: (a) rwkv6-3b at full width and depth
    (3,073,313,280 parameters, f32 parameters from a seeded generator,
    bf16 compute) served by ``BatchServer``, two waves of 4 x (1024 + 32)
    tokens with every kernel counter zeroed just before and read just
    after (no kernel launched: ``flash_attention`` 0); prefill ms a wave,
    decode ms a step, tok/s, peak memory, a profiled prefill and decode
    step (device ms by kernel, kernels a call, busy share); the first 8
    teacher-forced decode steps against a no-cache prefill in bf16 (held
    at 5e-2 of max |logit| unless one bf16 ulp on the embeddings already
    moves the logits further) and in f32 at full width (1e-3); a 1-layer
    full-width f32 prefill and 4 decode steps, card vs CPU (1e-4); (b) B7
    at jamba's prefill shape (BH = 4 x 8, L = S = 1024, G = 4, hd = 128,
    causal, bf16) against its plain form (2e-2), timed beside SDPA and the
    bound; jamba-v0.1-52b at full width cut to one of its four 8-layer
    units (13,295,235,072 parameters, bf16 parameters) served the same way
    (``flash_attention`` 2: one attention layer a wave), the capacity
    dispatch's drops (644 slots an expert), timings and profiles; the bf16
    model freed, the unit in f32: the first 8 teacher-forced decode steps
    against a no-cache ``dense`` prefill (1e-3 where the routing agrees, at
    most 5 % of the tokens routed otherwise), held where one f32 ulp on the
    embeddings moves the logits less than 1e-3, else printed and held on
    the unit drawn at each leaf's fan-in scale; one full-width Mamba layer
    (d_inner 8192) in f32, a 4 x 1024 prefill from a seeded state and 4
    decode steps, card vs CPU (1e-4).
22. state-space training: (a) in f32 with TF32 off, on 2 x 300 tokens,
    one rwkv6-3b layer at full width (the 1-layer LM's loss and every
    gradient; the WKV recurrence crosses a 256-token block) and one Mamba
    layer at jamba's width (every gradient; three chunks of 100) on the
    card against the CPU, 1e-4 of each leaf's max; (b) rwkv6-3b at full
    width and depth trained through ``launch.train.main`` on phase 19's
    schedule (4 x 1024 tokens, 6 steps, no checkpoints) twice: losses,
    grad norms and a parameter digest bitwise equal and finite, no kernel
    launched (the model has no attention); ms a step, tokens/s, peak
    memory, one profiled step split into the WKV Function's forward, its
    checkpoint recompute and its backward, and into the recurrences'
    ``addcmul`` launches, GEMMs and the rest; (c) jamba-v0.1-52b at full
    width, one 8-layer unit, as one card's share of 8-way expert
    parallelism (``expert_share=(0, 8)``: 2 of 16 experts held a MoE layer,
    every token routed over all 16, no exchange; 3,430,232,064 parameters
    drawn at each leaf's fan-in scale) through ``make_train_step`` and
    ``run_training`` on the same schedule twice: bitwise equal and finite,
    ``flash_attention`` 2 x 6 and B7b 6 launches a run and nothing else;
    ms a step, tokens/s, peak memory, the capacity dispatch's drops; (d)
    B7b at jamba's G = 4 training shape (BH = 4 x 8, L = S = 1024, hd 128,
    causal, bf16) against its plain backward and the f64 oracle at phase
    19's bars, bitwise on repeat, timed beside SDPA's backward and the
    bound.
23. the encoder-decoder, whisper-small at full width and depth
    (278,301,696 parameters, 12 + 12 layers, G 1, hd 64): (a) served
    through ``launch.steps``' programs, ``make_prefill_step`` and
    ``make_decode_step`` sharing one bf16-weight model at the reference's
    init (seeded), 8 requests of 1,500 seeded frames and a 224-token
    prompt: the prefill program with every kernel counter zeroed just
    before and read just after (``flash_attention`` 36: 12 encoder, 12
    decoder self, 12 cross; nothing else), ``EncDec.prefill`` into a
    448-slot cache (its last logits bitwise the program's), 32 greedy
    steps of the decode program (no kernel: ``decode_attention`` is an
    einsum); prefill ms (time to first token), ms a decode step, tok/s,
    peak memory, a profiled prefill and decode step; every decode step
    teacher-forced against a no-cache prefill of the same prefix, bf16
    (5e-2 of max |logit|) and f32 (1e-3), each held where one ulp on the
    embeddings moves the logits less, else printed and then held on the
    layer weights redrawn at fan-in scale (random whisper at the
    reference's init is chaotic: one f32 ulp moves its logits 6.6e-2 of
    their max); one encoder and one decoder layer in f32 at fan-in scale,
    prefill and 4 decode steps card vs CPU (1e-4); (b) trained through ``make_train_step`` (8 x (1,500
    frames + 449 tokens), remat ``"nothing"``, AdamW lr 3e-3 warmup 10,
    6 steps, no checkpoints) twice: losses, grad norms and a parameter
    digest bitwise equal and finite, ``flash_attention`` 72 and B7b 36
    launches a step and nothing else; ms a step, tokens/s, peak memory, a
    profiled step; one layer each in f32 drawn at fan-in scale, loss and
    every gradient card vs CPU (1e-4 of each leaf's max; the key biases,
    whose gradient is zero, of their layer's ``bv``).  Logits are
    compared over the real vocabulary (51,865 of 51,968 columns: the
    padded ones hold -1e30).
24. VLM prefixes, internvl2-26b (48 layers, d 6144, 48 q heads over 8 kv
    heads: G = 6, hd 128, 256 prefix rows): (a) B7 at its prefill shape
    (BH = 4 x 8, L = S = 512, G 6, causal, bf16) against its plain form
    and the f64 oracle at phase 13's bars and bitwise on repeat, B7b at the
    same shape against its plain backward and the oracle at phase 19's,
    each timed beside its plain form, SDPA (its backward) and the bound;
    (b) served at full width and depth (19,862,722,560 parameters, bf16
    weights at the reference's init, seeded) through ``make_prefill_step``
    / ``make_decode_step`` sharing one model, 4 requests of 256 seeded
    prefix rows and a 256-token prompt: the prefill program with every
    kernel counter zeroed just before and read just after
    (``flash_attention`` 48, nothing else), ``LM.prefill`` into a 544-slot
    cache (bitwise the program's), 32 greedy decode steps from slot 512
    (no kernel); prefill ms, ms a decode step, tok/s, peak memory, a
    profiled prefill and decode step; 8 teacher-forced decode steps
    against no-cache prefills in bf16 (5e-2 of max |logit|, held where one
    bf16 ulp on the embeddings moves the logits less, else printed and
    held on the layer weights redrawn at fan-in scale); two layers in f32
    at fan-in scale, a 2 x (256 + 64) prefill and 4 decode steps card vs
    CPU (1e-4); (c) trained at full width on 4 of 48 layers (2,699,089,920
    parameters; f32 weights alone are 79.5 GB at full depth) through
    ``make_train_step`` with batches carrying ``prefix_embeds`` (2 x (256
    prefix rows + 513 tokens), remat ``"nothing"``, AdamW lr 3e-3 warmup
    10, 6 steps) twice: losses, grad norms and a parameter digest bitwise
    equal and finite, ``flash_attention`` 8 and B7b 4 launches a step and
    nothing else; ms a step, tokens/s, peak memory, a profiled step; one
    layer in f32 at fan-in scale, loss and every gradient card vs CPU
    (1e-4 of each leaf's max).
25. the dry run (``python -m repro_torch.launch.dryrun``) on the card:
    every halo cell (virtual meshes (4,1,1), (4,4,1) and (4,4,4) at local
    (8,8,8), feat 4, on the four backends, and the 3-D mesh at widths 2 /
    two pulses), each with the bytes its forward exchange moved equal to
    the plan's forward bytes, its kernel launches and one forward's device
    time (CUDA events); a dense and a pruned MD cell (800 atoms on 2x2x2,
    6 steps); every LM cell of ``--all`` built on ``meta`` with the card's
    allocated memory unchanged.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
import contextlib
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BPS = 3.35e12          # H100 SXM device memory, bytes/s
FP32_FLOPS = 67e12         # H100 SXM float32 outside the tensor cores
FP64_FLOPS = 34e12         # H100 SXM float64 outside the tensor cores
AXES = ("z", "y", "x")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, n: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn`` over ``n`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


# ---- phase 3: kernels at main-path shapes -----------------------------------

def main_path_cases(eng, cell_f, cell_i):
    """Every pack / unpack-add launch of one engine force pass, on real
    state: (kernel, tag, args), args exactly as the pallas backend passes
    them (per-pulse (n_dom, rows, F) views, shared int32 maps and, for
    unpack-add, the map's inverse)."""
    from repro_torch.core.md.forces import compute_forces

    plan, nd = eng.plan, 3
    local = eng.layout.cells_per_domain
    fwd_maps, rev_maps = plan.backend._maps(plan, tuple(local))
    n_dom = math.prod(eng.axis_sizes)

    def rows2d(x, shape, d):
        sub = x[(slice(None),) * nd + tuple(slice(0, s) for s in shape)]
        return sub.contiguous().reshape(n_dom, math.prod(shape[:d + 1]), -1)

    cases = []
    ext_f = plan.fwd(cell_f[..., :4].contiguous())
    ext_i = plan.fwd(cell_i, wrap_shift=None)
    shape = list(local)
    for pulse, idx in zip(plan.sched.serialized_order(), fwd_maps):
        d = pulse.dim
        cases.append(("pack", f"fwd-{AXES[d]}-f32",
                      (rows2d(ext_f, shape, d), idx)))
        cases.append(("pack", f"fwd-{AXES[d]}-i32",
                      (rows2d(ext_i, shape, d), idx)))
        shape[d] += pulse.width
    F_ext, _ = compute_forces(ext_f, ext_i, eng.layout,
                              eng.system.params.ff)
    for pulse, maps in zip(reversed(plan.sched.serialized_order()),
                           rev_maps):
        d = pulse.dim
        src = rows2d(F_ext, shape, d)
        cases.append(("pack", f"rev-{AXES[d]}-f32", (src, maps.pack_idx)))
        shape[d] -= pulse.width
        dst = rows2d(F_ext, shape, d)
        rows = src[:, maps.pack_idx.long()].contiguous()
        cases.append(("unpack_add", f"rev-{AXES[d]}-f32",
                      (dst, maps.add_idx, rows, maps.add_inv)))
    # one f64 case per kernel, at the x pulse's shapes
    for kernel, tag, args in list(cases):
        if tag in ("fwd-x-f32", "rev-x-f32"):
            cases.append((kernel, tag.replace("f32", "f64"),
                          tuple(a.double() if a.is_floating_point() else a
                                for a in args)))
    return cases


def case_bytes_ops(kernel, args):
    if kernel == "pack":
        src, idx = args
        n_dom, _, F = src.shape
        moved = 2 * n_dom * idx.shape[0] * F * src.element_size()
        return moved + idx.numel() * 4, 0
    dst, idx, rows, _inv = args
    return (2 * dst.numel() * dst.element_size()
            + rows.numel() * rows.element_size() + idx.numel() * 4,
            rows.numel())


def host_us(fn, n: int = 1000, warmup: int = 20) -> float:
    """Host us per call of ``fn`` with no sync: ``perf_counter`` over ``n``
    back-to-back calls, then one sync (not timed)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def device_us(fn, kernel: str, n: int = 50, tries: int = 8):
    """torch.profiler over ``n`` calls of ``fn``, each of which launches
    the kernel named ``kernel`` once: the mean device us of the launches a
    session recorded, or None when no session recorded half of them.
    CUPTI loses launches now and then: a whole session, or, once a long
    session has run (phase 6's dense block, phase 14's serving waves),
    launches of later sessions, the last ones first.  So each session
    ends with ``n`` small launches of another kernel, which take the lost
    tail, and a session that recorded fewer than ``n / 2`` of the
    kernel's launches is taken again."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    tail = torch.zeros((1,), device="cuda")
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            for _ in range(n):
                tail.add_(1.0)
            torch.cuda.synchronize()
        mine = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.name]
        if 2 * len(mine) >= n:
            return sum(e.time_range.elapsed_us() for e in mine) / len(mine)
    return None


# CUgraphNodeType, in the order of cuda.h
GRAPH_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
                    "wait_event", "event_record", "ext_semas_signal",
                    "ext_semas_wait", "mem_alloc", "mem_free",
                    "batch_mem_op", "conditional")


def graph_ops(fn, n: int = 10) -> dict:
    """The device operations that one call of ``fn`` enqueues, counted by
    type: ``n`` calls are captured into a CUDA graph and its nodes read
    through the driver API.  Unlike a profiler session, a capture loses
    no operation."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    kinds = graph_nodes(g)
    del g
    torch.cuda.synchronize()
    return {k: v / n for k, v in kinds.items()}


def graph_nodes(g) -> dict:
    """The nodes of a captured ``torch.cuda.CUDAGraph(keep_graph=True)``,
    counted by type through the driver API."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    rc = cu.cuGraphGetNodes(graph, None, ctypes.byref(count))
    check(rc == 0, f"cuGraphGetNodes failed: CUDA error {rc}")
    nodes = (ctypes.c_void_p * count.value)()
    rc = cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count))
    check(rc == 0, f"cuGraphGetNodes failed: CUDA error {rc}")
    kinds = {}
    for node in nodes:
        t = ctypes.c_int(-1)
        rc = cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        check(rc == 0, f"cuGraphNodeGetType failed: CUDA error {rc}")
        name = GRAPH_NODE_TYPES[t.value] \
            if 0 <= t.value < len(GRAPH_NODE_TYPES) else f"type {t.value}"
        kinds[name] = kinds.get(name, 0) + 1
    return kinds


def device_txt(d, bound_us, ops=None):
    """A launch's device us, its share of the bound and, where given,
    its device operations (phases 7, 10, 15)."""
    if d is None:
        return "device not measured (no profiler session held half the launches)"
    txt = f"device {d:.3f} us/launch ({bound_us / d:.4f} of the bound)"
    if ops is not None:
        txt += ", " + " + ".join(f"{v:g} {k}" for k, v in
                                 sorted(ops.items())) + " op/launch"
    return txt


def step_device_lines(acc, label="one step"):
    """One step's launches of each kernel (phases 7, 10, 15): events,
    the library call where there is one and device time beside the bound;
    the summed ``device_us`` becomes ``device_us_per_launch``, the mean
    (None where a shape's sessions were lost)."""
    for name, a in acc.items():
        n, nd = a.pop("launches"), a.pop("device_n")
        whole = nd == n and n > 0
        d_txt = (f"device {a['device_us'] / n:.3f} us/launch, "
                 f"{a['device_us'] / 1e3:.6f} ms "
                 f"({a['bound_ms'] * 1e3 / a['device_us']:.4f} of the "
                 "bound)") if whole else "device not measured"
        a["device_us_per_launch"] = a.pop("device_us") / n if whole \
            else None
        lib = "" if a["library_ms"] is None else \
            f", library {a['library_ms']:.6f} ms"
        print(f"  {name} {label} ({n} launches): events {a['ms']:.6f} ms "
              f"({a['bound_ms'] / a['ms']:.4f} of the bound){lib}, bound "
              f"{a['bound_ms']:.6f} ms; {d_txt}")


def stream_readers():
    """The host us of each way to read the current stream, each checked to
    give the stream of ``with torch.cuda.stream(s):``."""
    import torch
    from repro_torch.kernels import _launch
    index = torch.cuda.current_device()
    device = torch.device("cuda", index)
    readers = {
        "torch.cuda.current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(device).cuda_stream,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch._C._cuda_getCurrentRawStream(index) (_launch.stream)":
            lambda: _launch.stream(index)}
    side = torch.cuda.Stream()
    for name, read in readers.items():
        with torch.cuda.stream(side):
            check(read() == side.cuda_stream,
                  f"{name} does not follow torch.cuda.stream(s)")
        check(read() == torch.cuda.current_stream().cuda_stream,
              f"{name} does not read the current stream")
        print(f"  stream reader: {host_us(read, 10_000):.4f} host us/call "
              f"{name}")


def pack_host_parts(src, idx):
    """The host us of each part of one B1 call, beside the whole call and
    ``index_select`` on the same arguments: where a wrapper's host time
    goes."""
    import torch
    from repro_torch.kernels import _launch, halo_pack
    dev = src.get_device()
    n_dom, R, F = src.shape
    M = idx.numel()
    out = src.new_empty(n_dom, M, F)
    fn = halo_pack._PACK[src.element_size()]
    s = _launch.stream(dev)
    ptrs = (src.data_ptr(), idx.data_ptr(), out.data_ptr())
    li = idx.long()
    parts = {
        "check of both tensors": lambda: (
            _launch.check("src", src, 3, dev, halo_pack._SUFFIX),
            _launch.check("index_map", idx, 1, dev, torch.int32)),
        "new_empty": lambda: src.new_empty(n_dom, M, F),
        "3 data_ptr + stream": lambda: (
            src.data_ptr(), idx.data_ptr(), out.data_ptr(),
            _launch.stream(dev)),
        # n_dom 0: the entry point returns before any CUDA call
        "ctypes call, refused before the launch": lambda: fn(
            *ptrs, 0, R, M, F, s),
        "ctypes call with its launch": lambda: fn(*ptrs, n_dom, R, M, F, s),
        "whole pack call": lambda: halo_pack.pack(src, idx),
        "index_select": lambda: torch.index_select(src, 1, li),
    }
    shape = "x".join(map(str, src.shape))
    for name, f in parts.items():
        print(f"  B1 host part [{shape} {M}]: {host_us(f, 10_000):.4f} "
              f"host us/call {name}")


def kernel_phase(eng, cell_f, cell_i):
    import torch
    from repro_torch.kernels import halo_pack

    plain = {"pack": halo_pack.pack_plain,
             "unpack_add": lambda dst, idx, rows, _inv:
                 halo_pack.unpack_add_plain(dst, idx, rows)}
    kern = {"pack": halo_pack.pack, "unpack_add": halo_pack.unpack_add}

    def library(kernel, args):
        if kernel == "pack":           # main-path maps hold no padding
            src, idx = args
            li = idx.long()
            return lambda: torch.index_select(src, 1, li)
        dst, idx, rows, _inv = args
        li = idx.long()
        return lambda: dst.index_add(1, li, rows)

    per_kernel = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "library_ms": 0.0, "bound_ms": 0.0, "bytes": 0,
                      "ops": 0, "host_us": 0.0, "library_host_us": 0.0,
                      "device_us": 0.0, "device_n": 0, "launches": 0}
                  for k in kern}
    print("kernel phase: per launch at grappa-45k main-path shapes "
          "(ms; bound = bytes / 3.35 TB/s; host us per call with no sync "
          "over 1,000 calls; device operations per launch from a CUDA "
          "graph of 10 calls; device us per launch from torch.profiler "
          "over 50)")
    for kernel, tag, args in main_path_cases(eng, cell_f, cell_i):
        got = kern[kernel](*args)
        want = plain[kernel](*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"{kernel} {tag}: kernel differs from its plain form")
        err = float((got.double() - want.double()).abs().max())
        lib = library(kernel, args)()
        if not tag.endswith("i32"):
            check(torch.equal(lib, want), f"{kernel} {tag}: yardstick "
                  "call computes another function")
        nbytes, ops = case_bytes_ops(kernel, args)
        flops = FP64_FLOPS if tag.endswith("f64") else FP32_FLOPS
        bound = max(nbytes / HBM_BPS, ops / flops) * 1e3
        t_k = cuda_ms(lambda: kern[kernel](*args))
        t_p = cuda_ms(lambda: plain[kernel](*args))
        t_l = cuda_ms(library(kernel, args))
        h_k = host_us(lambda: kern[kernel](*args))
        h_l = host_us(library(kernel, args))
        dev_ops = graph_ops(lambda: kern[kernel](*args))
        check(dev_ops == {"kernel": 1.0}, f"{kernel} {tag}: device "
              f"operations a launch {dev_ops}, expected its one kernel")
        d_us = device_us(lambda: kern[kernel](*args), f"{kernel}_kernel")
        d_txt = "not measured (no whole profiler session)" \
            if d_us is None else f"{d_us:.3f} us/launch"
        shapes = " ".join("x".join(map(str, a.shape)) for a in args)
        print(f"  {kernel:10s} {tag:11s} [{shapes}] kernel {t_k:.6f} "
              f"plain {t_p:.6f} library {t_l:.6f} bound {bound:.6f} "
              f"bytes {nbytes} err {err}; host us/call kernel {h_k:.3f} "
              f"library {h_l:.3f}; device {d_txt}, "
              f"{dev_ops['kernel']:g} op/launch")
        if (kernel, tag) == ("pack", "fwd-x-f32"):
            parts_args = args
        acc = per_kernel[kernel]
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
        if tag.endswith("f32"):
            # one step's worth: fwd f32 + rev f32 launches (the int32
            # index exchange runs once per block and once per rebin)
            acc["ms"] += t_k
            acc["plain_ms"] += t_p
            acc["library_ms"] += t_l
            acc["bound_ms"] += bound
            acc["bytes"] += nbytes
            acc["ops"] += ops
            acc["host_us"] += h_k
            acc["library_host_us"] += h_l
            if d_us is not None:
                acc["device_us"] += d_us
                acc["device_n"] += 1
            acc["launches"] += 1
    for kernel, acc in per_kernel.items():
        n, nd = acc["launches"], acc["device_n"]
        d_txt = "not measured" if not nd else \
            f"{acc['device_us'] / nd:.3f} us/launch ({nd} of {n} measured)"
        print(f"  {kernel} one f32 step ({n} launches): events "
              f"{acc['ms']:.6f} ms, library {acc['library_ms']:.6f} ms; "
              f"host us/call kernel {acc['host_us'] / n:.3f} library "
              f"{acc['library_host_us'] / n:.3f}; device {d_txt}, "
              "1 op/launch")
    stream_readers()
    pack_host_parts(*parts_args)
    return per_kernel


# ---- phase 4: small reference -----------------------------------------------

def reference_phase():
    import numpy as np
    import torch
    from repro_torch import HaloSpec, MDEngine, make_grappa_like, make_mesh
    from repro_torch.core.md import direct_forces_reference

    mesh = make_mesh((1, 1, 1), AXES)
    spec = HaloSpec(AXES, (1, 1, 1), backend="pallas")
    s32 = make_grappa_like(300, seed=11)
    eng = MDEngine(s32, mesh, spec)
    cf, ci, force, diag = eng.rebin_fn(*eng.init_state())
    f_card, = eng.gather_by_id([force], ci)
    f_ref, _ = direct_forces_reference(s32.pos, s32.charge, s32.typ,
                                       s32.box, s32.params.ff)
    err = float(np.abs(f_card - f_ref).max() / np.abs(f_ref).max())
    check(err < 5e-5, f"card forces vs direct oracle: {err}")

    s64 = make_grappa_like(300, seed=11, dtype=np.float64)
    runs = {}
    for dev in ("cuda", "cpu"):
        e = MDEngine(s64, mesh, spec, device=dev)
        (cf, ci), m, d = e.simulate(24)
        runs[dev] = (m, d, e.gather_by_id([cf[..., :3]], ci)[0])
    (mc, dc, pc), (mh, dh, ph) = runs["cuda"], runs["cpu"]
    rel = max(float(np.abs(mc[k] - mh[k]).max() / np.abs(mh[k]).max())
              for k in ("pe", "ke"))
    dpos = float(np.abs(pc - ph).max() / s64.box[0])
    check(rel < 1e-9 and dpos < 1e-9 and dc == dh,
          f"card vs CPU f64 24-step run: rel {rel}, dpos {dpos}")
    print(f"reference phase: card forces vs direct oracle {err:.3e} of the "
          f"force scale; f64 24 steps card vs CPU: PE/KE rel {rel:.3e}, "
          f"positions {dpos:.3e} of the box")


# ---- phase 5: the main path ---------------------------------------------------

def engine_run(system, backend):
    import torch
    from repro_torch import HaloSpec, MDEngine, make_md_mesh
    from repro_torch.kernels import halo_pack

    eng = MDEngine(system, make_md_mesh(8),
                   HaloSpec(AXES, (1, 1, 1), backend=backend))
    state = eng.init_state()
    torch.cuda.synchronize()
    halo_pack.pack.launches = 0
    halo_pack.unpack_add.launches = 0
    halo_pack.unpack_add.inverse_builds = 0
    t0 = time.perf_counter()
    (cf, ci), m, diags = eng.simulate(40, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"pack": halo_pack.pack.launches,
                "unpack_add": halo_pack.unpack_add.launches}
    check(halo_pack.unpack_add.inverse_builds == 0,
          f"{backend}: unpack_add built {halo_pack.unpack_add.inverse_builds}"
          " inverse maps on the main path (the plan passes its own)")
    # steady state: one more 20-step block on the final state, no rebin
    rs = eng.begin_run((cf, ci))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.run_block(rs, 20)
    torch.cuda.synchronize()
    block_ms = (time.perf_counter() - t1) * 1e3 / 20
    return eng, (cf, ci), m, diags, wall, launches, block_ms


def main_path_phase():
    import numpy as np
    import torch
    from repro_torch import make_grappa_like

    system = make_grappa_like(45_000, seed=0)
    n = system.n_atoms
    eng, (cf, ci), m, diags, wall, launches, block_ms = engine_run(
        system, "pallas")
    check(eng.layout.cells_per_domain == (7, 7, 7)
          and eng.layout.capacity == 40, f"layout {eng.layout}")
    check(cf.shape == (2, 2, 2, 7, 7, 7, 40, 7), f"cell_f {cf.shape}")
    check(m["pe"].shape == (40,) and m["ke"].shape == (40,),
          "per-step metrics")
    check(len(diags) == 2, f"expected one rebin between blocks: {diags}")
    for d in diags:
        check(d["migration_dropped"] == 0 and d["migration_lost"] == 0
              and d["bin_overflow"] == 0, f"migration counters {d}")
        check(d["n_atoms"] == n, f"atoms lost: {d}")
    E = m["pe"] + m["ke"]
    check(bool(np.all(np.isfinite(E))), "non-finite energy")
    drift = float((E.max() - E.min()) / n)
    check(drift < 5e-3, f"energy drift per atom {drift}")
    check(launches["pack"] > 0 and launches["unpack_add"] > 0,
          f"kernels not launched on the main path: {launches}")
    ms_step = wall * 1e3 / 40
    print(f"main path (pallas): {n} atoms, 2x2x2 domains, 40 steps in "
          f"{wall:.4f} s incl. 2 rebins: {ms_step:.4f} ms/step, "
          f"{n * 40 / wall:.6g} atom-steps/s; steady 20-step block "
          f"{block_ms:.4f} ms/step ({n / block_ms * 1e3:.6g} atom-steps/s); "
          f"energy drift/atom {drift:.3e}; launches {launches}")

    _e, (cf2, ci2), m2, diags2, wall2, _l, block2 = engine_run(
        system, "serialized")
    for k in ("pe", "ke", "mom"):
        check(np.array_equal(m[k], m2[k]),
              f"pallas and serialized runs differ in {k}")
    check(torch.equal(cf, cf2) and torch.equal(ci, ci2) and diags == diags2,
          "pallas and serialized final states differ")
    print(f"main path (serialized): {wall2 * 1e3 / 40:.4f} ms/step incl. "
          f"rebins, steady block {block2:.4f} ms/step; per-step PE/KE and "
          "final state bitwise equal to the pallas run")
    return launches


def _profile(fn, n: int, steps_per_call: int = 1, host_calls=None,
             tries: int = 3):
    """torch.profiler (CUPTI) over ``n`` calls of ``fn``, each advancing
    ``steps_per_call`` steps: host wall us per step, device kernel us per
    step, kernels per step, the device busy share of the host wall, and
    device us per kernel name per step.  Returns None if the profiler
    records no device kernels in ``tries`` sessions (CUPTI now and then
    drops a whole one).  ``host_calls`` (a dict), when given, is filled
    with the count of each CUDA runtime call the host made."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        # warm the allocator and, for an engine block, its step graphs
        # (a step unit's first two calls of a key run eagerly, the
        # third captures)
        fn()
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if kern:
            break
    if host_calls is not None:
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CPU and \
                    e.name.startswith("cuda"):
                host_calls[e.name] = host_calls.get(e.name, 0) + 1
    if not kern:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = {}
    for e in kern:
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), k + 1)
    device = sum(t for t, _ in by_name.values())
    per = n * steps_per_call
    return (wall_us / per, device / per, len(kern) / per, busy / wall_us,
            {name: (t / per, k / per) for name, (t, k) in by_name.items()})


def profile_phase(n_steps: int = 5):
    """Where a steady grappa-45k step spends device time, by layer and by
    kernel.  The step figure is one whole nstlist block divided by its
    steps, so the block context (the int32 index exchange, once per block) is
    spread as it is on the main path.  Measurement only: prints "not
    measured" if the profiler records no device kernels."""
    from repro_torch import HaloSpec, MDEngine, make_grappa_like, make_md_mesh
    from repro_torch.core.md.forces import compute_forces

    eng = MDEngine(make_grappa_like(45_000, seed=0), make_md_mesh(8),
                   HaloSpec(AXES, (1, 1, 1), backend="pallas"))
    rs = eng.begin_run()
    nst = eng.system.params.nstlist
    host = {}
    step = _profile(lambda: eng.run_block(rs, nst), 1, nst, host_calls=host)
    if step is None:
        print("profile: device time not measured (no CUDA events)")
        return
    wall, device, n_kern, busy, by_name = step
    # C1: the dense block copies nothing from the host and never blocks
    htod = sum(k for name, (_t, k) in by_name.items() if "HtoD" in name)
    syncs = host.get("cudaStreamSynchronize", 0)
    print(f"profile: dense block, Memcpy HtoD {htod * nst:.0f}, "
          f"cudaStreamSynchronize {syncs}, cudaMemcpyAsync "
          f"{host.get('cudaMemcpyAsync', 0)} (host runtime calls: "
          f"{json.dumps(host, sort_keys=True)})")
    check(htod == 0 and syncs == 0, "a steady dense block copies from the "
          f"host ({htod * nst:.0f} Memcpy HtoD) or syncs ({syncs})")
    print(f"profile (torch.profiler, one steady {nst}-step pallas "
          f"block, per step): host "
          f"wall {wall / 1e3:.4f} ms/step under the profiler, device kernel "
          f"time {device / 1e3:.4f} ms/step, {n_kern:.2f} kernels/step, "
          f"device busy {busy:.4f} of the host wall")
    payload = rs.cell_f[..., :4]
    ext_f = eng.plan.fwd(payload)
    ext_i = eng.plan.fwd(rs.cell_i, wrap_shift=None)
    ff = eng.system.params.ff
    F_ext, _ = compute_forces(ext_f, ext_i, eng.layout, ff)
    layers = {"halo fwd (f32 payload)": lambda: eng.plan.fwd(payload),
              "dense forces": lambda: compute_forces(ext_f, ext_i,
                                                     eng.layout, ff),
              "halo rev (f32 forces)": lambda: eng.plan.rev(F_ext)}
    for name, fn in layers.items():
        layer = _profile(fn, n_steps)
        if layer is None:
            print(f"  layer {name:24s} device time not measured")
            continue
        w, dev, k, b, _ = layer
        print(f"  layer {name:24s} device {dev / 1e3:.4f} ms "
              f"({dev / device:.4f} of the step's device time), "
              f"{k:.0f} kernels, host wall {w / 1e3:.4f} ms")
    for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  kernel {t / device:7.4f} {t:10.2f} us/step {k:7.2f}/step "
              f"{name[:80]}")
    for tag in ("pack_kernel", "unpack_add_kernel"):
        hits = [(t, k) for name, (t, k) in by_name.items() if tag in name
                and (tag == "unpack_add_kernel" or "unpack" not in name)]
        t, k = sum(h[0] for h in hits), sum(h[1] for h in hits)
        if k:
            print(f"  halo {tag}: {k:.2f} launches/step, device "
                  f"{t / k:.3f} us/launch, {t:.2f} us/step")
    host_constants_before_after(eng, rs)


def host_constants_before_after(eng, rs, rounds: int = 4):
    """Dense host ms per steady step with the force pass's constants
    built by ``torch.tensor`` on every call (a blocking host copy each,
    as before they were cached) against now: one 20-step block from the
    same state per timing, the two in turns, issued eagerly
    (``capture="off"``: a replayed graph builds no constant).  A repair,
    not a claim."""
    import contextlib
    import statistics
    import torch
    from repro_torch import MDEngine
    from repro_torch.core.md import forces

    eng = MDEngine(eng.system, eng.mesh, eng.spec, capture="off")

    @contextlib.contextmanager
    def per_call_constants():
        old = forces._const, forces.ff_tables
        forces._const = lambda v, like: torch.tensor(
            v, dtype=like.dtype, device=like.device)
        forces.ff_tables = forces.ff_tables.__wrapped__
        try:
            yield
        finally:
            forces._const, forces.ff_tables = old

    state = (rs.cell_f, rs.cell_i)
    nst = eng.system.params.nstlist
    times = {"per-call": [], "cached": []}
    for r in range(rounds):
        for mode in (("per-call", "cached") if r % 2 == 0
                     else ("cached", "per-call")):
            run = eng.begin_run(state)
            ctx = per_call_constants() if mode == "per-call" else \
                contextlib.nullcontext()
            with ctx:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run_block(run, nst)
                torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t0) * 1e3 / nst)
    print("dense host ms/step, constants built per call (before) against "
          f"cached (now), {rounds} steady blocks each in turns: " + ", ".join(
              f"{m} median {statistics.median(t):.4f} {t}"
              for m, t in times.items()))


# ---- phase 7: the pruned kernels at the tier shapes ----------------------------

# float operations counted per slot pair of pair_forces (divisions and square
# roots as one): r2 and the cutoff test of every valid slot pair; the LJ and
# reaction-field terms, both sides' forces and the energy of an interacting one
PF_VALID_OPS = 9
PF_PAIR_OPS = 43


def pruned_engine(system, backend="pallas", nstprune=0):
    from repro_torch import HaloSpec, MDEngine, make_md_mesh
    return MDEngine(system, make_md_mesh(8),
                    HaloSpec(AXES, (1, 1, 1), backend=backend),
                    force_backend="pallas", nstprune=nstprune)


def tier_cases(eng, rs, poison_halo=False):
    """Every tier of the first pruned block on its post-rebin state, with
    the inputs exactly as the force pass hands them to the kernels; with
    ``poison_halo`` the received halo slab of the last dim NaN'd first, as
    the ``halo_corrupt`` fault does."""
    from repro_torch.core.md import pair_schedule as ps
    from repro_torch.core.md.schedule_opt import tier_rows

    sel, tiers, _inner = rs.sched
    payload = rs.cell_f[..., :4].contiguous()
    ext_f = eng.plan.fwd(payload)
    if poison_halo:
        ax = eng.plan.n_lead + 2
        ext_f = ext_f.clone()
        ext_f[(slice(None),) * ax + (slice(payload.shape[ax], None),)] = \
            float("nan")
    ext_f = eng._trim_ext(ext_f)
    ext_i = eng._trim_ext(eng.plan.fwd(rs.cell_i, wrap_shift=None))
    batches = ps.prepare_tiers(eng.pair_schedule, ext_i,
                               sel[..., :tier_rows(tiers)], tiers)
    f2p = ps.padded_coords(ext_f)
    return [(t, *ps.gather_tier(f2p, t), f2p.shape[0]) for t in batches]


def pair_work(a, b, t, r_cut):
    """(valid slot pairs, interacting slot pairs) of one tier's data."""
    import torch
    ca, cb = t.cnt_a.long(), t.cnt_b.long()
    same = t.same > 0
    valid = torch.where(same, ca * (ca - 1) // 2, ca * cb).sum()
    slots = torch.arange(t.k, device=a.device)
    mask = (slots[None, :, None] < ca[:, None, None]) & \
        (slots[None, None, :] < cb[:, None, None])
    mask &= ~same[:, None, None] | (slots[None, None, :] > slots[None, :, None])
    dx = a[:, :, None, :3] - b[:, None, :, :3]
    r2 = dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1] + \
        dx[..., 2] * dx[..., 2]
    mask &= r2 < torch.tensor(r_cut * r_cut, dtype=a.dtype, device=a.device)
    return int(valid), int(mask.sum())


def nb_kernel_phase(system):
    """pair_forces and scatter_accum at the six tier shapes, f32, plus one
    f64 case each at the deepest tier."""
    import torch
    from repro_torch.kernels import nonbonded as nb

    eng = pruned_engine(system)
    rs = eng.begin_run()
    ff = system.params.ff
    acc = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": None, "bound_ms": 0.0, "bytes": 0, "ops": 0,
               "device_us": 0.0, "device_n": 0, "launches": 0}
           for k in ("pair_forces", "scatter_accum")}
    acc["scatter_accum"]["library_ms"] = 0.0
    print(f"pruned kernel phase: tiers {list(rs.sched[1])} (rows per "
          "domain, slots) x 8 domains; per launch (ms; bound = max(bytes / "
          "3.35 TB/s, ops / peak); device us per launch from torch.profiler "
          "over 50, its share of the bound = bound / device time; device "
          "operations per launch from a CUDA graph of 10 calls)")
    cases = tier_cases(eng, rs)
    cases += [(t, a.double(), b.double(), n_cells)
              for t, a, b, n_cells in cases[:1]]
    for t, a, b, n_cells in cases:
        f64 = a.dtype == torch.float64
        tag = f"k={t.k} N={a.shape[0]} {'f64' if f64 else 'f32'}"
        args = (a, b, t.ta, t.tb, t.same, ff)
        kw = dict(cnt_a=t.cnt_a, cnt_b=t.cnt_b)
        got = nb.pair_forces(*args, **kw)
        want = nb.pair_forces_plain(*args, **kw)
        torch.cuda.synchronize()
        scale = float(torch.maximum(want[0].abs().max(), want[1].abs().max()))
        ferr = max(float((g - w).abs().max()) for g, w in
                   zip(got[:2], want[:2]))
        perr = float((got[2] - want[2]).abs().max()) / \
            float(want[2].abs().max())
        tol = 1e-12 if f64 else 5e-6
        check(ferr / scale < tol and perr < tol,
              f"pair_forces {tag}: force err {ferr / scale} of the scale, "
              f"PE err {perr}")
        fa, fb, _pe = got
        sgot = nb.scatter_accum(t.cell_a, t.cell_b, fa, fb, n_cells,
                                index=t.index)
        swant = nb.scatter_accum_plain(t.cell_a, t.cell_b, fa, fb, n_cells,
                                       index=t.index)
        torch.cuda.synchronize()
        check(torch.equal(sgot, swant),
              f"scatter_accum {tag}: kernel differs from its plain form")
        ca, cb = t.cell_a.long(), t.cell_b.long()

        def library():
            out = torch.zeros((n_cells, t.k, 3), dtype=fa.dtype,
                              device=fa.device)
            out.index_add_(0, ca, fa)
            return out.index_add_(0, cb, fb)
        lib = library()
        check(float((lib - swant).abs().max()) <=
              1e-5 * float(swant.abs().max()) + 1e-30,
              f"scatter_accum {tag}: yardstick computes another function")
        s = a.element_size()
        N, k = a.shape[0], t.k
        valid, inter = pair_work(a, b, t, ff.r_cut)
        pf_bytes = 2 * N * k * 4 * s + 2 * N * k * 4 + 3 * N * 4 + \
            2 * N * k * 3 * s + N * s
        pf_ops = PF_VALID_OPS * valid + PF_PAIR_OPS * inter
        sa_bytes = 2 * N * k * 3 * s + 2 * N * 4 + (n_cells + 1) * 4 + \
            n_cells * k * 3 * s
        sa_ops = 2 * N * k * 3
        peak = FP64_FLOPS if f64 else FP32_FLOPS
        pf_bound = max(pf_bytes / HBM_BPS, pf_ops / peak) * 1e3
        sa_bound = max(sa_bytes / HBM_BPS, sa_ops / peak) * 1e3
        t_pf = cuda_ms(lambda: nb.pair_forces(*args, **kw))
        t_pf_plain = cuda_ms(lambda: nb.pair_forces_plain(*args, **kw),
                             n=10, warmup=2)
        t_sa = cuda_ms(lambda: nb.scatter_accum(
            t.cell_a, t.cell_b, fa, fb, n_cells, index=t.index))
        t_sa_plain = cuda_ms(lambda: nb.scatter_accum_plain(
            t.cell_a, t.cell_b, fa, fb, n_cells, index=t.index), n=10,
            warmup=2)
        t_lib = cuda_ms(library)
        # the same inputs give the same bits on every run
        again = nb.pair_forces(*args, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"pair_forces {tag}: a second run gives other bits")
        dev, ops = {}, []
        for name, fn in (
                ("pair_forces", lambda: nb.pair_forces(*args, **kw)),
                ("scatter_accum", lambda: nb.scatter_accum(
                    t.cell_a, t.cell_b, fa, fb, n_cells, index=t.index))):
            ops.append(graph_ops(fn))
            check(ops[-1] == {"kernel": 1.0}, f"{name} {tag}: device "
                  f"operations a launch {ops[-1]}, expected its one kernel")
            dev[name] = device_us(fn, f"{name}_kernel")
        print(f"  pair_forces   {tag:22s} kernel {t_pf:.6f} plain "
              f"{t_pf_plain:.6f} bound {pf_bound:.6f} ({pf_bytes} B, "
              f"{pf_ops} ops: {valid} valid, {inter} interacting slot "
              f"pairs) force err {ferr / scale:.3e} of {scale:.4g}, PE err "
              f"{perr:.3e}, run to run bitwise; "
              f"{device_txt(dev['pair_forces'], pf_bound * 1e3, ops[0])}")
        print(f"  scatter_accum {tag:22s} kernel {t_sa:.6f} plain "
              f"{t_sa_plain:.6f} library {t_lib:.6f} bound {sa_bound:.6f} "
              f"({sa_bytes} B) bitwise; "
              f"{device_txt(dev['scatter_accum'], sa_bound * 1e3, ops[1])}")
        acc["pair_forces"]["max_abs_err"] = max(
            acc["pair_forces"]["max_abs_err"], ferr)
        if f64:
            continue
        for name, d in dev.items():
            acc[name]["launches"] += 1
            if d is not None:
                acc[name]["device_us"] += d
                acc[name]["device_n"] += 1
        # one step's worth: the f32 launches of all six tiers, summed
        for name, vals in (("pair_forces", (t_pf, t_pf_plain, None,
                                            pf_bound, pf_bytes, pf_ops)),
                           ("scatter_accum", (t_sa, t_sa_plain, t_lib,
                                              sa_bound, sa_bytes, sa_ops))):
            a_ = acc[name]
            for key, v in zip(("ms", "plain_ms", "library_ms", "bound_ms",
                               "bytes", "ops"), vals):
                if v is not None:
                    a_[key] += v
    step_device_lines(acc, "one f32 step")
    nb_nan_case(eng, rs, ff)
    return acc


def nb_nan_case(eng, rs, ff):
    """Every tier with the received halo slab NaN'd (the ``halo_corrupt``
    fault): B5's non-finite entries exactly where its plain form's are,
    its finite ones within the phase's 5e-6 of the force scale; B6 carries
    the NaNs where its plain form does and its finite sums bitwise."""
    import torch
    from repro_torch.kernels import nonbonded as nb

    total = 0
    for t, a, b, n_cells in tier_cases(eng, rs, poison_halo=True):
        tag = f"k={t.k} N={a.shape[0]} f32, halo NaN"
        args = (a, b, t.ta, t.tb, t.same, ff)
        kw = dict(cnt_a=t.cnt_a, cnt_b=t.cnt_b)
        got = nb.pair_forces(*args, **kw)
        want = nb.pair_forces_plain(*args, **kw)
        torch.cuda.synchronize()
        bad = [~torch.isfinite(x) for x in want]
        for name, g, w, m in zip(("fa", "fb", "pe"), got, want, bad):
            check(torch.equal(~torch.isfinite(g), m),
                  f"pair_forces {tag}: {name} non-finite at "
                  f"{int((~torch.isfinite(g)).sum())} entries, its plain "
                  f"form at {int(m.sum())}")
        fin = [x[~m] for x, m in zip(want[:2], bad[:2])]
        scale = max(float(x.abs().max()) if x.numel() else 0.0 for x in fin)
        ferr = max(float((g[~m] - w[~m]).abs().max()) if (~m).any() else 0.0
                   for g, w, m in zip(got[:2], want[:2], bad[:2]))
        check(ferr <= 5e-6 * max(scale, 1e-30),
              f"pair_forces {tag}: finite entries off by {ferr} of {scale}")
        sgot = nb.scatter_accum(t.cell_a, t.cell_b, want[0], want[1],
                                n_cells, index=t.index)
        swant = nb.scatter_accum_plain(t.cell_a, t.cell_b, want[0], want[1],
                                       n_cells, index=t.index)
        torch.cuda.synchronize()
        snan = torch.isnan(swant)
        check(torch.equal(torch.isnan(sgot), snan) and torch.equal(
            torch.where(snan, 0.0, sgot), torch.where(snan, 0.0, swant)),
            f"scatter_accum {tag}: NaNs or finite sums differ from its "
            "plain form")
        n_bad = int(bad[0].sum() + bad[1].sum())
        total += n_bad
        print(f"  pair_forces   {tag:30s} non-finite fa / fb entries "
              f"{int(bad[0].sum())} / {int(bad[1].sum())} as its plain "
              f"form, pe finite {bool(torch.isfinite(got[2]).all())}, "
              f"finite entries within {ferr / max(scale, 1e-30):.3e} of "
              f"the scale; scatter_accum NaN cells {int(snan.any(-1).any(-1).sum())}"
              f" as its plain form, finite sums bitwise")
    check(total > 0, "pruned kernel phase: the NaN'd halo reached no force")


# ---- phase 8: the pruned main path ---------------------------------------------

def kernel_counters():
    from repro_torch.kernels import halo_pack, nonbonded
    return {"pack": halo_pack.pack, "unpack_add": halo_pack.unpack_add,
            "pair_forces": nonbonded.pair_forces,
            "scatter_accum": nonbonded.scatter_accum,
            "put_signal": halo_pack.put_signal,
            "fused_pulses": halo_pack.fused_pulses}


def pruned_run(system, backend, nstprune=0):
    import torch
    from repro_torch.core.md import pair_schedule as ps

    eng = pruned_engine(system, backend, nstprune)
    state = eng.init_state()
    torch.cuda.synchronize()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    rolls = ps.roll_prune.calls
    t0 = time.perf_counter()
    (cf, ci), m, diags = eng.simulate(40, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["roll_prune"] = ps.roll_prune.calls - rolls
    return eng, (cf, ci), m, diags, wall, launches


def check_nve(m, diags, n, label):
    import numpy as np
    check(m["pe"].shape == (40,) and m["ke"].shape == (40,),
          f"{label}: per-step metrics")
    check(len(diags) == 2, f"{label}: expected one rebin: {diags}")
    for d in diags:
        check(d["migration_dropped"] == 0 and d["migration_lost"] == 0
              and d["bin_overflow"] == 0, f"{label}: migration {d}")
        check(d["n_atoms"] == n, f"{label}: atoms lost: {d}")
    E = m["pe"] + m["ke"]
    check(bool(np.all(np.isfinite(E))), f"{label}: non-finite energy")
    drift = float((E.max() - E.min()) / n)
    check(drift < 5e-3, f"{label}: energy drift per atom {drift}")
    return drift


def pruned_path_phase(system):
    import numpy as np
    import torch

    n = system.n_atoms
    # the first force pass of the schedule against the dense pass
    eng = pruned_engine(system)
    rs = eng.begin_run()
    f_s, pe_s = eng.force_fn(rs.cell_f, rs.cell_i)
    f_d, pe_d = eng._force_pass(rs.cell_f, rs.cell_i)
    scale = float(f_d.abs().max())
    ferr = float((f_s - f_d).abs().max()) / scale
    perr = abs(float(pe_s - pe_d)) / abs(float(pe_d))
    check(ferr < 5e-6 and perr < 5e-6,
          f"pruned vs dense force pass: {ferr} of the force scale, PE {perr}")
    print(f"pruned path: first force pass vs dense {ferr:.3e} of the force "
          f"scale {scale:.6g}, PE {perr:.3e} (dense PE {float(pe_d):.9g})")
    del eng, rs, f_s, f_d

    eng, (cf, ci), m, diags, wall, launches = pruned_run(system, "pallas")
    check(all(launches[k] > 0 for k in ("pack", "unpack_add", "pair_forces",
                                        "scatter_accum")),
          f"kernels not launched on the pruned main path: {launches}")
    drift = check_nve(m, diags, n, "pruned pallas")
    print(f"pruned path (pallas halo, pallas forces): {n} atoms, 40 steps in "
          f"{wall:.4f} s incl. 2 rebins: {wall * 1e3 / 40:.4f} ms/step, "
          f"{n * 40 / wall:.6g} atom-steps/s; energy drift/atom "
          f"{drift:.3e}; launches {launches}")
    print(f"pruned path pair_stats: {json.dumps(eng.pair_stats())}")
    rs = eng.begin_run((cf, ci))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.run_block(rs, 20)
    torch.cuda.synchronize()
    print(f"pruned path: steady 20-step block "
          f"{(time.perf_counter() - t1) * 1e3 / 20:.4f} ms/step")
    del eng, rs

    eng2, (cf2, ci2), m2, diags2, wall2, launches2 = pruned_run(
        system, "serialized")
    for k in ("pe", "ke", "mom"):
        check(np.array_equal(m[k], m2[k]),
              f"pruned: pallas and serialized halo runs differ in {k}")
    check(torch.equal(cf, cf2) and torch.equal(ci, ci2) and diags == diags2,
          "pruned: pallas and serialized halo final states differ")
    print(f"pruned path (serialized halo): {wall2 * 1e3 / 40:.4f} ms/step; "
          f"per-step PE/KE and final state bitwise equal to the pallas "
          f"halo run; launches {launches2}")
    del eng2, cf2, ci2

    eng3, _state, m3, diags3, wall3, launches3 = pruned_run(
        system, "pallas", nstprune=5)
    check(launches3["roll_prune"] > 0, "nstprune=5 never ran roll_prune")
    drift3 = check_nve(m3, diags3, n, "nstprune=5")
    stats = eng3.pair_stats()
    print(f"pruned path nstprune=5: {wall3 * 1e3 / 40:.4f} ms/step, energy "
          f"drift/atom {drift3:.3e}, roll_prune calls "
          f"{launches3['roll_prune']}, inner_overflow_blocks "
          f"{stats['inner_overflow_blocks']}, sched_history "
          f"{eng3.sched_history}, tiers_inner {stats['tiers_inner']}")
    return launches


def pruned_profile_phase(system, n_calls: int = 5):
    """Where a steady pruned grappa-45k step spends device time, by layer
    and by kernel (measurement only, as in the dense profile)."""
    from repro_torch.core.md.pair_schedule import get_force_backend
    from repro_torch.core.md.schedule_opt import tier_rows

    eng = pruned_engine(system)
    rs = eng.begin_run()
    nst = eng.system.params.nstlist
    step = _profile(lambda: eng.run_block(rs, nst), 1, nst)
    if step is None:
        print("pruned profile: device time not measured (no CUDA events)")
        return
    wall, device, n_kern, busy, by_name = step
    print(f"pruned profile (torch.profiler, one steady {nst}-step block, "
          f"per step): host wall {wall / 1e3:.4f} ms/step under the "
          f"profiler, device kernel time {device / 1e3:.4f} ms/step, "
          f"{n_kern:.2f} kernels/step, device busy {busy:.4f} of the host "
          "wall")
    sel, tiers, _ = rs.sched
    payload = rs.cell_f[..., :4]
    ext_f = eng.plan.fwd(payload)
    ext_i = eng.plan.fwd(rs.cell_i, wrap_shift=None)
    ctx = eng._sched_ctx(eng._block_ctx(rs.cell_i), sel, tiers)
    backend = get_force_backend("pallas")
    ff = eng.system.params.ff
    F_ext, _ = backend(ext_f, ext_i, eng.layout, ff,
                       sched=eng.pair_schedule, batches=ctx["batches"])
    layers = {
        "halo fwd (f32 payload)": lambda: eng.plan.fwd(payload),
        "pruned forces": lambda: backend(
            ext_f, ext_i, eng.layout, ff, sched=eng.pair_schedule,
            batches=ctx["batches"]),
        "halo rev (f32 forces)": lambda: eng.plan.rev(F_ext),
        "tier batches (per block)": lambda: eng._sched_ctx(
            eng._block_ctx(rs.cell_i), sel, tiers),
        "prune (per block)": lambda: eng.do_prune(rs.cell_f, rs.cell_i),
    }
    for name, fn in layers.items():
        layer = _profile(fn, n_calls)
        if layer is None:
            print(f"  layer {name:26s} device time not measured")
            continue
        w, dev, k, b, _ = layer
        print(f"  layer {name:26s} device {dev / 1e3:.4f} ms "
              f"({dev / device:.4f} of the step's device time), "
              f"{k:.0f} kernels, host wall {w / 1e3:.4f} ms")
    for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  kernel {t / device:7.4f} {t:10.2f} us/step {k:7.2f}/step "
              f"{name[:80]}")
    for tag in ("pair_forces_kernel", "scatter_accum_kernel", "pack_kernel",
                "unpack_add_kernel"):
        hits = [(t, k) for name, (t, k) in by_name.items() if tag in name
                and (tag != "pack_kernel" or "unpack" not in name)]
        t, k = sum(h[0] for h in hits), sum(h[1] for h in hits)
        if k:
            print(f"  pruned {tag}: {k:.2f} launches/step, device "
                  f"{t / k:.3f} us/launch, {t:.2f} us/step")
    print(f"  evaluated rows per domain {tier_rows(tiers)} of "
          f"{eng.pair_schedule.n_pairs}")


# ---- phase 10: the signal kernels at main-path shapes ----------------------

SIGNAL_KERNELS = ("put_signal", "fused_pulses")


def recorded(thunk, kernels=SIGNAL_KERNELS):
    """Run ``thunk`` with the named ``halo_pack`` wrappers wrapped; returns
    its result and the (kernel, args, kwargs) of every call, as the main
    path made them."""
    from repro_torch.kernels import halo_pack
    calls, real = [], {k: getattr(halo_pack, k) for k in kernels}

    def wrap(kernel):
        def wrapper(*args, **kw):
            calls.append((kernel, args, kw))
            return real[kernel](*args, **kw)
        # the wrapper stands in the module while it runs, so the real
        # function's `fn.launches += 1` lands here; handed back below
        wrapper.launches = wrapper.wire_launches = 0
        return wrapper

    wrappers = {k: wrap(k) for k in kernels}
    for k, fn in wrappers.items():
        setattr(halo_pack, k, fn)
    try:
        out = thunk()
    finally:
        for k, fn in real.items():
            setattr(halo_pack, k, fn)
            fn.launches += wrappers[k].launches
            if hasattr(fn, "wire_launches"):
                fn.wire_launches += wrappers[k].wire_launches
    return out, calls


def signal_engine(system, widths=(1, 1, 1), pulses=None, backend="signal",
                  **kw):
    from repro_torch import HaloSpec, MDEngine, make_md_mesh
    return MDEngine(system, make_md_mesh(8),
                    HaloSpec(AXES, widths, backend=backend, pulses=pulses),
                    **kw)


def signal_cases(system):
    """(kernel, tag, args) of every put_signal / fused_pulses launch of one
    signal force pass on real post-rebin state, at widths 1 and at widths
    (2,2,2) / pulses (2,2,2), recorded from the plan itself; then a 3x2x1
    mesh at the x pulse's shapes."""
    from repro_torch.core.md.forces import compute_forces

    cases = []

    def add(label, calls):
        seen = {}
        for kernel, args, _kw in calls:
            axis = AXES[args[3] if kernel == "put_signal" else args[4]]
            seen[axis] = seen.get(axis, -1) + 1
            cases.append((kernel, f"{label}-{axis}"
                          + (f"{seen[axis]}" if seen[axis] else ""), args))

    for widths, pulses, tag in (((1, 1, 1), None, "w1"),
                                ((2, 2, 2), (2, 2, 2), "w2p2")):
        eng = signal_engine(system, widths, pulses)
        cf, ci, _f, _d = eng.rebin_fn(*eng.init_state())
        plan = eng.plan
        ext_f, calls = recorded(lambda: plan.fwd(cf[..., :4].contiguous()))
        add(f"{tag}-fwd-f32", calls)
        ext_i, calls = recorded(lambda: plan.fwd(ci, wrap_shift=None))
        add(f"{tag}-fwd-i32", calls)
        F_trim, _ = compute_forces(eng._trim_ext(ext_f), eng._trim_ext(ext_i),
                                   eng.layout, system.params.ff)
        F_ext = eng._pad_force(F_trim, ext_f.shape)
        add(f"{tag}-rev-f32", recorded(lambda: plan.rev(F_ext))[1])
        del eng, cf, ci, ext_f, ext_i, F_trim, F_ext
    # a 3x2x1 mesh at the x pulse's shapes: size 3 tells the shifts apart
    src, idx = next(a for k, t, a in cases if t == "w1-fwd-f32-x")[:2]
    src6 = src[:6].contiguous()
    for axis in (0, 1):
        for shift in (-1, 1):
            cases.append(("put_signal", f"mesh321-{AXES[axis]}{shift:+d}",
                          (src6, idx, (3, 2, 1), axis, shift)))
    return cases


def crafted_dependent(cases):
    """The x dim's two-pulse forward at widths (2,2,2) with a map whose
    second pulse forwards rows of the first pulse's receive buffer and
    ends in padding (as ``tests/dist/check_kernel_halo.py``)."""
    import torch
    args = next(a for k, t, a in cases
                if k == "fused_pulses" and t == "w2p2-fwd-f32-x")
    src, maps, n_local, mesh, axis = args[:5]
    M = maps.shape[1]
    dep = maps.clone()
    j = torch.arange(M, device=maps.device, dtype=torch.int32)
    dep[1] = torch.where(j % 3 == 1, n_local + (M - 1 - j), maps[1])
    dep[1, -max(1, M // 8):] = -1
    return (src, dep.contiguous(), n_local, mesh, axis)


def crafted_three_pulse(cases):
    """The x dim's forward at widths (2,2,2) with a third pulse: pulses 1
    and 2 forward rows of the pulse before from their first row on, and
    end in padding.  A pulse is 8 x 81 x 40 16-byte words, 101.25 blocks
    of 256: on the card's grid the pulses are padded to whole blocks."""
    import torch
    args = next(a for k, t, a in cases
                if k == "fused_pulses" and t == "w2p2-fwd-f32-x")
    src, maps, n_local, mesh, axis = args[:5]
    M = maps.shape[1]
    j = torch.arange(M, device=maps.device, dtype=torch.int32)
    p1 = torch.where(j % 3 == 0, n_local + (M - 1 - j), maps[1])
    p2 = torch.where(j % 2 == 0, n_local + (j * 7) % M, maps[0])
    dep = torch.stack([maps[0], p1, p2])
    dep[1:, -max(1, M // 8):] = -1
    return (src, dep.contiguous(), n_local, mesh, axis)


def fused_blocks(args):
    """(block count, counter value) of one fused_pulses launch on the
    flat grid: each pulse's n_dom x M x V words padded to whole blocks of
    256, V the row's 16-byte, 8-byte or element words."""
    src, maps = args[:2]
    n_dom, _, F = src.shape
    P_, M = maps.shape
    e = src.element_size()
    row = F * e
    w = next((w for w in (16, 8) if w > e and row % w == 0
              and src.data_ptr() % w == 0), e)
    V = row // w
    return P_ * -(-n_dom * M * V // 256), M * V


def signal_bytes(kernel, args):
    src = args[0]
    s = src.element_size()
    if kernel == "put_signal":
        idx = args[1]
        return 2 * src.shape[0] * idx.shape[0] * src.shape[2] * s + \
            idx.numel() * 4
    maps = args[1]
    return 2 * src.shape[0] * maps.numel() * src.shape[2] * s + \
        maps.numel() * 4


# a put_signal launch, either form: its memset of the words, then its kernel
PUT_SIGNAL_OPS = {"kernel": 1.0, "memset": 1.0}


def signal_kernel_phase(system, n_repeat: int = 1000,
                        n_put_repeat: int = 200):
    import torch
    from repro_torch.kernels import halo_pack

    plain = {"put_signal": halo_pack.put_signal_plain,
             "fused_pulses": halo_pack.fused_pulses_plain}
    kern = {"put_signal": halo_pack.put_signal,
            "fused_pulses": halo_pack.fused_pulses}
    acc = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0 if k == "put_signal" else None,
               "bound_ms": 0.0, "bytes": 0, "ops": 0, "device_us": 0.0,
               "device_n": 0, "launches": 0} for k in kern}

    # the words' layout of the checkout under test: arrival words,
    # counters and the block ticket, or (before the flat grid) arrival
    # words and a row ticket
    fused_words = getattr(halo_pack, "fused_pulses_words", None)

    def words_ok(kernel, args):
        n_dom = args[0].shape[0]
        if kernel == "put_signal":
            return words[:n_dom].tolist() == [args[1].shape[0]] * n_dom
        P_, M = args[1].shape
        arrived = words[:n_dom * P_].tolist() == [M] * (n_dom * P_)
        if fused_words is None:
            return arrived and int(words[n_dom * P_]) == P_ * n_dom * M
        blocks, MV = fused_blocks(args)
        return (arrived and words[n_dom * P_:2 * n_dom * P_].tolist()
                == [MV] * (n_dom * P_)
                and int(words[fused_words(n_dom, P_) - 1]) == blocks)

    def run(kernel, args):
        kw = {"signal": words} if kernel == "put_signal" else {"words": words}
        return kern[kernel](*args, **kw)

    def library(args):
        src, idx, mesh, axis, shift = args
        li = idx.long()

        def call():
            rows = torch.index_select(src, 1, li)
            return torch.roll(rows.reshape(tuple(mesh) + rows.shape[1:]),
                              shift, dims=axis).reshape(rows.shape)
        return call

    cases = signal_cases(system)
    dev = cases[0][2][0].device
    # enough for three pulses on 8 domains in either layout
    words = torch.empty((2 * 8 * 3 + 1,), dtype=torch.int32, device=dev)
    print(f"signal kernel phase: {len(cases)} launch shapes (ms per launch; "
          "bound = bytes / 3.35 TB/s; device us per launch from "
          "torch.profiler over 50, its share of the bound = bound / device "
          "time; device operations per launch from a CUDA graph of 10 "
          "calls, put_signal in both forms; put_signal: "
          f"{n_put_repeat} launches back to back, each checked)")
    for kernel, tag, args in cases:
        got = run(kernel, args)
        want = plain[kernel](*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"{kernel} {tag}: kernel differs from its plain form")
        err = float((got.double() - want.double()).abs().max())
        check(words_ok(kernel, args), f"{kernel} {tag}: arrival words "
              f"{words.tolist()} do not equal the chunk counts")
        ops = None
        if kernel == "put_signal":
            # the release, launch after launch: the payload and every
            # arrival word checked on the device after each launch
            n_dom, M = args[0].shape[0], args[1].shape[0]
            bad = torch.zeros((), dtype=torch.int64, device=dev)
            bad_words = torch.zeros_like(bad)
            for _ in range(n_put_repeat):
                bad += (run(kernel, args) != want).sum()
                bad_words += (words[:n_dom] != M).sum()
            torch.cuda.synchronize()
            check(int(bad) == 0 and int(bad_words) == 0,
                  f"put_signal {tag}: {int(bad)} elements and "
                  f"{int(bad_words)} arrival words wrong over "
                  f"{n_put_repeat} launches")
            ops = graph_ops(lambda: run(kernel, args))
            check(ops == PUT_SIGNAL_OPS, f"put_signal {tag}: device "
                  f"operations a launch {ops}, expected {PUT_SIGNAL_OPS}")
            if args[0].dtype == torch.float32:
                w_ops = graph_ops(lambda: halo_pack.put_signal(
                    *args, signal=words, wire_dtype="bfloat16"))
                check(w_ops == PUT_SIGNAL_OPS, f"put_signal {tag} (wire "
                      f"bfloat16): device operations a launch {w_ops}, "
                      f"expected {PUT_SIGNAL_OPS}")
        else:
            ops = graph_ops(lambda: run(kernel, args))
            check(ops == PUT_SIGNAL_OPS, f"fused_pulses {tag}: device "
                  f"operations a launch {ops}, expected {PUT_SIGNAL_OPS}")
        d_us = device_us(lambda: run(kernel, args), f"{kernel}_kernel")
        t_k = cuda_ms(lambda: run(kernel, args))
        t_p = cuda_ms(lambda: plain[kernel](*args))
        t_l = None
        if kernel == "put_signal" and int(args[1].min()) >= 0:
            lib = library(args)
            check(torch.equal(lib(), want),
                  f"{kernel} {tag}: yardstick computes another function")
            t_l = cuda_ms(lib)
        nbytes = signal_bytes(kernel, args)
        bound = nbytes / HBM_BPS * 1e3
        shapes = "x".join(map(str, args[0].shape)) + " M " + \
            "x".join(map(str, args[1].shape))
        print(f"  {kernel:12s} {tag:22s} [{shapes}] kernel {t_k:.6f} "
              f"plain {t_p:.6f} library "
              f"{'none' if t_l is None else f'{t_l:.6f}'} bound "
              f"{bound:.6f} bytes {nbytes} err {err}; "
              f"{device_txt(d_us, bound * 1e3, ops)}")
        a = acc[kernel]
        a["max_abs_err"] = max(a["max_abs_err"], err)
        # one step's f32 launches: put_signal 3 fwd + 3 rev on the width-1
        # path; fused_pulses 3 fwd dims on the two-pulse path
        if (kernel == "put_signal" and tag.startswith("w1-")
                and "f32" in tag) or \
                (kernel == "fused_pulses" and "f32" in tag):
            for key, v in (("ms", t_k), ("plain_ms", t_p), ("bound_ms", bound),
                           ("bytes", nbytes)):
                a[key] += v
            if a["library_ms"] is not None:
                a["library_ms"] += t_l
            a["launches"] += 1
            if d_us is not None:
                a["device_us"] += d_us
                a["device_n"] += 1
    # the crafted dependent maps, back to back
    for label, args in (("crafted dependent", crafted_dependent(cases)),
                        ("crafted three-pulse", crafted_three_pulse(cases))):
        want = halo_pack.fused_pulses_plain(*args)
        check(bool((args[1][1:] >= args[2]).any()) and
              bool((args[1][1:] < 0).any()), f"{label} map has no "
              "dependent or padded entries")
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        bad_words = torch.zeros((), dtype=torch.int64, device=dev)
        err_dep = torch.zeros((), dtype=torch.float64, device=dev)
        P_, M = args[1].shape
        n_dom = args[0].shape[0]
        for _ in range(n_repeat):
            got = halo_pack.fused_pulses(*args, words=words)
            bad += (got != want).sum()
            err_dep = torch.maximum(
                err_dep, (got.double() - want.double()).abs().max())
            bad_words += (words[:n_dom * P_] != M).sum()
        torch.cuda.synchronize()
        acc["fused_pulses"]["max_abs_err"] = max(
            acc["fused_pulses"]["max_abs_err"], float(err_dep))
        check(int(bad) == 0 and int(bad_words) == 0,
              f"{label} fused_pulses: {int(bad)} elements and "
              f"{int(bad_words)} arrival words wrong over {n_repeat} "
              "launches")
        check(words_ok("fused_pulses", args), f"{label} fused_pulses: "
              f"words {words.tolist()} do not match the launch")
        ops = graph_ops(lambda: halo_pack.fused_pulses(*args, words=words))
        check(ops == PUT_SIGNAL_OPS, f"{label} fused_pulses: device "
              f"operations a launch {ops}, expected {PUT_SIGNAL_OPS}")
        t_dep = cuda_ms(lambda: halo_pack.fused_pulses(*args, words=words))
        d_us = device_us(lambda: halo_pack.fused_pulses(*args, words=words),
                         "fused_pulses_kernel")
        d_txt = "device not measured" if d_us is None else \
            f"device {d_us:.3f} us/launch"
        print(f"  fused_pulses {label} [{'x'.join(map(str, args[1].shape))}"
              f" map, {int((args[1][1:] >= args[2]).sum())} forwarded, "
              f"{int((args[1][1:] < 0).sum())} padded entries]: {n_repeat} "
              f"launches bitwise, words right; {t_dep:.6f} ms per launch, "
              f"{d_txt}, "
              + " + ".join(f"{v:g} {k}" for k, v in sorted(ops.items()))
              + " op/launch")
    step_device_lines(acc)
    return acc


# ---- phase 11: the signal main path -------------------------------------------

def run_counted(eng, n_steps=40):
    """``simulate`` on a fresh state with every kernel counter zeroed just
    before and read just after."""
    import torch
    state = eng.init_state()
    torch.cuda.synchronize()
    counters = kernel_counters()
    wire = {k: fn for k, fn in counters.items()
            if hasattr(fn, "wire_launches")}
    for fn in counters.values():
        fn.launches = 0
    for fn in wire.values():
        fn.wire_launches = 0
    t0 = time.perf_counter()
    (cf, ci), m, diags = eng.simulate(n_steps, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    launches.update({f"{k}_wire": fn.wire_launches
                     for k, fn in wire.items()})
    return (cf, ci), m, diags, wall, launches


def same_run(a, b, label, eng_a=None, eng_b=None):
    import numpy as np
    import torch
    (cf, ci), m, d = a[:3]
    (cf2, ci2), m2, d2 = b[:3]
    for k in ("pe", "ke", "mom"):
        check(np.array_equal(m[k], m2[k]), f"{label}: {k} differs")
    check(torch.equal(cf, cf2) and torch.equal(ci, ci2) and d == d2,
          f"{label}: final state or migration differs")
    if eng_a is not None:
        check(eng_a.sched_history == eng_b.sched_history,
              f"{label}: sched_history differs")
        sa, sb = eng_a._sched_exec, eng_b._sched_exec
        check(torch.equal(sa[0], sb[0]) and sa[1:] == sb[1:],
              f"{label}: the last prune's schedule differs")


def signal_path_phase(system):
    n = system.n_atoms
    runs = {}

    def go(label, eng, ref=None, pruned=False):
        out = run_counted(eng)
        (_s, m, diags, wall, launches) = out
        drift = check_nve(m, diags, n, label)
        if ref is not None:
            same_run(out, runs[ref][0], f"{label} vs {ref}",
                     *((eng, runs[ref][1]) if pruned else ()))
        runs[label] = (out, eng)
        print(f"signal path {label}: {wall * 1e3 / 40:.4f} ms/step over 40 "
              f"steps incl. rebins, drift/atom {drift:.3e}, launches "
              f"{launches}" + ("" if ref is None else
                               f"; bitwise equal to {ref}"))
        return launches

    go("serialized/off", signal_engine(system, backend="serialized"))
    dense = None
    for depth, ovr in ((2, False), (3, False), (4, False), (2, True)):
        label = f"signal/db{depth}" + ("/ovr" if ovr else "")
        lc = go(label, signal_engine(system, pipeline="double_buffer",
                                     pipeline_depth=depth,
                                     overlap_rebin=ovr),
                ref="serialized/off")
        check(lc["put_signal"] > 0 and lc["pack"] == 0
              and lc["unpack_add"] == 0,
              f"{label}: halo kernels {lc}")
        if dense is None:
            dense = lc
    go("serialized/off w2p2", signal_engine(system, (2, 2, 2), (2, 2, 2),
                                               backend="serialized"))
    w2 = go("signal/db2 w2p2", signal_engine(
        system, (2, 2, 2), (2, 2, 2), pipeline="double_buffer"),
        ref="serialized/off w2p2")
    check(w2["fused_pulses"] > 0 and w2["put_signal"] > 0,
          f"w2p2: signal kernels {w2}")
    pk = dict(force_backend="pallas", nstprune=5)
    go("pruned serialized/off", signal_engine(system, backend="serialized", **pk))
    for depth, ovr in ((3, False), (2, True)):
        label = f"pruned signal/db{depth}" + ("/ovr" if ovr else "")
        lc = go(label, signal_engine(system, pipeline="double_buffer",
                                     pipeline_depth=depth,
                                     overlap_rebin=ovr, **pk),
                ref="pruned serialized/off", pruned=True)
        check(lc["put_signal"] > 0 and lc["pair_forces"] > 0
              and lc["scatter_accum"] > 0, f"{label}: kernels {lc}")
    return dense, w2


# ---- phase 12: the profile of a steady signal step ------------------------------

def signal_profile_phase(system):
    for label, eng in (
            ("dense", signal_engine(system, pipeline="double_buffer")),
            ("pruned", signal_engine(system, pipeline="double_buffer",
                                     force_backend="pallas")),
            ("dense w2p2", signal_engine(system, (2, 2, 2), (2, 2, 2),
                                         pipeline="double_buffer"))):
        rs = eng.begin_run()
        nst = eng.system.params.nstlist
        step = _profile(lambda: eng.run_block(rs, nst), 1, nst)
        if step is None:
            print(f"signal profile {label}: device time not measured (no "
                  "CUDA events)")
            continue
        wall, device, n_kern, busy, by_name = step
        print(f"signal profile {label} (torch.profiler, one steady {nst}-step "
              f"signal/double_buffer block, per step): host wall "
              f"{wall / 1e3:.4f} ms/step under the profiler, device kernel "
              f"time {device / 1e3:.4f} ms/step, {n_kern:.2f} kernels/step, "
              f"device busy {busy:.4f} of the host wall")
        for name, (t, k) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:8]:
            print(f"  kernel {t / device:7.4f} {t:10.2f} us/step "
                  f"{k:7.2f}/step {name[:80]}")
        for tag in ("put_signal_kernel", "fused_pulses_kernel"):
            hits = [(t, k) for name, (t, k) in by_name.items() if tag in name]
            t, k = sum(h[0] for h in hits), sum(h[1] for h in hits)
            if k:
                print(f"  signal {tag}: {k:.2f} launches/step, device "
                      f"{t / k:.3f} us/launch, {t:.2f} us/step")
        del eng, rs


def warm_blocks(engines, state, n: int = 2):
    """``n`` untimed steady blocks per engine from ``state``: under
    block capture a step unit's first two calls of a key run eagerly,
    the third captures, so the steps of timed blocks after these
    replay."""
    import torch
    for eng in engines:
        for _ in range(n):
            eng.run_block(eng.begin_run(state), eng.system.params.nstlist)
    torch.cuda.synchronize()


def host_off_vs_double_buffer(system, rounds: int = 6):
    """Host ms per steady step, signal / off against signal /
    double_buffer, dense and pruned: one 20-step block from the same
    post-rebin state per timing, the two modes in turns (off first in
    even rounds, double_buffer first in odd ones), after two untimed
    blocks each (a step unit's first two calls run eagerly, the third
    captures).  Each step is a replayed CUDA graph; double_buffer's are
    the ring's prologue, unit per slot and epilogue, on one stream."""
    import statistics
    import torch

    for label, kw in (("dense", {}), ("pruned", dict(force_backend="pallas"))):
        engs = {m: signal_engine(system, pipeline=m, **kw)
                for m in ("off", "double_buffer")}
        state = engs["off"].init_state()
        nst = system.params.nstlist
        warm_blocks(engs.values(), state)
        times = {m: [] for m in engs}
        for r in range(rounds):
            for m in (("off", "double_buffer") if r % 2 == 0
                      else ("double_buffer", "off")):
                rs = engs[m].begin_run(state)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engs[m].run_block(rs, nst)
                torch.cuda.synchronize()
                times[m].append((time.perf_counter() - t0) * 1e3 / nst)
        med = {m: statistics.median(t) for m, t in times.items()}
        print(f"host ms/step, signal {label}, steady {nst}-step blocks, "
              f"{rounds} each in turns: off median {med['off']:.4f} "
              f"[{min(times['off']):.4f}, {max(times['off']):.4f}], "
              f"double_buffer median {med['double_buffer']:.4f} "
              f"[{min(times['double_buffer']):.4f}, "
              f"{max(times['double_buffer']):.4f}]")
        del engs, state


# ---- phase 13: flash_attention at the serve path's shapes ---------------------

BF16_FLOPS = 989e12        # H100 SXM bf16 / fp16 on the tensor cores, dense
# whisper-small's attention (12 heads of 64 over 12 kv heads, batch 8):
# (BH, L, S, G, hd, causal) of the encoder over its 1,500 frames, the
# decoder's cross attention (224 text positions) and its causal self
# attention at the 448-token text context
WHISPER_SHAPES = {"enc": (96, 1500, 1500, 1, 64, False),
                  "cross": (96, 224, 1500, 1, 64, False),
                  "dec": (96, 448, 448, 1, 64, True)}
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # kernel against plain form
ORACLE_TOL = {"bfloat16": 0.06, "float32": 2e-5}  # against the f64 oracle
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 1024, 32
TF_LOGIT_TOL = 5e-2        # bf16 decode vs prefill logits, of max |logit|
F32_TF_TOL = 1e-3          # f32 decode vs dense prefill (olmoe), of max
                           # |logit|, where the routing agrees
MOE_TF_FLIP_SHARE = 0.05   # decode tokens routed unlike the prefill, f32
F32_LOGIT_TOL = 1e-4       # card vs CPU prefill logits in f32, of max |logit|


def flash_work(BH, L, S, G, hd, causal, elem):
    """(bytes, operations) one launch needs: q, k, v read once and o
    written once; 4 operations (a multiply-add in q.k and in p.v) per
    (query row, key, dim) that the causal mask keeps."""
    pairs = sum(min(p + 1, S) for p in range(L)) if causal else L * S
    nbytes = (2 * BH * L * G * hd + 2 * BH * S * hd) * elem
    return nbytes, 4 * BH * G * hd * pairs


def flash_sass_counts(lib_path) -> dict:
    """Tensor-core (HGMMA / HMMA) and atomic (ATOM* / RED*) instructions in
    each flash kernel of the built library (``cuobjdump -sass``), keyed by
    (kernel, head_dim): ``flash_kernel_bf16`` / ``_f32`` (B7),
    ``flash_bwd_{prep,dkdv,dq}_bf16`` and ``flash_bwd_{delta,dkdv,dq}_f32``
    (B7b)."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    proc = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr[-2000:]}")
    counts, key = {}, None
    ops = ("HGMMA", "HMMA", "atomic")
    atomics = {"ATOM", "ATOMS", "ATOMG", "RED", "REDG"}
    mnemonic = re.compile(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)")
    for line in proc.stdout.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            key = None
            for kern in ("flash_kernel_bf16", "flash_kernel_f32",
                         "flash_bwd_prep_bf16", "flash_bwd_dkdv_bf16",
                         "flash_bwd_dq_bf16", "flash_bwd_delta_f32",
                         "flash_bwd_dkdv_f32", "flash_bwd_dq_f32"):
                if f"{kern}ILi" in name:   # ..._bf16ILi<hd>EE...
                    key = (kern, int(name.split(f"{kern}ILi")[1]
                                     .split("E")[0]))
                    counts[key] = dict.fromkeys(ops, 0)
        elif key is not None and (m := mnemonic.search(line)):
            op = "atomic" if m.group(1) in atomics else m.group(1)
            if op in ops:
                counts[key][op] += 1
    return counts


def flash_times(q, k, v, causal, want):
    """One bf16 case timed: the kernel (CUDA events over 50 launches), the
    plain form (5), SDPA on the same values in its (N, H, L, E) layout
    with the kv heads repeated G times (prepared outside the timing; its
    output checked against ``want``, the plain form's), and the bound:
    ``{"ms", "plain_ms", "library_ms", "bound_ms", "bytes", "ops",
    "peak"}`` and SDPA's error."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    BH, L, G, hd = q.shape
    S = k.shape[1]
    nbytes, ops = flash_work(BH, L, S, G, hd, causal, q.element_size())
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    bound = max(nbytes / HBM_BPS, ops / peak) * 1e3
    t_k = cuda_ms(lambda: flash_attention(q, k, v, causal=causal), n=50,
                  warmup=5)
    t_p = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=causal),
                  n=5, warmup=1)
    qt = q.transpose(1, 2).contiguous()
    kt = k[:, None].expand(BH, G, S, hd).contiguous()
    vt = v[:, None].expand(BH, G, S, hd).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qt, kt, vt, is_causal=causal).transpose(1, 2)
    lerr = float((lib.double() - want.double()).abs().max())
    t_l = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal), n=50,
                  warmup=5)
    return {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": bound,
            "bytes": nbytes, "ops": ops, "peak": peak}, lerr


def flash_phase(lib_path):
    """The kernel against its plain form (and the float64 oracle) at the
    serve shape (BH = 4 requests x 8 kv heads, L = S = 1024, G = 2,
    hd = 128) in bf16 and f32, non-causal, ragged L = S = 1000, hd 64
    and 16, and whisper-small's three attention shapes (``WHISPER_SHAPES``:
    encoder, cross and decoder self); at the serve shape also against the
    plain form at the bf16 kernel's tiling; the serve shape and whisper's
    in bf16 timed beside the plain form, SDPA as the yardstick and the
    bound; the bf16 kernels' HGMMA counts from the SASS."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     flash_attention,
                                                     flash_attention_plain,
                                                     kernel_tiling)

    sass = {hd: {op: c[op] for op in ("HGMMA", "HMMA")} for (kern, hd), c
            in flash_sass_counts(lib_path).items()
            if kern == "flash_kernel_bf16"}
    print(f"flash_attention SASS (cuobjdump -sass): tensor-core "
          f"instructions per bf16 kernel, by head_dim: {sass}")
    check(sorted(sass) == sorted(HEAD_DIMS) and
          all(c["HGMMA"] + c["HMMA"] > 0 for c in sass.values()),
          f"a bf16 flash kernel holds no HGMMA / HMMA: {sass}")

    cases = [("serve", 32, 1024, 1024, 2, 128, True),
             ("full", 32, 1024, 1024, 2, 128, False),
             ("ragged", 32, 1000, 1000, 2, 128, True),
             ("hd64", 16, 512, 512, 4, 64, True),
             ("hd16 full", 8, 256, 300, 2, 16, False)] + \
        [(f"whisper {tag}",) + shape for tag, shape in WHISPER_SHAPES.items()]
    gen = torch.Generator(device="cuda").manual_seed(13)
    errs = {"bfloat16": 0.0, "float32": 0.0}
    print("flash_attention phase: kernel against its plain form (max abs "
          f"err; tolerance {FLASH_TOL}; f64 oracle {ORACLE_TOL})")
    out, whisper = None, {}
    for tag, BH, L, S, G, hd, causal in cases:
        base = [torch.randn(shape, generator=gen, device="cuda")
                for shape in ((BH, L, G, hd), (BH, S, hd), (BH, S, hd))]
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            q, k, v = (x.to(dtype) for x in base)
            got = flash_attention(q, k, v, causal=causal)
            want = flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            check(got.shape == q.shape and got.dtype == dtype,
                  f"flash_attention {tag} {name}: shape / dtype")
            check(bool(torch.isfinite(got).all()),
                  f"flash_attention {tag} {name}: non-finite output")
            err = float((got.double() - want.double()).abs().max())
            oerr = float((got.double() - ref.flash_attention_ref(
                q, k, v, causal=causal)).abs().max())
            print(f"  {tag:9s} {name:8s} BH={BH} L={L} S={S} G={G} hd={hd} "
                  f"causal={causal}: vs plain {err:.3e}, vs f64 oracle "
                  f"{oerr:.3e}")
            check(err <= FLASH_TOL[name], f"flash_attention {tag} {name}: "
                  f"{err} from its plain form")
            check(oerr <= ORACLE_TOL[name], f"flash_attention {tag} {name}: "
                  f"{oerr} from the f64 oracle")
            errs[name] = max(errs[name], err)
            if tag.startswith("whisper") and dtype == torch.bfloat16:
                acc, lerr = flash_times(q, k, v, causal, want)
                check(lerr <= 2 * FLASH_TOL[name], f"SDPA yardstick at "
                      f"{tag}: {lerr} from the plain form")
                print(f"  {tag} bf16: kernel {acc['ms']:.6f} ms, plain "
                      f"{acc['plain_ms']:.6f} ms, SDPA {acc['library_ms']:.6f}"
                      f" ms (err vs plain {lerr:.3e}), bound "
                      f"{acc['bound_ms']:.6f} ms ({acc['ops']} operations, "
                      f"{acc['bytes']} bytes; "
                      f"{acc['bound_ms'] / acc['ms']:.4f} of it, "
                      f"{acc['ops'] / (acc['ms'] * 1e-3) / 1e12:.2f} TFLOP/s)")
                whisper[tag.split()[1]] = {
                    key: acc[key] for key in ("ms", "plain_ms", "library_ms",
                                              "bound_ms")} | {"max_abs_err":
                                                              err}
            if tag != "serve":
                continue
            bq, bk = kernel_tiling(G)
            terr = float((got.double() - flash_attention_plain(
                q, k, v, causal=causal, bq=bq, bk=bk).double()).abs().max())
            print(f"  serve {name}: vs the plain form at the bf16 kernel's "
                  f"tiling (bq {bq}, bk {bk}) {terr:.3e}, at its default "
                  f"(bq 128, bk 256) {err:.3e}")
            check(terr <= FLASH_TOL[name], f"flash_attention serve {name}: "
                  f"{terr} from its plain form at the kernel's tiling")
            acc, lerr = flash_times(q, k, v, causal, want)
            check(lerr <= 2 * FLASH_TOL[name], f"SDPA yardstick {name}: "
                  f"{lerr} from the plain form: another function")
            print(f"  serve {name}: kernel {acc['ms']:.6f} ms, plain "
                  f"{acc['plain_ms']:.6f} ms, SDPA {acc['library_ms']:.6f} ms"
                  f" (err vs plain {lerr:.3e}), bound {acc['bound_ms']:.6f} "
                  f"ms ({acc['bytes']} bytes, {acc['ops']} operations), "
                  f"kernel at {acc['ops'] / (acc['ms'] * 1e-3) / 1e12:.2f} "
                  f"TFLOP/s")
            if dtype == torch.bfloat16:
                out = acc
    out["max_abs_err"] = errs["bfloat16"]
    out["whisper_shapes"] = whisper
    print(f"flash_attention max abs err against the plain form: bf16 "
          f"{errs['bfloat16']:.3e}, f32 {errs['float32']:.3e}")
    return {"flash_attention": out}


# ---- phase 14: serve qwen3-1.7b at full width through the kernel --------------

def lm_serve_counted(model, label):
    """Two waves of ``SERVE_BATCH`` requests (``SERVE_PROMPT``-token
    prompts from ``RandomState(0)``, ``SERVE_NEW`` new tokens) through
    ``BatchServer`` with every kernel counter zeroed just before and read
    just after: ``flash_attention`` must read 2 x the attention layers
    (one prefill a wave; none for RWKV) and every other counter 0.  Prints the launches, tok/s and peak
    memory; returns ``(waves, served requests, server, launches, the
    prompts' RandomState after its draws)``."""
    import numpy as np
    import torch
    from repro_torch import BatchServer
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward)
    from repro_torch.runtime.serve_loop import Request, throughput_stats

    cfg = model.cfg
    rng = np.random.RandomState(0)
    waves = [[Request(prompt=rng.randint(0, cfg.vocab, size=(SERVE_PROMPT,))
                      .astype(np.int32), max_new_tokens=SERVE_NEW)
              for _ in range(SERVE_BATCH)] for _ in range(2)]
    server = BatchServer(model, batch_size=SERVE_BATCH,
                         max_len=SERVE_PROMPT + SERVE_NEW)
    counters = {**kernel_counters(), "flash_attention": flash_attention,
                "flash_attention_backward": flash_attention_backward}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    done = []
    for reqs in waves:
        done += server.serve_wave(reqs)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"  counted run: 2 waves x {SERVE_BATCH} requests, launches "
          f"{launches}; wave latencies "
          f"{[done[0].latency_s, done[-1].latency_s]} s")
    n_attn = cfg.n_units * sum(s.kind == "attn" for s in cfg.pattern_unit)
    check(launches["flash_attention"] == 2 * n_attn,
          f"{label}: flash_attention launched "
          f"{launches['flash_attention']} times, not {2 * n_attn}")
    check(all(n == 0 for name, n in launches.items()
              if name != "flash_attention"),
          f"{label}: another kernel ran while serving")
    for r in done:
        check(r.out_tokens.shape == (SERVE_NEW,) and
              0 <= int(r.out_tokens.min()) and
              int(r.out_tokens.max()) < cfg.vocab,
              f"{label}: served tokens out of range: {r.out_tokens}")
    stats = throughput_stats(done)
    wave2 = throughput_stats(done[SERVE_BATCH:])
    print(f"  serving: {stats['tokens']} tokens in {stats['wall_s']:.4f} s "
          f"-> {stats['tok_per_s']:.3f} tok/s over both waves "
          f"({wave2['tok_per_s']:.3f} tok/s, {wave2['wall_s']:.4f} s, "
          f"in the second); peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)")
    return waves, done, server, launches, rng


def lm_serve_timings(model, prompt):
    """Steady timings through the entry points (host clock after a sync):
    a prefill of ``prompt`` into a fresh cache (median of 5) and a token
    step of greedy decode after it (median of 3 runs of ``SERVE_NEW``
    steps).  Returns the prefill thunk, for a profile."""
    import torch

    max_len = SERVE_PROMPT + SERVE_NEW

    def prefill_once():
        model.prefill({"tokens": prompt},
                      model.init_cache(SERVE_BATCH, max_len))

    def decode_run():
        c = model.init_cache(SERVE_BATCH, max_len)
        lg, c = model.prefill({"tokens": prompt}, c)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(SERVE_NEW):
            tok.cpu()
            lg, c = model.decode_step(tok, SERVE_PROMPT + i, c)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3 / SERVE_NEW

    prefill_all = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill_once()
        torch.cuda.synchronize()
        prefill_all.append((time.perf_counter() - t1) * 1e3)
    prefill_ms = sorted(prefill_all)[2]
    decode_all = [decode_run() for _ in range(3)]
    decode_ms = sorted(decode_all)[1]
    print(f"  prefill {SERVE_BATCH} x {SERVE_PROMPT} tokens: median "
          f"{prefill_ms:.4f} ms per wave ({prefill_all}); decode: median "
          f"{decode_ms:.4f} ms per token step of {SERVE_BATCH} rows "
          f"({decode_all}), {SERVE_BATCH * 1e3 / decode_ms:.3f} tok/s")
    return prefill_once


def serve_phase():
    """qwen3-1.7b, 28 layers, bf16 compute over f32 params from a seeded
    generator; ``BatchServer`` serves two waves of 4 requests (1024-token
    prompts, 32 new tokens, max_len 1056) with every kernel counter zeroed
    just before and read just after: ``flash_attention`` must read 28 x 2
    (one prefill a wave; decode launches none).  Then: teacher-forced
    decode logits against no-cache prefill of the same prefix, timings,
    peak memory, a profiled wave, and a 2-layer full-width f32 model on the
    card against the same model on the CPU."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import build_model, get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.runtime.serve_loop import Request

    cfg = get_config("qwen3-1.7b")
    check(cfg.n_layers == 28 and cfg.compute_dtype == "bfloat16",
          f"qwen3-1.7b config changed: {cfg}")
    t0 = time.perf_counter()
    model = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 2_031_739_904, f"qwen3-1.7b has {n_params} parameters")
    print(f"serve phase: qwen3-1.7b, {n_params} parameters "
          f"({cfg.param_dtype} params, {cfg.compute_dtype} compute), init "
          f"{time.perf_counter() - t0:.2f} s")

    max_len = SERVE_PROMPT + SERVE_NEW
    waves, done, server, launches, rng = lm_serve_counted(model,
                                                          "qwen3-1.7b")

    # teacher-forced decode against no-cache prefill of each prefix
    prompt = torch.from_numpy(np.stack([r.prompt for r in waves[0]])).cuda()
    gen = torch.from_numpy(np.stack([r.out_tokens
                                     for r in done[:SERVE_BATCH]])).cuda()
    cache = model.init_cache(SERVE_BATCH, max_len)
    logits, cache = model.prefill({"tokens": prompt}, cache)
    worst = 0.0
    for t in range(SERVE_NEW):
        if t:
            logits, cache = model.decode_step(gen[:, t - 1:t],
                                              SERVE_PROMPT + t - 1, cache)
        full, _ = model.prefill({"tokens": torch.cat([prompt, gen[:, :t]],
                                                     dim=1)})
        check(bool(torch.isfinite(logits).all()) and
              bool(torch.isfinite(full).all()), f"non-finite logits at {t}")
        rel = float((logits.float() - full.float()).abs().max()
                    / full.float().abs().max())
        worst = max(worst, rel)
    print(f"  teacher-forced decode vs no-cache prefill, {SERVE_NEW} "
          f"positions: max |dlogit| / max |logit| = {worst:.4e} "
          f"(tolerance {TF_LOGIT_TOL}, bf16)")
    check(worst <= TF_LOGIT_TOL, f"decode logits {worst} from prefill's")
    del cache, logits, full

    lm_serve_timings(model, prompt)

    prof = _profile(lambda: server.serve_wave(
        [Request(prompt=r.prompt, max_new_tokens=SERVE_NEW)
         for r in waves[1]]), 1)
    if prof is None:
        print("  serve profile: device time not measured (no CUDA events)")
    else:
        wall, device, n_kern, busy, by_name = prof
        flash = [(t, k) for name, (t, k) in by_name.items()
                 if "flash_kernel" in name]
        ft, fk = sum(f[0] for f in flash), sum(f[1] for f in flash)
        print(f"  serve profile (torch.profiler, one wave): host wall "
              f"{wall / 1e3:.4f} ms, device kernel time {device / 1e3:.4f} "
              f"ms, {n_kern:.0f} kernels, device busy {busy:.4f} of the host "
              f"wall; flash_attention {fk:.0f} launches, "
              f"{ft / max(fk, 1):.3f} us/launch, {ft / device:.4f} of device "
              f"time")
        for name, (t, k) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:10]:
            print(f"    kernel {t / device:7.4f} {t / 1e3:10.4f} ms "
                  f"{k:7.0f}x {name[:90]}")
    del model, server, prompt, gen
    torch.cuda.empty_cache()

    # a 2-layer full-width model in f32: card (kernel) against CPU (plain)
    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    small = build_model(cfg2).init(
        torch.Generator(device="cuda").manual_seed(1))
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, size=(2, 300))
                            .astype(np.int32))
    before = flash_attention.launches
    on_card, _ = small.prefill({"tokens": toks.cuda()})
    check(flash_attention.launches == before + 2,
          "the f32 card prefill did not run the kernel")
    on_card = on_card.cpu()
    small.to("cpu")
    on_cpu, _ = small.prefill({"tokens": toks})
    rel = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
    print(f"  2-layer full-width f32 prefill (2 x 300 tokens), card vs CPU: "
          f"max |dlogit| / max |logit| = {rel:.4e} (tolerance "
          f"{F32_LOGIT_TOL}, TF32 off)")
    check(bool(torch.isfinite(on_card).all()) and rel <= F32_LOGIT_TOL,
          f"f32 card logits {rel} from the CPU's")
    return launches


# ---- phase 15: compressed halo payloads on grappa-45k in f64 ------------------

WIRE_FORMATS = (None, "float32", "bfloat16", "float16", "int8_ef")
WIRE_KERNELS = ("pack", "put_signal")
# the float16 trap: one rounding gives 1.0009765625, two (through f32) 1.0
TIE = 1 + 2.0 ** -11 + 2.0 ** -40


def wire_engine(system, backend, wire_dtype, **kw):
    """grappa-45k on 2x2x2 with a wire format; the pruned pallas force
    backend unless ``force_backend`` says otherwise."""
    from repro_torch import HaloSpec, MDEngine, make_md_mesh
    kw.setdefault("force_backend", "pallas")
    return MDEngine(system, make_md_mesh(8),
                    HaloSpec(AXES, (1, 1, 1), backend=backend),
                    wire_dtype=wire_dtype, **kw)


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (NaN slots need only both be NaN)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    na, nb = a.isnan(), b.isnan()
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[a.element_size()]
    return bool(torch.equal(na, nb)) and \
        bool(torch.equal(a.view(ints)[~na], b.view(ints)[~nb]))


def wire_cases(system):
    """(kernel, tag, args, kwargs) of every converting launch of one f64
    coordinate exchange, recorded from the plans on real post-rebin
    state: the pallas path's three pulses (B1w) and the signal path's
    three dims (B3w), f64 rows to f32."""
    cases = []
    for backend, kernel in (("pallas", "pack"), ("signal", "put_signal")):
        eng = wire_engine(system, backend, "float32")
        cf, ci, _f, _d = eng.rebin_fn(*eng.init_state())
        _ext, calls = recorded(
            lambda: eng.plan.fwd(cf[..., :4].contiguous()),
            kernels=(kernel,))
        for i, (k, args, kw) in enumerate(calls):
            check(kw.get("wire_dtype") == "float32",
                  f"{kernel}: the f64 forward launched without the wire")
            axis = args[3] if k == "put_signal" else i
            cases.append((k, f"fwd-{AXES[axis]}-f64", args, kw))
        check(len(calls) == 3, f"{kernel}: {len(calls)} forward launches")
        del eng, cf, ci, _f, _ext
    return cases


def tie_tensor(shape, dtype, device):
    """Values at and beside the float16 and bfloat16 ties, NaN / Inf /
    signed zeros, ``TIE`` first."""
    import numpy as np
    import torch
    rng = np.random.RandomState(15)
    n = math.prod(shape)
    e = rng.randint(-20, 14, n)
    tie = (1 + rng.randint(0, 1024, n) / 1024.0 + 2.0 ** -11) * 2.0 ** e
    near = tie * (1 + rng.choice([-1.0, 0.0, 1.0], n)
                  * 2.0 ** rng.randint(-50, -24, n))
    bf = (1 + rng.randint(0, 128, n) / 128.0 + 2.0 ** -8) * 2.0 ** e
    pick = rng.randint(0, 3, n)
    x = np.where(pick == 0, near, np.where(pick == 1, bf,
                                           rng.randn(n) * 3.0))
    x *= rng.choice([-1.0, 1.0], n)
    x[:9] = [TIE, -TIE, np.nan, np.inf, -np.inf, 0.0, -0.0, 7e4, 2.0 ** -26]
    return torch.from_numpy(x.astype(dtype).reshape(shape)).to(device)


def wire_kernel_phase(system):
    """B1w and B3w against their plain forms, bitwise: at every forward
    launch shape of the f64 main path (timed beside the plain form, the
    library calls and the byte bound), then every other conversion on a
    crafted near-tie tensor."""
    import numpy as np
    import torch
    from repro_torch.kernels import halo_pack

    acc = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bound_ms": 0.0, "bytes": 0, "ops": 0,
               "device_us": 0.0, "device_n": 0, "launches": 0}
           for k in WIRE_KERNELS}
    cases = wire_cases(system)
    dev = cases[0][2][0].device
    words = torch.empty((8 * 2 + 1,), dtype=torch.int32, device=dev)

    def kern(kernel, args, wd):
        if kernel == "pack":
            return halo_pack.pack(*args[:2], wire_dtype=wd)
        return halo_pack.put_signal(*args[:5], signal=words, wire_dtype=wd)

    def plain(kernel, args, wd):
        if kernel == "pack":
            return halo_pack.pack_plain(*args[:2], wd)
        return halo_pack.put_signal_plain(*args[:5], wd)

    def library(kernel, args):
        src, li = args[0], args[1].long()
        if kernel == "pack":
            return lambda: torch.index_select(src, 1, li).to(torch.float32)
        mesh, axis, shift = args[2:5]

        def call():
            rows = torch.index_select(src, 1, li)
            rows = torch.roll(rows.reshape(tuple(mesh) + rows.shape[1:]),
                              shift, dims=axis).reshape(rows.shape)
            return rows.to(torch.float32)
        return call

    print("wire kernel phase: B1w / B3w at the grappa-45k f64 forward "
          "launch shapes, f64 rows to f32 (ms per launch; bound = f64 rows "
          "read + f32 rows written + the map, / 3.35 TB/s; device us per "
          "launch from torch.profiler over 50, its share of the bound = "
          "bound / device time; B3w: device operations per launch from a "
          "CUDA graph of 10 calls)")
    for kernel, tag, args, _kw in cases:
        got = kern(kernel, args, "float32")
        want = plain(kernel, args, "float32")
        torch.cuda.synchronize()
        check(got.dtype == torch.float32 and torch.equal(got, want),
              f"{kernel} {tag} (wire): kernel differs from its plain form")
        err = float((got.double() - want.double()).abs().max())
        check(int(args[1].min()) >= 0, f"{kernel} {tag}: padded map")
        lib = library(kernel, args)
        check(torch.equal(lib(), want),
              f"{kernel} {tag}: yardstick computes another function")
        n_dom, _, F = args[0].shape
        M = args[1].shape[0]
        nbytes = n_dom * M * F * (8 + 4) + M * 4
        bound = nbytes / HBM_BPS * 1e3
        ops = None
        if kernel == "put_signal":
            ops = graph_ops(lambda: kern(kernel, args, "float32"))
            check(ops == PUT_SIGNAL_OPS, f"put_signal {tag} (wire): device "
                  f"operations a launch {ops}, expected {PUT_SIGNAL_OPS}")
        name = "pack_convert_kernel" if kernel == "pack" else \
            "put_signal_convert_kernel"
        d_us = device_us(lambda: kern(kernel, args, "float32"), name)
        t_k = cuda_ms(lambda: kern(kernel, args, "float32"))
        t_p = cuda_ms(lambda: plain(kernel, args, "float32"))
        t_l = cuda_ms(lib)
        print(f"  {kernel:10s} {tag:10s} [{'x'.join(map(str, args[0].shape))}"
              f" M {M}] kernel {t_k:.6f} plain {t_p:.6f} library {t_l:.6f} "
              f"bound {bound:.6f} bytes {nbytes} err {err}; "
              f"{device_txt(d_us, bound * 1e3, ops)}")
        a = acc[kernel]
        a["max_abs_err"] = max(a["max_abs_err"], err)
        for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                       ("bound_ms", bound), ("bytes", nbytes)):
            a[key] += v
        a["launches"] += 1
        if d_us is not None:
            a["device_us"] += d_us
            a["device_n"] += 1
    step_device_lines(acc)

    # every conversion, on values at and beside the ties, at row widths
    # divisible by 8, by 2 only and by 2 but not 4 (16-, 8-byte and
    # element words of the 16-bit wires)
    n_ok = 0
    for (sdt, wd), f in itertools.product(
            ((np.float64, "float32"), (np.float64, "bfloat16"),
             (np.float64, "float16"), (np.float32, "bfloat16"),
             (np.float32, "float16")), (160, 10, 6)):
        src = tie_tensor((8, 64, f), sdt, dev)
        idx = torch.arange(48, dtype=torch.int32, device=dev) * 5 % 64
        idx[7::9] = -1
        for kernel, args in (("pack", (src, idx)),
                             ("put_signal", (src, idx, (2, 2, 2), 0, -1)),
                             ("put_signal", (src, idx, (2, 2, 2), 2, 1))):
            got = kern(kernel, args, wd)
            torch.cuda.synchronize()
            check(same_bits(got, plain(kernel, args, wd)),
                  f"{kernel} {np.dtype(sdt).name} -> {wd}, F {f}: kernel "
                  "differs from its plain form on the near-tie tensor")
            n_ok += 1
        if (np.dtype(sdt).name, wd) == ("float64", "float16"):
            v = float(halo_pack.pack(src, idx, wire_dtype=wd)[0, 0, 0])
            check(v == 1.0009765625, f"f64 -> f16 of 1 + 2**-11 + 2**-40 "
                  f"gave {v}, not the single rounding 1.0009765625")
    print(f"  near-tie tensor (8x64xF, F 160 / 10 / 6, padded map, NaN / "
          f"Inf / signed "
          f"zeros): {n_ok} launches over f64 -> f32 / bf16 / f16 and f32 -> "
          "bf16 / f16, bitwise equal to the plain forms; f64 -> f16 of "
          "1 + 2**-11 + 2**-40 = 1.0009765625 (one rounding)")
    return acc


def wire_path_phase(system):
    """grappa-45k in f64 with every wire format through the pallas / off,
    signal / double_buffer depth-2 and serialized / off halo paths (pruned
    forces), 40 steps each with every counter zeroed just before and read
    just after: the converting kernels launched, the three backends
    bitwise equal per format, NVE and migration bars; one dense pallas
    run at bfloat16 against its serialized twin; the drift gate."""
    import warnings

    import numpy as np
    import torch
    from repro_torch.core.wire import WireDriftError

    n = system.n_atoms
    out, pos = {}, {}
    for wd in WIRE_FORMATS:
        runs = {}
        for label, backend, kw in (
                ("pallas/off", "pallas", {}),
                ("signal/db2", "signal", dict(pipeline="double_buffer",
                                              pipeline_depth=2)),
                ("serialized/off", "serialized", {})):
            eng = wire_engine(system, backend, wd, **kw)
            run = run_counted(eng)
            (cf, ci), m, diags, wall, lc = run
            drift = check_nve(m, diags, n, f"{wd} {label}")
            if wd is None or backend == "serialized":
                check(lc["pack_wire"] == 0 and lc["put_signal_wire"] == 0,
                      f"{wd} {label}: converting kernels ran {lc}")
            elif backend == "pallas":
                check(lc["pack_wire"] > 0 and lc["pair_forces"] > 0,
                      f"{wd} {label}: B1w not launched {lc}")
            else:
                check(lc["put_signal_wire"] > 0 and lc["pair_forces"] > 0,
                      f"{wd} {label}: B3w not launched {lc}")
            runs[label] = (run, eng)
            print(f"wire path {wd} {label}: {wall * 1e3 / 40:.4f} ms/step "
                  f"over 40 steps incl. rebins, drift/atom {drift:.3e}, "
                  f"launches {lc}")
        ref, ref_eng = runs["serialized/off"]
        for label in ("pallas/off", "signal/db2"):
            same_run(runs[label][0], ref, f"{wd}: {label} vs serialized/off",
                     runs[label][1], ref_eng)
        out[wd] = {k: r[0][4] for k, r in runs.items()}
        out[wd]["m"] = ref[1]
        (cf, ci) = ref[0]
        pos[wd], = ref_eng.gather_by_id([cf[..., :3]], ci)
        print(f"wire path {wd}: pallas/off and signal/db2 bitwise equal to "
              "serialized/off in PE, KE, momentum, final state, migration "
              "and schedule")
        del runs, ref, ref_eng
    check(not np.array_equal(out["float32"]["m"]["pe"], out[None]["m"]["pe"]),
          "float32 wire equals the dense run: f64 forces were not rounded")
    dpos = float(np.abs(pos["bfloat16"] - pos[None]).max())
    check(0 < dpos < 1e-1, f"bfloat16 wire moved positions by {dpos}")
    for wd in WIRE_FORMATS[1:]:
        rel = float(np.abs(out[wd]["m"]["pe"] - out[None]["m"]["pe"]).max()
                    / np.abs(out[None]["m"]["pe"]).max())
        print(f"  {wd} vs dense: per-step PE {rel:.3e} relative, final "
              f"positions {float(np.abs(pos[wd] - pos[None]).max()):.3e}")

    # the dense force path at bfloat16, against its serialized twin
    dense = {}
    for backend in ("pallas", "serialized"):
        eng = wire_engine(system, backend, "bfloat16", force_backend="dense")
        run = run_counted(eng)
        (_s, m, diags, wall, lc) = run
        drift = check_nve(m, diags, n, f"dense bfloat16 {backend}")
        dense[backend] = run
        print(f"wire path dense bfloat16 {backend}/off: {wall * 1e3 / 40:.4f}"
              f" ms/step, drift/atom {drift:.3e}, launches {lc}")
        del eng
    check(dense["pallas"][4]["pack_wire"] > 0, "dense bfloat16: B1w not "
          f"launched {dense['pallas'][4]}")
    same_run(dense["pallas"], dense["serialized"],
             "dense bfloat16: pallas vs serialized")

    # the drift gate: "int8" (no error feedback) is refused at build and
    # builds with verify="warn"
    try:
        wire_engine(system, "pallas", "int8")
        fail("wire_dtype='int8' built without verify='warn'")
    except WireDriftError as e:
        print(f"wire gate: int8 refused at build ({str(e)[:60]}...)")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        wire_engine(system, "pallas", "int8", verify="warn")
    check(any(issubclass(w.category, RuntimeWarning) for w in caught),
          "int8 under verify='warn' gave no warning")
    print("wire gate: int8 builds under verify='warn' with a RuntimeWarning")
    return out


def wire_drift_phase(system, n_steps: int = 200):
    """Each accepted format's energy drift over 200 f64 steps (pallas /
    off, pruned), ``(E.max - E.min) / n_atoms``, held to the reference's
    classification: under the dense-f32 bound and at most twice the
    dense drift plus 1e-5."""
    import numpy as np
    from repro_torch.core.wire import DENSE_F32_DRIFT_BOUND

    drift = {}
    for wd in WIRE_FORMATS:
        eng = wire_engine(system, "pallas", wd)
        t0 = time.perf_counter()
        _s, m, _d = eng.simulate(n_steps)
        E = m["pe"] + m["ke"]
        check(bool(np.all(np.isfinite(E))), f"{wd}: non-finite energy")
        drift[wd] = float((E.max() - E.min()) / system.n_atoms)
        print(f"wire drift {wd}: {drift[wd]:.6e} per atom over {n_steps} f64 "
              f"steps ({time.perf_counter() - t0:.2f} s)")
        del eng
    for wd in WIRE_FORMATS[1:]:
        check(drift[wd] < DENSE_F32_DRIFT_BOUND
              and drift[wd] <= 2 * drift[None] + 1e-5,
              f"{wd}: drift {drift[wd]} against dense {drift[None]} and the "
              f"bound {DENSE_F32_DRIFT_BOUND}")
    return drift


def wire_profile(system):
    """A steady f64 pruned block per wire format under the profiler:
    device time and kernels per step, busy share, and the converting
    kernels' device us per launch (measurement only)."""
    for wd, backend, kw in ((None, "pallas", {}),
                            ("float32", "pallas", {}),
                            ("bfloat16", "pallas", {}),
                            ("int8_ef", "pallas", {}),
                            ("float32", "signal",
                             dict(pipeline="double_buffer"))):
        eng = wire_engine(system, backend, wd, **kw)
        rs = eng.begin_run()
        nst = eng.system.params.nstlist
        step = _profile(lambda: eng.run_block(rs, nst), 1, nst)
        if step is None:
            print(f"wire profile {wd} {backend}: device time not measured "
                  "(no CUDA events)")
            continue
        wall, device, n_kern, busy, by_name = step
        line = (f"wire profile {wd} {backend} (f64, pruned, one steady "
                f"{nst}-step block, per step): host wall {wall / 1e3:.4f} ms "
                f"under the profiler, device {device / 1e3:.4f} ms, "
                f"{n_kern:.2f} kernels, busy {busy:.4f}")
        for tag in ("pack_convert_kernel", "put_signal_convert_kernel"):
            hits = [(t, k) for name, (t, k) in by_name.items() if tag in name]
            t, k = sum(h[0] for h in hits), sum(h[1] for h in hits)
            if k:
                line += (f"; {tag} {k:.2f}/step, {t / k:.3f} us/launch, "
                         f"{t:.2f} us/step")
        print(line)
        del eng, rs


def wire_speed(system, rounds: int = 5):
    """Host ms per steady step (one 20-step block from the same
    post-rebin state, after a sync, following two untimed blocks each),
    dense payload against bfloat16 and int8_ef, pallas / off, in
    turns."""
    import statistics
    import torch

    fmts = (None, "bfloat16", "int8_ef")
    engs = {wd: wire_engine(system, "pallas", wd) for wd in fmts}
    state = engs[None].init_state()
    nst = system.params.nstlist
    warm_blocks(engs.values(), state)
    times = {wd: [] for wd in fmts}
    for r in range(rounds):
        for wd in (fmts if r % 2 == 0 else fmts[::-1]):
            rs = engs[wd].begin_run(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engs[wd].run_block(rs, nst)
            torch.cuda.synchronize()
            times[wd].append((time.perf_counter() - t0) * 1e3 / nst)
    print(f"wire speed, host ms per steady step (f64, pruned, pallas/off, "
          f"{rounds} blocks each in turns): " + ", ".join(
              f"{wd}: median {statistics.median(t):.4f} {t}"
              for wd, t in times.items()))


# ---- phase 16: step graphs ----------------------------------------------------

def block_cells(system, system64):
    """Every MD cell of PERF.md's section 4 as ``(label, system, engine
    arguments)`` for ``signal_engine``: dense and pruned pallas (nstprune
    0 and 5), signal double_buffer at depths 2-4 with overlap_rebin,
    signal w2p2, and f64 float32 / int8_ef wires through pallas and
    signal."""
    pruned = dict(backend="pallas", force_backend="pallas")
    cells = [("dense pallas/off", system, dict(backend="pallas")),
             ("pruned pallas/off", system, pruned),
             ("pruned pallas/off nstprune5", system,
              dict(pruned, nstprune=5))]
    for depth in (2, 3, 4):
        cells.append((f"signal/db{depth} ovr", system, dict(
            pipeline="double_buffer", pipeline_depth=depth,
            overlap_rebin=True)))
    cells.append(("signal/db2 w2p2", system, dict(
        widths=(2, 2, 2), pulses=(2, 2, 2), pipeline="double_buffer")))
    for wd in ("float32", "int8_ef"):
        cells.append((f"f64 {wd} pallas/off", system64,
                      dict(pruned, wire_dtype=wd)))
        cells.append((f"f64 {wd} signal/db2", system64, dict(
            force_backend="pallas", pipeline="double_buffer",
            wire_dtype=wd)))
    return cells


def steady_blocks(eng, rounds: int):
    """Host ms per step of ``rounds`` steady blocks (each a host clock
    between two syncs, fused with its rebin under overlap_rebin) after
    two untimed ones, then one profiled block: ``(times, profile, host
    runtime calls per step)``."""
    import torch
    nst = eng.system.params.nstlist
    rs = eng.begin_run()

    def block():
        eng.run_block(rs, nst, fuse=eng.overlap_rebin)

    for _ in range(2):
        block()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / nst)
    host = {}
    prof = _profile(block, 1, nst, host_calls=host)
    return times, prof, {k: v / nst for k, v in host.items()}


def launch_calls(host) -> float:
    """Host API launches per step: kernel and graph launches, memsets and
    copies, from the profiler's runtime-call counts."""
    return sum(v for k, v in host.items()
               if "Launch" in k or "Memset" in k or "Memcpy" in k)


def block_graph_phase(system, system64, rounds: int = 3):
    """Every MD cell through the default, captured path against
    ``capture="off"``: ``simulate(40)`` bitwise (PE, KE, momentum, final
    state, migration, schedule) with the same launch counts; the cell's
    captures / replays, the steady block's host and device ms per step,
    busy share, host API launches and graph nodes per step."""
    import statistics

    for label, sys_, kw in block_cells(system, system64):
        t0 = time.perf_counter()
        eng_off = signal_engine(sys_, capture="off", **kw)
        eng = signal_engine(sys_, **kw)
        check(eng.capture == "block", f"{label}: the default on the card "
              f"is {eng.capture!r}")
        ref = run_counted(eng_off)
        got = run_counted(eng)
        pruned = kw.get("force_backend") == "pallas"
        same_run(got, ref, f"{label}: block vs off",
                 *((eng, eng_off) if pruned else ()))
        check(got[4] == ref[4], f"{label}: launches {got[4]} captured, "
              f"{ref[4]} eager")
        st = eng.block_graphs.stats()
        steps = {k: v for k, v in st["replays_by_kind"].items()
                 if k == "step" or k.startswith("unit")}
        check(sum(steps.values()) >= 20, f"{label}: the steps of "
              f"simulate(40) replayed {steps} times: {st}")
        times, prof, host = steady_blocks(eng, rounds)
        st = eng.block_graphs.stats()
        nst = sys_.params.nstlist
        nodes = {}
        for key, blk in eng.block_graphs.graphs():
            if key[0] in ("step", "unit1"):
                nodes = graph_nodes(blk.graph)      # one step's
        dev = "not measured" if prof is None else (
            f"device {prof[1] / 1e3:.4f} ms/step, busy {prof[3]:.4f}, "
            f"{prof[2]:.2f} kernels/step")
        print(f"block graphs {label}: simulate(40) bitwise equal to "
              f"capture='off', launches {got[4]}; {st['eager']} eager, "
              f"{st['captures']} captures "
              f"({', '.join(f'{m:.1f}' for m in st['capture_ms'])} ms), "
              f"{st['replays']} replays {st['replays_by_kind']}; steady "
              f"(fixed ladder, no rebin) host ms/step median "
              f"{statistics.median(times):.4f} {times}; {dev}; host API "
              f"launches/step {launch_calls(host):.2f}; graph nodes/step "
              f"{nodes} "
              f"({time.perf_counter() - t0:.1f} s)")
        del eng, eng_off, ref, got


def steps_phase(rounds: int = 5):
    """Host and device ms per steady step of every MD cell, in its
    pipeline mode and the other (off against double_buffer), through
    the engine's
    default path, and in its own mode the ms per step of a first
    ``simulate(40)`` and ``simulate(200)`` on fresh engines (with the
    block graphs' eager / capture / replay counts): a same-call
    comparison of checkouts (a parent without block capture issues
    eagerly)."""
    import statistics

    import numpy as np
    import torch
    from repro_torch import make_grappa_like

    system = make_grappa_like(45_000, seed=0)
    system64 = make_grappa_like(45_000, seed=0, dtype=np.float64)
    for label, sys_, kw in block_cells(system, system64):
        db = kw.get("pipeline") == "double_buffer"
        for mode in (("double_buffer", "off") if db
                     else ("off", "double_buffer")):
            kw2 = dict(kw, pipeline=mode)
            if mode == "off":
                kw2.pop("pipeline_depth", None)
            eng = signal_engine(sys_, **kw2)
            fresh = ""
            if mode == kw.get("pipeline", "off"):
                # first runs on fresh engines, rebins and prunes
                # included: under block capture a step unit's first two
                # calls of a key (a tier ladder) run eagerly, the third
                # captures
                for n_steps in (40, 200):
                    run = eng if n_steps == 40 else signal_engine(sys_, **kw2)
                    state = run.init_state()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run.simulate(n_steps, state=state)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3 / n_steps
                    graphs = getattr(run, "block_graphs", None)
                    fresh += (f"; fresh simulate({n_steps}) {ms:.4f} "
                              "ms/step" + ("" if graphs is None else
                                           " (" + ", ".join(
                                               f"{k} {v}" for k, v in
                                               graphs.stats().items()
                                               if k in ("eager", "captures",
                                                        "replays",
                                                        "captures_by_kind"))
                                           + ")"))
                    del run
            times, prof, host = steady_blocks(eng, rounds)
            graphs = getattr(eng, "block_graphs", None)
            st = graphs.stats() if graphs is not None else None
            dev = "device not measured" if prof is None else (
                f"device {prof[1] / 1e3:.4f} ms/step, busy {prof[3]:.4f}, "
                f"{prof[2]:.2f} kernels/step")
            print(f"steps {label} [{mode}]: host ms/step median "
                  f"{statistics.median(times):.4f} [{min(times):.4f}, "
                  f"{max(times):.4f}]; {dev}; host API launches/step "
                  f"{launch_calls(host):.2f}; graphs "
                  + ("none" if st is None else
                     f"{st['captures']} captures, {st['replays']} replays")
                  + fresh)
            del eng


# ---- phase 17: MD serving (SimServer, replica lanes in one launch) ------------

SERVE_NST_200 = 10          # the --md defaults: nstlist 10, 40 steps
SERVE_BUCKET = 256


def serve_counted(thunk):
    """``thunk()`` with every kernel counter zeroed just before and read
    just after: ``(result, launches)``."""
    import torch
    counters = kernel_counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    out = thunk()
    torch.cuda.synchronize()
    return out, {k: fn.launches for k, fn in counters.items()}


def serve_solo(system, mesh, kw, n_steps, bucket):
    """A replica's solo run under its bucket's layout (and, pruned, the
    static ladder): the reference a lane must equal bit for bit."""
    from repro_torch import MDEngine
    pruned = kw.get("force_backend", "dense") != "dense"
    eng = MDEngine(system, mesh, layout_atoms=bucket, static_ladder=pruned,
                   **kw)
    (cf, ci), m, _ = eng.simulate(n_steps, state=eng.init_state())
    return eng, cf, ci, m


def serve_check_lanes(label, handles, solos):
    """Every handle's state equals its solo run bitwise; the largest
    |difference| of the solo run's and the server's final KE, as a
    report of the metrics."""
    import numpy as np
    for key, h in handles:
        out = h.result()
        cf, ci = solos[key][1], solos[key][2]
        check(np.array_equal(out["cell_f"], cf.cpu().numpy())
              and np.array_equal(out["cell_i"], ci.cpu().numpy()),
              f"{label}: lane of replica {key} differs from its solo run")


def serve_server(mesh, ladder, nst, kw):
    from repro_torch import SimServer
    return SimServer(mesh, ladder, block_steps=nst, engine_kwargs=kw)


def serve_block_launches(label, system, mesh, ladder, nst, kw, bucket, rows):
    """One server block of ``rows`` lanes (its rebin, prune and steps)
    against one solo block of the same replica (its first rebin, prune
    and steps), each with the kernel counters zeroed just before and
    read just after, on warm graphs: the batch must launch each kernel
    as often as the solo run, not ``rows`` times as often."""
    from repro_torch import MDEngine, make_grappa_like
    pruned = kw.get("force_backend", "dense") != "dense"
    eng = MDEngine(system, mesh, layout_atoms=bucket, static_ladder=pruned,
                   **kw)
    srv = serve_server(mesh, ladder, nst, kw)
    for i in range(rows):
        srv.submit(make_grappa_like(system.n_atoms, seed=i, nstlist=nst,
                                    box_atoms=bucket), 40 * nst)
    for _ in range(3):                         # warm: eager, eager, capture
        srv.run_cycle()
        rs = eng.begin_run()
        eng.run_block(rs, nst)

    def solo():
        rs = eng.begin_run()
        eng.run_block(rs, nst)
    _, one = serve_counted(solo)
    _, batch = serve_counted(srv.run_cycle)
    check(batch == one, f"{label}: a {rows}-lane block launched {batch}, "
          f"a solo block {one}")
    return srv, eng, one


def serve_lane_metrics(label, systems, mesh, kw, bucket, nst):
    """One block of the batch programs (rebin, prune, steps) over
    ``systems`` as lanes against each replica's solo first block: the
    state bitwise, and per metric (``pe``, ``ke``, ``mom``, ``health/*``)
    whether every lane's values are the solo run's bits, else the largest
    difference relative to the solo values' scale.  Returns the line."""
    import numpy as np
    import torch
    from repro_torch import MDEngine, make_grappa_like
    from repro_torch.convert import cells_to_domains
    from repro_torch.core.md.pair_schedule import SLOT_QUANTUM
    from repro_torch.core.md.schedule_opt import tier_plan
    pruned = kw.get("force_backend", "dense") != "dense"
    tmpl = MDEngine(make_grappa_like(bucket, seed=0, nstlist=nst), mesh,
                    health=True, static_ladder=pruned, **kw)
    lp = tmpl.lane_programs(len(systems))
    rows = [cells_to_domains(*tmpl.bin_host(s), tmpl.axis_sizes)
            for s in systems]
    cf, ci = (torch.stack([torch.as_tensor(np.ascontiguousarray(r[j]))
                           for r in rows]).to(tmpl.device) for j in (0, 1))
    cf, ci, force, _ = lp["rebin"](cf, ci)
    if pruned:
        M = tmpl.pair_schedule.n_pairs
        tiers = tier_plan([M] * tmpl.pair_schedule.levels, tmpl.pair_bucket,
                          M, SLOT_QUANTUM, tmpl.layout.capacity)
        sel = lp["prune"](cf, ci)[0]
        cf, ci, _f, m, _o = lp["block_sched"](cf, ci, force, sel, nst,
                                              tiers, ())
    else:
        cf, ci, _f, m = lp["block"](cf, ci, force, nst)
    worst = {k: 0.0 for k in m}
    for r, s in enumerate(systems):
        eng = MDEngine(s, mesh, health=True, layout_atoms=bucket,
                       static_ladder=pruned, **kw)
        rs = eng.begin_run()
        ms = eng.run_block(rs, nst)
        check(torch.equal(cf[r], rs.cell_f) and torch.equal(ci[r], rs.cell_i),
              f"{label}: lane {r}'s block differs from its solo block")
        for k in m:
            a = m[k][r].double().cpu()
            b = ms[k].double().cpu()
            if not torch.equal(a, b):
                scale = max(float(b.abs().max()), 1e-300)
                worst[k] = max(worst[k], float((a - b).abs().max()) / scale,
                               1e-300)
    return f"{label}: lane metrics against solo: " + ", ".join(
        f"{k} {'bitwise' if v == 0.0 else f'{v:.3e} relative'}"
        for k, v in worst.items())


def serve_speed(label, srv, solo_engines, nst, rounds: int = 5):
    """Host ms per step of a steady server cycle (rows lanes) against the
    solo engines' blocks (block + rebin + prune each, one after another),
    in turns, then one profiled round of each: ``(batch host, solo host,
    batch profile, solo profile)``."""
    import statistics
    import torch
    states = [e.begin_run() for e in solo_engines]

    def solo_round():
        for e, rs in zip(solo_engines, states):
            e.run_block(rs, nst)
            e.advance_schedule(rs)

    for _ in range(2):
        solo_round()
    tb, ts = [], []
    for _ in range(rounds):
        for fn, acc in ((srv.run_cycle, tb), (solo_round, ts)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            acc.append((time.perf_counter() - t0) * 1e3 / nst)
    pb = _profile(srv.run_cycle, 1, nst)
    ps_ = _profile(solo_round, 1, nst)
    return (statistics.median(tb), tb, statistics.median(ts), ts, pb, ps_)


def serve_profile_txt(p) -> str:
    if p is None:
        return "device not measured"
    return (f"device {p[1] / 1e3:.4f} ms/step, busy {p[3]:.4f}, "
            f"{p[2]:.2f} kernels/step")


def serve_md_phase():
    """Phase 17: the MD server on the card.  Returns the kernels'
    launches over the served runs (counters zeroed just before each
    drive and read just after, summed)."""
    import numpy as np
    import torch
    from repro_torch import HaloSpec, make_grappa_like, make_md_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import BucketLadder, DONE, FAILED, ReplicaFault

    t17 = time.perf_counter()
    card = card_line()
    served = {}

    def add(launches):
        for k, v in launches.items():
            served[k] = served.get(k, 0) + v

    # (a) the --md defaults: 8 x 200-atom replicas in bucket 256, mesh
    # (1,1,1), 40 steps at nstlist 10; dense and pruned pallas, off and
    # double_buffer, HaloSpec pallas
    mesh1 = make_mesh((1, 1, 1), AXES)
    nst = SERVE_NST_200
    ladder = BucketLadder()
    for fb in ("dense", "pallas"):
        for pipe in ("off", "double_buffer"):
            label = f"serve 8x200 {fb}/{pipe}"
            kw = dict(spec=HaloSpec(AXES, (1, 1, 1), backend="pallas"),
                      force_backend=fb, pipeline=pipe)
            systems = {i: make_grappa_like(200, seed=i, nstlist=nst,
                                           box_atoms=SERVE_BUCKET)
                       for i in range(8)}
            solos = {i: serve_solo(s, mesh1, kw, 40, SERVE_BUCKET)
                     for i, s in systems.items()}
            srv = serve_server(mesh1, ladder, nst, kw)
            handles = [(i, srv.submit(s, 40)) for i, s in systems.items()]
            _, launches = serve_counted(srv.drain)
            add(launches)
            check(all(h.status == DONE for _, h in handles),
                  f"{label}: {[h.status for _, h in handles]}")
            serve_check_lanes(label, handles, solos)
            st = srv.stats()
            check(st["compiles"] == len(st["shapes_touched"]) == 1,
                  f"{label}: compiles {st['compiles']}, shapes "
                  f"{st['shapes_touched']}")
            # churn on the warm shape: a second wave of 8 must add no
            # capture
            caps = dict(st["captures_by_shape"])
            more = [srv.submit(make_grappa_like(
                200, seed=100 + i, nstlist=nst, box_atoms=SERVE_BUCKET), 40)
                for i in range(8)]
            _, launches = serve_counted(srv.drain)
            add(launches)
            st = srv.stats()
            check(all(h.status == DONE for h in more), f"{label}: churn")
            check(st["captures_by_shape"] == caps, f"{label}: churn on a "
                  f"warm shape captured {st['captures_by_shape']} against "
                  f"{caps}")
            bg = srv._programs[(8, SERVE_BUCKET)].lanes[
                "engine"].block_graphs
            check(bg is not None, f"{label}: the lanes run no graphs")
            graphs = bg.stats()
            print(f"{label}: 8 lanes bitwise equal to their solo runs "
                  f"(cell_f, cell_i); launches {launches} for the second "
                  f"wave; {st['replicas_done']} replicas, "
                  f"{st['replicas_per_s']:.2f} replicas/s, step p50 "
                  f"{st['step_latency_p50_ms']:.4f} ms p99 "
                  f"{st['step_latency_p99_ms']:.4f} ms; compiles "
                  f"{st['compiles']}; captures {graphs['captures_by_kind']}"
                  f", replays {graphs['replays_by_kind']}, churn captured "
                  f"nothing")
            del srv, solos

    print(serve_lane_metrics(
        "serve 8x200 dense/off", [make_grappa_like(
            200, seed=i, nstlist=nst, box_atoms=SERVE_BUCKET)
            for i in range(8)], mesh1,
        dict(spec=HaloSpec(AXES, (1, 1, 1), backend="pallas")),
        SERVE_BUCKET, nst))

    # the per-block launch check on the 200-atom shape, pruned
    ladder4 = BucketLadder(row_buckets=(1, 2, 4),
                           atom_buckets=(SERVE_BUCKET,))
    kw = dict(spec=HaloSpec(AXES, (1, 1, 1), backend="pallas"),
              force_backend="pallas")
    _srv, _eng, one = serve_block_launches(
        "serve 4x200 pallas/off", make_grappa_like(
            200, seed=0, nstlist=nst, box_atoms=SERVE_BUCKET), mesh1,
        ladder4, nst, kw, SERVE_BUCKET, 4)
    print(f"serve 4x200 pallas/off: one 4-lane block launches {one}, "
          "as one solo block")
    del _srv, _eng

    # (c) one NaN lane among three (200 atoms, pruned pallas): the lane
    # is quarantined, its co-residents bitwise unchanged, no device fault
    label = "serve NaN lane"
    bad = make_grappa_like(200, seed=11, nstlist=nst, box_atoms=SERVE_BUCKET)
    bad.vel[0] = np.inf
    goods = {i: make_grappa_like(200, seed=i, nstlist=nst,
                                 box_atoms=SERVE_BUCKET) for i in (1, 2)}
    solos = {i: serve_solo(s, mesh1, kw, 20, SERVE_BUCKET)
             for i, s in goods.items()}
    srv = serve_server(mesh1, ladder4, nst, kw)
    hb = srv.submit(bad, 20)
    handles = [(i, srv.submit(s, 20)) for i, s in goods.items()]
    _, launches = serve_counted(srv.drain)
    add(launches)
    check(hb.status == FAILED, f"{label}: the poisoned lane is {hb.status}")
    try:
        hb.result()
        fail(f"{label}: no ReplicaFault")
    except ReplicaFault as e:
        check("non-finite" in str(e), f"{label}: {e}")
    serve_check_lanes(label, handles, solos)
    torch.cuda.synchronize()
    st = srv.stats()
    print(f"{label}: the poisoned lane quarantined ({st['replicas_failed']}"
          f" failed), its 2 co-residents bitwise equal to their solo runs")
    del srv, solos

    # (b) full width: 4 grappa-45k replicas (seeds 0-3) on the 2x2x2
    # virtual mesh, bucket 45,000, 20-step blocks, 40 steps, pruned
    # pallas with the pallas halo, then the signal halo
    mesh8 = make_md_mesh(8)
    nst45 = 20
    ladder45 = BucketLadder(row_buckets=(1, 2, 4), atom_buckets=(45_000,))
    systems = {i: make_grappa_like(45_000, seed=i, nstlist=nst45,
                                   box_atoms=45_000) for i in range(4)}
    for backend in ("pallas", "signal"):
        label = f"serve 4x45k pruned pallas, {backend} halo"
        t0 = time.perf_counter()
        kw = dict(spec=HaloSpec(AXES, (1, 1, 1), backend=backend),
                  force_backend="pallas")
        solos = {i: serve_solo(s, mesh8, kw, 40, 45_000)
                 for i, s in systems.items()}
        srv = serve_server(mesh8, ladder45, nst45, kw)
        handles = [(i, srv.submit(s, 40)) for i, s in systems.items()]
        _, launches = serve_counted(srv.drain)
        add(launches)
        check(all(h.status == DONE for _, h in handles), f"{label}: done")
        serve_check_lanes(label, handles, solos)
        st = srv.stats()
        graphs = srv._programs[(4, 45_000)].lanes[
            "engine"].block_graphs.stats()
        print(f"{label}: 4 lanes bitwise equal to their solo runs; "
              f"launches {launches}; {st['replicas_per_s']:.3f} replicas/s,"
              f" step p50 {st['step_latency_p50_ms']:.4f} ms p99 "
              f"{st['step_latency_p99_ms']:.4f} ms (first blocks eager "
              f"and captured); captures {graphs['captures_by_kind']}, "
              f"replays {graphs['replays_by_kind']}, eager "
              f"{graphs['eager_by_kind']} "
              f"({time.perf_counter() - t0:.1f} s)")
        if backend == "pallas":
            # one block's launches, then host and device ms a step: the
            # 4-lane batch against the 4 solo runs, in turns
            srv2, _e, one = serve_block_launches(
                label, systems[0], mesh8, ladder45, nst45, kw, 45_000, 4)
            engines = [solos[i][0] for i in solos]
            hb_, tb, hs_, ts, pb, ps_ = serve_speed(label, srv2, engines,
                                                    nst45)
            print(f"{label}: one 4-lane block launches {one}, as one solo "
                  f"block; steady host ms/step, 4-lane batch {hb_:.4f} "
                  f"{[round(t, 4) for t in tb]} vs 4 solo runs {hs_:.4f} "
                  f"{[round(t, 4) for t in ts]}; batch "
                  f"{serve_profile_txt(pb)}; 4 solo runs "
                  f"{serve_profile_txt(ps_)}; {card}")
            del srv2, _e, engines
            print(serve_lane_metrics(label, [systems[i] for i in systems],
                                     mesh8, kw, 45_000, nst45))
        del srv, solos
    print(f"phase 17: {time.perf_counter() - t17:.1f} s; served launches "
          f"{served}")
    for k in ("pack", "unpack_add", "pair_forces", "scatter_accum",
              "put_signal"):
        check(served.get(k, 0) > 0, f"phase 17: {k} never launched while "
              f"serving: {served}")
    return served


# ---- phase 18: the self-healing MD runtime at full width -----------------------

DRILL_STEPS = 60             # three nstlist=20 blocks


def drill_engine(system, mesh=None, **kw):
    """The drill's configuration: grappa-45k on 2x2x2, the signal halo
    under the depth-3 double buffer, pruned pallas forces with nstprune 5,
    on the default (captured) path."""
    from repro_torch import HaloSpec, MDEngine, make_md_mesh
    return MDEngine(system, mesh or make_md_mesh(8),
                    HaloSpec(AXES, (1, 1, 1), backend="signal"),
                    pipeline="double_buffer", pipeline_depth=3,
                    force_backend="pallas", nstprune=5, **kw)


def drill_run(eng, ckpt_dir, specs=(), state=None, **kw):
    """One ``ResilientMDRunner.run(60)`` with the kernel counters zeroed
    just before and read just after: ``(state, metrics, report, runner,
    launches, wall s, restore ms list)``."""
    import torch
    from repro_torch.resilience import FaultPlan, FaultSpec, ResilientMDRunner

    runner = ResilientMDRunner(
        eng, ckpt_dir, plan=FaultPlan([FaultSpec(*x) for x in specs]), **kw)
    restores, restore = [], runner._restore

    def timed_restore(e):
        t0 = time.perf_counter()
        rs = restore(e)
        torch.cuda.synchronize()
        restores.append((time.perf_counter() - t0) * 1e3)
        return rs
    runner._restore = timed_restore
    t0 = time.perf_counter()
    (state, m, report), launches = serve_counted(
        lambda: runner.run(DRILL_STEPS, state=state))
    wall = time.perf_counter() - t0
    return state, m, report, runner, launches, wall, restores


def graph_nodes_by_key(eng) -> dict:
    """Each cached step graph's MD kernel nodes, by its key."""
    return {k: {f"{o.__name__}.{a}": n for (o, a), n in b.launches.items()}
            for k, b in eng.block_graphs.graphs()}


def ledger_recount(eng, n_steps: int) -> dict:
    """The per-step ``obs/*`` counters recounted on the host: the
    reference's release / acquire order of each pipeline invocation
    (nstprune-step sub-blocks), replayed on a fresh ledger."""
    import numpy as np
    from repro_torch.core.pipeline.ledger import SignalLedger

    lg = SignalLedger(eng.pipeline.depth, eng.pipeline.ledger.n_pulses)
    depth, out = lg.depth, []

    def rec(st):
        out.append((lg.in_flight(st), int(st.released.sum()),
                    int(st.acquired.sum()), int(st.clobbers.sum())))
    nst, sub = eng.system.params.nstlist, eng.nstprune or eng.system.params.nstlist
    for b0 in range(0, n_steps, nst):
        blk = min(nst, n_steps - b0)
        for s0 in range(0, blk, sub):
            n = min(sub, blk - s0)
            st = lg.release(lg.init(), "fwd", 0)
            st = lg.acquire(st, "fwd", 0)
            st = lg.release(st, "rev", 0)
            for k in range(1, n):
                st = lg.acquire(st, "rev", (k - 1) % depth)
                st = lg.release(st, "fwd", k % depth)
                st = lg.acquire(st, "fwd", k % depth)
                st = lg.release(st, "rev", k % depth)
                rec(st)
            st = lg.acquire(st, "rev", (n - 1) % depth)
            rec(st)
    keys = ("obs/in_flight", "obs/released", "obs/acquired", "obs/clobbers")
    return {k: np.array([r[i] for r in out], np.int32)
            for i, k in enumerate(keys)}


def drill_phase(system):
    """Phase 18: ``ResilientMDRunner`` on grappa-45k, bars (a)-(h)."""
    import shutil
    import statistics
    import tempfile
    import warnings

    import numpy as np
    import torch
    from repro_torch import make_mesh
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.convert import domains_to_cells
    from repro_torch.obs import MetricsRegistry
    from repro_torch.resilience import DeviceLost, ProcessKilled, RecoveryPolicy

    t18 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="drill_"))
    dirs = iter(tmp / f"run{i}" for i in itertools.count())
    print(f"drill phase: grappa-45k f32, 2x2x2, signal halo, double_buffer "
          f"depth 3, pruned pallas, nstprune 5, {DRILL_STEPS} steps; "
          "ResilientMDRunner(inject=True, health=True); kernel counters "
          "zeroed before each drive")

    # (a) disarmed: the runner against simulate, in turns P R R P
    plain = drill_engine(system)
    inj = drill_engine(system, inject=True, health=True)
    state0 = plain.init_state()
    turns, ref = [], None
    for who in "PRRP":
        torch.cuda.synchronize()
        if who == "P":
            t0 = time.perf_counter()
            ((cf, ci), m, _), launches = serve_counted(
                lambda: plain.simulate(DRILL_STEPS, state=state0))
            wall = time.perf_counter() - t0
            if ref is None:
                ref = {"cell_f": cf, "cell_i": ci, "m": m,
                       "atoms": plain.export_atoms((cf, ci)),
                       "launches": launches}
        else:
            (cf, ci), m, rep, _r, launches, wall, _ = drill_run(
                inj, next(dirs), state=state0)
            check(torch.equal(cf, ref["cell_f"]) and
                  torch.equal(ci, ref["cell_i"]) and
                  np.array_equal(m["pe"], ref["m"]["pe"]) and
                  np.array_equal(m["ke"], ref["m"]["ke"]),
                  "drill (a): the disarmed runner differs from simulate")
            check(not m["health/nonfinite"].any() and
                  not m["health/led_violation"].any() and
                  rep["events"] == [] and rep["recoveries"] == [],
                  f"drill (a): health tripped disarmed: {rep['events']}")
            check(rep["checkpoint_steps"] == [0, 20, 40, 60],
                  f"drill (a): checkpoints {rep['checkpoint_steps']}")
            check(launches == ref["launches"], f"drill (a): runner "
                  f"launches {launches} against simulate's {ref['launches']}")
        turns.append((who, wall * 1e3 / DRILL_STEPS))
    check(ref["launches"]["pair_forces"] > 0 and
          ref["launches"]["scatter_accum"] > 0 and
          ref["launches"]["put_signal"] > 0,
          f"drill (a): a kernel of the path never launched: "
          f"{ref['launches']}")
    g_plain, g_inj = graph_nodes_by_key(plain), graph_nodes_by_key(inj)
    check(g_plain == g_inj and g_plain, "drill (a): the inject engine's step "
          "graphs differ from the plain engine's in kernel nodes")
    print(f"  (a) disarmed runner == simulate bitwise (cell_f, cell_i, pe, "
          f"ke), health all zero, checkpoints [0, 20, 40, 60], "
          f"{len(g_plain)} cached step graphs with the same kernel nodes; "
          f"launches a run {ref['launches']}; host ms/step in turns "
          + " / ".join(f"{w} {v:.4f}" for w, v in turns))

    # checkpoint saves: the runner's tree, each part timed
    cf, ci = domains_to_cells(ref["cell_f"], ref["cell_i"])
    mgr = CheckpointManager(next(dirs), keep=2)
    parts = []
    for step in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        atoms = plain.export_atoms((ref["cell_f"], ref["cell_i"]))
        t_exp = time.perf_counter() - t0
        mgr.save(step, {"cell_f": cf, "cell_i": ci, "atoms": atoms})
        parts.append(dict(mgr.last_save, export_s=t_exp,
                          total_s=time.perf_counter() - t0))
    med = {k: statistics.median(p[k] for p in parts) * 1e3
           for k in ("export_s", "d2h_s", "npz_s", "fsync_s", "hash_s",
                     "total_s")}
    print(f"  checkpoint save ({parts[0]['bytes']} B; median of 5, ms): "
          + ", ".join(f"{k[:-2]} {v:.3f}" for k, v in med.items()))

    # (b) one-shot faults, each one rollback landing bitwise on (a)
    base_wall = min(v for w, v in turns if w == "R") * DRILL_STEPS / 1e3
    for site, step, kind in (("halo_corrupt", 27, "nonfinite"),
                             ("force_nan", 43, "nonfinite"),
                             ("signal_drop", 7, "ledger")):
        (cf, ci), m, rep, _r, launches, wall, rest = drill_run(
            inj, next(dirs), [(site, step)], state=state0)
        rec = rep["recoveries"]
        check(len(rec) == 1 and rec[0]["action"] == "rollback" and
              kind in rec[0]["kinds"] and
              rec[0]["block_step"] == step // 20 * 20 and
              0 < rec[0]["detection_latency_steps"] <= 20,
              f"drill (b) {site}@{step}: recoveries {rec}")
        check(torch.equal(cf, ref["cell_f"]) and
              torch.equal(ci, ref["cell_i"]),
              f"drill (b) {site}@{step}: the rollback did not land bitwise")
        print(f"  (b) {site}@{step}: {kind} at step "
              f"{rep['events'][0]['step']} (value "
              f"{rep['events'][0]['value']:.0f}), one rollback, bitwise on "
              f"(a); restore {rest[0]:.3f} ms, run {wall * 1e3:.1f} ms "
              f"({(wall - base_wall) * 1e3:+.1f} against the disarmed run)")
        if site == "force_nan":
            first = rep
    # (c) determinism
    rep2 = drill_run(inj, next(dirs), [("force_nan", 43)], state=state0)[2]
    check(rep2["recoveries"] == first["recoveries"] and
          rep2["events"] == first["events"],
          "drill (c): the same plan gave another report")
    print("  (c) force_nan@43 twice: the same recoveries and events")

    # (d) sticky faults walk the ladder
    pol = RecoveryPolicy(max_retries=2, backoff_base_s=0.0)
    (cf, ci), m, rep, run, launches, wall, _ = drill_run(
        inj, next(dirs), [("signal_drop", 7, True)], state=state0, policy=pol)
    acts = [r["action"] for r in rep["recoveries"]]
    check(acts == ["rollback", "rollback", "degrade"] and
          rep["recoveries"][-1]["detail"] == "serialized_halo" and
          set(rep["fault_plan"]["disabled_sites"]) ==
          {"halo_corrupt", "signal_drop"} and
          run.engine.spec.backend == "serialized",
          f"drill (d) sticky signal_drop: {rep['recoveries']}")
    check(torch.equal(cf, ref["cell_f"]) and torch.equal(ci, ref["cell_i"]),
          "drill (d): the serialized_halo rung is not bitwise on (a)")
    del run
    pol = RecoveryPolicy(max_retries=2, backoff_base_s=0.0)
    (cf, ci), m, rep, run, launches, wall, _ = drill_run(
        inj, next(dirs), [("force_nan", 43, True)], state=state0, policy=pol)
    acts = [r["action"] for r in rep["recoveries"]]
    check(acts == ["rollback", "rollback", "degrade"] and
          rep["recoveries"][-1]["detail"] == "dense_forces" and
          run.engine.force_backend == "dense",
          f"drill (d) sticky force_nan: {rep['recoveries']}")
    E = m["pe"] + m["ke"]
    n = system.n_atoms
    spread = float((E.max() - E.min()) / n)
    check(bool(torch.isfinite(cf).all()) and
          int((ci[..., 0] >= 0).sum()) == n and spread < 5e-3 and
          E.shape == (DRILL_STEPS,),
          f"drill (d) sticky force_nan: finite / atoms / NVE {spread}")
    diff = float((cf - ref["cell_f"]).abs().max())
    del run
    torch.cuda.synchronize()
    print(f"  (d) sticky signal_drop@7: rollback, rollback, degrade "
          f"serialized_halo, sites {{halo_corrupt, signal_drop}} retired, "
          f"bitwise on (a); sticky force_nan@43: rollback, rollback, degrade "
          f"dense_forces, finite, {n} atoms, NVE spread {spread:.3e} per "
          f"atom, largest cell_f difference from (a) {diff:.3e}; "
          f"memory_reserved {torch.cuda.memory_reserved()} B")

    # (e) forced inner-ladder overflow at steps 0 and 20
    reg = MetricsRegistry()
    ovf_eng = drill_engine(system, inject=True, health=True, obs=reg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _s, _m, rep, _r, launches, wall, _ = drill_run(
            ovf_eng, next(dirs), [("inner_overflow", 0),
                                  ("inner_overflow", 20)], state=state0)
    warned = [w for w in caught if "rolling inner prune" in str(w.message)]
    sched = [r["inner_disabled"] for r in reg.records
             if r.get("kind") == "sched_update"]
    falls = [r for r in rep["recoveries"] if r["action"] == "engine_fallback"]
    check(len(falls) == 2 and len(warned) == 1 and
          reg.counter("md/inner_overflow_blocks").value == 2 and
          sched == [False, True, True] and rep["wasted_steps"] == 0,
          f"drill (e): fallbacks {falls}, warnings {len(warned)}, "
          f"inner_disabled {sched}")
    print("  (e) inner_overflow@0, @20: two engine_fallback recoveries, one "
          "warning, md/inner_overflow_blocks 2, inner_disabled [False, True, "
          "True]")
    ovf_eng.release_graphs()
    del ovf_eng, _s, _m, _r

    # (f) process kill at 40, then a fresh runner resumes
    d = next(dirs)
    try:
        drill_run(inj, d, [("proc_kill", 40)], state=state0)
        fail("drill (f): proc_kill did not raise")
    except ProcessKilled:
        pass
    (cf, ci), m, rep, _r, launches, wall, _ = drill_run(inj, d)
    check(rep["resumed_from"] == 40 and torch.equal(cf, ref["cell_f"]) and
          torch.equal(ci, ref["cell_i"]),
          f"drill (f): resumed from {rep['resumed_from']}, not bitwise")
    print(f"  (f) proc_kill@40 raised ProcessKilled; a fresh runner resumed "
          f"from 40 bitwise on (a) ({wall * 1e3:.1f} ms)")

    # (g) device loss at 40: reshard onto (2, 2, 1)
    spare = make_mesh((2, 2, 1), AXES)
    (cf, ci), m, rep, run, launches, wall, _ = drill_run(
        inj, next(dirs), [("device_loss", 40)], state=state0,
        spare_mesh=spare)
    atoms = run.engine.export_atoms((cf, ci))
    vscale = float(np.abs(ref["atoms"]["vel"]).max())
    dpos = float(np.abs(atoms["pos"] - ref["atoms"]["pos"]).max())
    dvel = float(np.abs(atoms["vel"] - ref["atoms"]["vel"]).max()) / vscale
    check(rep["resharded"] and run.engine.axis_sizes == (2, 2, 1) and
          int((ci[..., 0] >= 0).sum()) == system.n_atoms and
          dpos < 1e-4 and dvel < 1e-4,
          f"drill (g): resharded {rep['resharded']}, positions {dpos}, "
          f"velocities {dvel}")
    run.engine.release_graphs()
    del run
    try:
        drill_run(inj, next(dirs), [("device_loss", 40)], state=state0)
        fail("drill (g): device loss without a spare mesh did not raise")
    except DeviceLost:
        pass
    torch.cuda.synchronize()
    print(f"  (g) device_loss@40: resharded onto (2, 2, 1), "
          f"{system.n_atoms} atoms, largest position difference {dpos:.3e}, "
          f"velocity {dvel:.3e} of the scale; without a spare mesh "
          f"DeviceLost; memory_reserved {torch.cuda.memory_reserved()} B")

    # (h) trace=True: bitwise neutral, replays, obs/* as a host recount
    trc = drill_engine(system, trace=True, inject=True, health=True)
    ((cf, ci), m, _), launches = serve_counted(
        lambda: trc.simulate(DRILL_STEPS, state=state0))
    st = trc.block_graphs.stats()
    recount = ledger_recount(trc, DRILL_STEPS)
    check(torch.equal(cf, ref["cell_f"]) and
          np.array_equal(m["pe"], ref["m"]["pe"]) and
          launches == ref["launches"] and st["replays"] > 0 and
          all(np.array_equal(m[k], v) for k, v in recount.items()),
          f"drill (h): trace not neutral / no replays ({st}) / obs counters "
          "differ from the host recount")
    print(f"  (h) trace=True bitwise on (a), {st['replays']} replays, "
          f"obs/* ({len(recount)} counters x {DRILL_STEPS} steps) equal the "
          "host recount")
    trc.release_graphs()
    plain.release_graphs()
    inj.release_graphs()
    shutil.rmtree(tmp)
    print(f"phase 18: {time.perf_counter() - t18:.1f} s")


# ---- phase 19: train qwen3-1.7b at full width through the kernels and B7b ----

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_EVERY, TRAIN_KILL = 4, 1024, 6, 3, 4
KILL_LAYERS = 1            # the killed-and-resumed run's depth (full width)
BWD_TOL = {"bfloat16": 2e-2, "float32": 2e-5}      # of max |grad|, vs plain
BWD_ORACLE_TOL = {"bfloat16": 0.06, "float32": 2e-5}  # of max |grad|, vs f64
GRAD_TOL = 1e-4            # 2-layer f32 card vs CPU, of each leaf's max


def flash_bwd_work(BH, L, S, G, hd, causal, elem):
    """(bytes, operations) one backward needs: q, k, v, out, dout and the
    f32 lse read once, dq, dk, dv written once; five products (q.k, dO.v,
    P^T dO, dS^T q, dS k), 2 operations each per (row, key, dim) that the
    causal mask keeps."""
    pairs = sum(min(p + 1, S) for p in range(L)) if causal else L * S
    nbytes = (4 * BH * L * G * hd + 4 * BH * S * hd) * elem + 4 * BH * L * G
    return nbytes, 10 * BH * G * hd * pairs


def sdpa_backward(q, k, v, dout, causal):
    """SDPA's backward (the yardstick) on B7b's inputs in SDPA's layout,
    kv heads repeated G times, its forward outside the timing: (ms a call
    over 50 calls, its dq in B7b's layout)."""
    import torch
    BH, L, G, hd = q.shape
    S = k.shape[1]
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k[:, None].expand(BH, G, S, hd).contiguous().requires_grad_()
    vt = v[:, None].expand(BH, G, S, hd).contiguous().requires_grad_()
    lib = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal)
    dt_ = dout.transpose(1, 2).contiguous()
    ldq = torch.autograd.grad(lib, (qt,), dt_, retain_graph=True)[0]
    ms = cuda_ms(lambda: torch.autograd.grad(lib, (qt, kt, vt), dt_,
                                             retain_graph=True),
                 n=50, warmup=5)
    return ms, ldq.transpose(1, 2)


def b7b_speed(label):
    """B7b and SDPA's backward at the training shape in bf16 (BH 32, L = S =
    1024, G 2, hd 128, causal), CUDA events over 50 calls each: with
    ``--kernels CHECKOUT`` the other checkout's B7b, for a same-call
    comparison with this one's (phase 19)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    BH, L, S, G, hd = 32, 1024, 1024, 2, 128
    gen = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                     .to(torch.bfloat16)
                     for shape in ((BH, L, G, hd), (BH, S, hd), (BH, S, hd),
                                   (BH, L, G, hd)))
    o, lse = fa._forward(q, k, v, True, with_lse=True)
    t_k = cuda_ms(lambda: fa.flash_attention_backward(
        q, k, v, o, dout, lse, causal=True), n=50, warmup=5)
    t_l, _ = sdpa_backward(q, k, v, dout, True)
    nbytes, ops = flash_bwd_work(BH, L, S, G, hd, True, 2)
    bound = max(nbytes / HBM_BPS, ops / BF16_FLOPS) * 1e3
    print(f"B7b ({label}) at the training shape, bf16: {t_k:.6f} ms a "
          f"launch ({bound / t_k:.4f} of the {bound:.6f} ms bound), SDPA's "
          f"backward {t_l:.6f} ms")
    return t_k, t_l


def b7b_at(label, BH, L, S, G, hd, seed):
    """B7b at one causal bf16 shape against its plain backward and the f64
    oracle at phase 19's bars, bitwise on repeat, timed beside its plain
    backward, SDPA's backward and the bound: ``(entry for the kernels
    line, the per-gradient errors as text)``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                     .to(torch.bfloat16)
                     for shape in ((BH, L, G, hd), (BH, S, hd), (BH, S, hd),
                                   (BH, L, G, hd)))
    o, lse = fa._forward(q, k, v, True, with_lse=True)
    grads = fa.flash_attention_backward(q, k, v, o, dout, lse, causal=True)
    again = fa.flash_attention_backward(q, k, v, o, dout, lse, causal=True)
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          f"B7b at {label}: two launches differ")
    plain = fa.flash_attention_backward_plain(q, k, v, dout, causal=True)
    oracle = ref.flash_attention_backward_ref(q, k, v, dout, causal=True)
    line, worst = [], 0.0
    for name, a, b, c in zip("qkv", grads, plain, oracle):
        scale = float(c.abs().max())
        e = float((a.double() - b.double()).abs().max())
        eo = float((a.double() - c).abs().max())
        check(bool(torch.isfinite(a).all()) and
              e <= BWD_TOL["bfloat16"] * scale and
              eo <= BWD_ORACLE_TOL["bfloat16"] * scale,
              f"B7b at {label}: d{name} {e} from its plain form, "
              f"{eo} from the f64 oracle (scale {scale})")
        line.append(f"d{name} {e / scale:.3e} / {eo / scale:.3e}")
        worst = max(worst, e)
    del again, plain, oracle
    nbytes, ops = flash_bwd_work(BH, L, S, G, hd, True, 2)
    bound = max(nbytes / HBM_BPS, ops / BF16_FLOPS) * 1e3
    t_k = cuda_ms(lambda: fa.flash_attention_backward(
        q, k, v, o, dout, lse, causal=True), n=50, warmup=5)
    t_p = cuda_ms(lambda: fa.flash_attention_backward_plain(
        q, k, v, dout, causal=True), n=3, warmup=1)
    t_l, _ = sdpa_backward(q, k, v, dout, True)
    entry = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
             "bound_ms": bound, "max_abs_err": worst}
    text = (f"vs plain / vs oracle, of max |grad|: {'; '.join(line)}; "
            f"bitwise on repeat; B7b {t_k:.6f} ms, plain backward {t_p:.6f} "
            f"ms, SDPA backward {t_l:.6f} ms, bound {bound:.6f} ms "
            f"({bound / t_k:.4f} of it; {ops / (t_k * 1e-3) / 1e12:.2f} "
            f"TFLOP/s)")
    return entry, text


def b7b_sass(lib_path):
    """``cuobjdump -sass`` of B7b: HGMMA in every bf16 dK / dV and dQ
    kernel at every head_dim, no atomic instruction in any backward
    kernel (either dtype)."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    sass = {key: c for key, c in flash_sass_counts(lib_path).items()
            if key[0].startswith("flash_bwd")}
    kerns = ("flash_bwd_prep_bf16", "flash_bwd_dkdv_bf16",
             "flash_bwd_dq_bf16", "flash_bwd_delta_f32", "flash_bwd_dkdv_f32",
             "flash_bwd_dq_f32")
    print("B7b SASS (cuobjdump -sass): HGMMA / atomic instructions per "
          "kernel, by head_dim: " + "; ".join(
              f"{kern} " + ", ".join(
                  f"{hd}: {sass[kern, hd]['HGMMA']} / "
                  f"{sass[kern, hd]['atomic']}"
                  for hd in HEAD_DIMS if (kern, hd) in sass)
              for kern in kerns))
    check(sorted(sass) == sorted((k, hd) for k in kerns for hd in HEAD_DIMS),
          f"B7b SASS: kernels {sorted(sass)}")
    check(all(sass[kern, hd]["HGMMA"] > 0 for hd in HEAD_DIMS
              for kern in ("flash_bwd_dkdv_bf16", "flash_bwd_dq_bf16")),
          "a bf16 B7b product kernel holds no HGMMA")
    check(all(c["atomic"] == 0 for c in sass.values()),
          "a B7b kernel holds an atomic instruction")


def b7b_phase(lib_path):
    """B7b's SASS (``b7b_sass``); B7b against its plain form (autograd
    through flash_attention_plain) and the float64 oracle, at the training
    shape (BH = 4 x 8, L = S = 1024, G = 2, hd = 128) in bf16 and f32,
    non-causal, ragged L = S = 1000, hd 64 and hd 16 (L != S): errors as a
    share of the oracle's max |grad| per output; two launches bitwise
    equal; the _lse entry's out bitwise equal to the serving entry's; the
    training shape in bf16 timed beside the plain form, SDPA's backward and
    the bound."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    b7b_sass(lib_path)
    cases = [("train", 32, 1024, 1024, 2, 128, True),
             ("full", 32, 1024, 1024, 2, 128, False),
             ("ragged", 32, 1000, 1000, 2, 128, True),
             ("hd64", 16, 512, 512, 4, 64, True),
             ("hd16 full", 8, 256, 300, 2, 16, False)] + \
        [(f"whisper {tag}",) + shape for tag, shape in WHISPER_SHAPES.items()]
    gen = torch.Generator(device="cuda").manual_seed(19)
    errs = {"bfloat16": 0.0, "float32": 0.0}
    abs_err, whisper = 0.0, {}
    print("B7b phase: flash_attention_backward against its plain form and "
          f"the f64 oracle (max abs err / max |oracle grad|; tolerance "
          f"{BWD_TOL}; oracle {BWD_ORACLE_TOL})")
    out = None
    for tag, BH, L, S, G, hd, causal in cases:
        base = [torch.randn(shape, generator=gen, device="cuda")
                for shape in ((BH, L, G, hd), (BH, S, hd), (BH, S, hd),
                              (BH, L, G, hd))]
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            q, k, v, dout = (x.to(dtype) for x in base)
            served = fa.flash_attention(q, k, v, causal=causal)
            o, lse = fa._forward(q, k, v, causal, with_lse=True)
            check(torch.equal(o, served), f"B7b {tag} {name}: the _lse "
                  "entry's out differs from the serving entry's")
            got = fa.flash_attention_backward(q, k, v, o, dout, lse,
                                              causal=causal)
            again = fa.flash_attention_backward(q, k, v, o, dout, lse,
                                                causal=causal)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"B7b {tag} {name}: two launches differ")
            want = fa.flash_attention_backward_plain(q, k, v, dout,
                                                     causal=causal)
            oracle = ref.flash_attention_backward_ref(q, k, v, dout,
                                                      causal=causal)
            torch.cuda.synchronize()
            line = []
            for label, a, b, c in zip("qkv", got, want, oracle):
                check(a.dtype == dtype and a.shape == b.shape and
                      bool(torch.isfinite(a).all()),
                      f"B7b {tag} {name}: d{label} dtype / shape / finite")
                scale = float(c.abs().max())
                e = float((a.double() - b.double()).abs().max())
                eo = float((a.double() - c).abs().max())
                line.append(f"d{label} {e / scale:.3e} / {eo / scale:.3e} "
                            f"(max {scale:.3f})")
                check(e <= BWD_TOL[name] * scale, f"B7b {tag} {name}: "
                      f"d{label} {e} from its plain form (scale {scale})")
                check(eo <= BWD_ORACLE_TOL[name] * scale, f"B7b {tag} "
                      f"{name}: d{label} {eo} from the f64 oracle")
                errs[name] = max(errs[name], e / scale)
                if dtype == torch.bfloat16:
                    abs_err = max(abs_err, e)
            print(f"  {tag:9s} {name:8s} BH={BH} L={L} S={S} G={G} hd={hd} "
                  f"causal={causal}: vs plain / vs oracle {'; '.join(line)};"
                  " bitwise on repeat, out == serving out")
            if tag.startswith("whisper") and dtype == torch.bfloat16:
                nbytes, ops = flash_bwd_work(BH, L, S, G, hd, causal, 2)
                bound = max(nbytes / HBM_BPS, ops / BF16_FLOPS) * 1e3
                t_k = cuda_ms(lambda: fa.flash_attention_backward(
                    q, k, v, o, dout, lse, causal=causal), n=50, warmup=5)
                t_p = cuda_ms(lambda: fa.flash_attention_backward_plain(
                    q, k, v, dout, causal=causal), n=3, warmup=1)
                t_l, ldq = sdpa_backward(q, k, v, dout, causal)
                lerr = float((ldq.double() - want[0].double()).abs().max())
                check(lerr <= 2 * BWD_TOL[name] * float(
                    oracle[0].abs().max()), f"SDPA backward yardstick at "
                    f"{tag}: {lerr} from the plain form")
                print(f"  {tag} bf16: B7b {t_k:.6f} ms, plain backward "
                      f"{t_p:.6f} ms, SDPA backward {t_l:.6f} ms, bound "
                      f"{bound:.6f} ms ({ops} operations, {nbytes} bytes; "
                      f"{bound / t_k:.4f} of it, "
                      f"{ops / (t_k * 1e-3) / 1e12:.2f} TFLOP/s)")
                whisper[tag.split()[1]] = {
                    "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                    "bound_ms": bound, "max_abs_err": max(
                        float((a.double() - b.double()).abs().max())
                        for a, b in zip(got, want))}
                del ldq
            if tag != "train" or dtype != torch.bfloat16:
                del oracle, want
                continue
            nbytes, ops = flash_bwd_work(BH, L, S, G, hd, causal,
                                         q.element_size())
            bound = max(nbytes / HBM_BPS, ops / BF16_FLOPS) * 1e3
            t_k = cuda_ms(lambda: fa.flash_attention_backward(
                q, k, v, o, dout, lse, causal=causal), n=50, warmup=5)
            t_p = cuda_ms(lambda: fa.flash_attention_backward_plain(
                q, k, v, dout, causal=causal), n=3, warmup=1)
            t_l, ldq = sdpa_backward(q, k, v, dout, causal)
            lerr = float((ldq.double() - want[0].double()).abs().max())
            check(lerr <= 2 * BWD_TOL[name] * float(oracle[0].abs().max()),
                  f"SDPA backward yardstick: {lerr} from the plain form")
            prof = _profile(lambda: fa.flash_attention_backward(
                q, k, v, o, dout, lse, causal=causal), 20)
            split = "not measured (no CUDA events)" if prof is None else \
                ", ".join(f"{m.group(0)} {t:.2f}"
                          for name, (t, _) in sorted(prof[4].items())
                          if (m := re.search(r"flash_bwd_\w+<\d+>", name))
                          ) + " device us a launch"
            print(f"  train bf16: B7b's kernels (torch.profiler, 20 "
                  f"launches): {split}")
            print(f"  train bf16: B7b {t_k:.6f} ms ({t_k * 1e3:.1f} device "
                  f"us a launch), plain backward {t_p:.6f} ms, SDPA "
                  f"backward {t_l:.6f} ms, bound {bound:.6f} ms "
                  f"({nbytes} bytes, {ops} operations at 989 TFLOP/s), "
                  f"B7b at {ops / (t_k * 1e-3) / 1e12:.2f} TFLOP/s "
                  f"({bound / t_k:.4f} of the bound)")
            out = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                   "bound_ms": bound, "bytes": nbytes, "ops": ops,
                   "peak": BF16_FLOPS}
            del ldq, oracle, want
    out["max_abs_err"] = abs_err
    out["whisper_shapes"] = whisper
    print(f"B7b max err against the plain form, of max |grad|: bf16 "
          f"{errs['bfloat16']:.3e}, f32 {errs['float32']:.3e}; max abs "
          f"err bf16 {abs_err:.3e}")
    return {"flash_attention_backward": out}


def param_digest(params) -> str:
    """A digest of every parameter's bits: per leaf, the int64 sum of its
    float32 words weighted by their position (on the card), hashed."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for name in sorted(params):
        bits = params[name].detach().view(torch.int32).reshape(-1) \
            .to(torch.int64)
        w = torch.arange(1, bits.numel() + 1, device=bits.device)
        h.update(f"{name}:{int((bits * w).sum())};".encode())
        del bits, w
    return h.hexdigest()[:16]


def train_phase(b7b):
    """qwen3-1.7b at full width and depth through ``launch.train.main``:
    batch 4 x seq 1024, AdamW as the launcher sets it, 6 steps, every
    drive with the kernel counters zeroed just before and read just after;
    two fresh runs bitwise equal (losses, grad norms, a digest of every
    parameter); at full width cut to ``KILL_LAYERS`` (its checkpoint 8.1
    GB against 24.4 GB at full depth, whose write and restore took 211 s
    of a 1,186 s smoke on an NVIDIA H100 80GB HBM3 at 700 W), a run with a
    checkpoint every 3 steps killed after step 4 and resumed from its
    step-3 checkpoint, equal to an uninterrupted run at that depth; launch
    counts against layers x (forward + remat recompute) x microbatches x
    steps; then a 2-layer full-width f32 model's loss and every gradient
    on the card against the CPU; ms a step, tokens/s, peak memory and a
    profiled step.  The card's machine takes at most 45 GiB of disk writes
    a call, so only the killed run writes a checkpoint (step 3); the other
    runs and the resumed part run with ``--ckpt-every 0`` (no
    checkpoints), which changes no number of a step."""
    import dataclasses
    import gc
    import shutil

    import numpy as np
    import torch
    from repro_torch import build_model, get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward)
    from repro_torch.launch import train as train_launch

    t19 = time.perf_counter()
    cfg = get_config("qwen3-1.7b")
    check(cfg.remat and cfg.remat_policy == "nothing" and
          cfg.compute_dtype == "bfloat16", f"qwen3-1.7b config changed: {cfg}")
    counters = {**kernel_counters(), "flash_attention": flash_attention,
                "flash_attention_backward": flash_attention_backward}
    work = ROOT / "build" / "phase19"
    shutil.rmtree(work, ignore_errors=True)

    def drive(tag, every=0, extra=()):
        argv = ["--arch", "qwen3-1.7b", "--steps", str(TRAIN_STEPS),
                "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--ckpt-every", str(every), "--ckpt-dir", str(work / tag),
                *extra]
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        try:
            res = train_launch.main(argv)
        except RuntimeError as e:
            check("injected failure" in str(e), f"train {tag}: {e}")
            res = None
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        return res, launches, wall

    def expect(launches, steps, tag, layers=cfg.n_layers):
        mb = 1
        fwd = layers * 2 * mb * steps            # forward + remat recompute
        bwd = layers * mb * steps
        check(launches["flash_attention"] == fwd and
              launches["flash_attention_backward"] == bwd,
              f"train {tag}: launches {launches}, expected flash_attention "
              f"{fwd}, flash_attention_backward {bwd}")
        check(all(n == 0 for k, n in launches.items()
                  if not k.startswith("flash")), f"train {tag}: an MD "
              "kernel ran while training")

    def summary(res):
        prog, params, opt, hist = res
        return ([(h["step"], h["loss"], h["grad_norm"]) for h in hist],
                param_digest(params), int(opt["step"]))

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    res_a, launches_a, wall_a = drive("a")
    peak = torch.cuda.max_memory_allocated()
    expect(launches_a, TRAIN_STEPS, "a")
    hist_a, digest_a, opt_step = summary(res_a)
    prog = res_a[0]
    check(prog.microbatches == 1 and
          sum(p.numel() for p in prog.params.values()) == 2_031_739_904,
          "train: the program is not qwen3-1.7b at one microbatch")
    check(all(math.isfinite(l) and math.isfinite(g) for _, l, g in hist_a),
          f"train a: non-finite loss / grad norm {hist_a}")
    dts_a = [h["dt"] for h in res_a[3]]
    print(f"train phase: qwen3-1.7b, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
          f"{TRAIN_STEPS} steps; run a "
          f"{wall_a:.2f} s (steps {sum(dts_a):.2f} s), launches "
          f"{launches_a}; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)")
    for step, loss, gn in hist_a:
        print(f"  step {step}: loss {loss:.6f} grad_norm {gn:.6f}")
    check(opt_step == TRAIN_STEPS, f"train a: AdamW step {opt_step}")
    # a profiled step of run a's program (after its 6 steps)
    batch = {"tokens": torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int32)).cuda()}
    _, params, opt, _ = res_a
    prof = _profile(lambda: prog.step_fn(params, opt, batch), 1)
    if prof is None:
        print("  train profile: device time not measured (no CUDA events)")
    else:
        wall, device, n_kern, busy, by_name = prof
        for label, key in (("B7b", "flash_bwd"), ("flash forward",
                                                  "flash_kernel")):
            sel = [(t, k) for name, (t, k) in by_name.items() if key in name]
            tt, kk = sum(x[0] for x in sel), sum(x[1] for x in sel)
            print(f"  train profile: {label} {kk:.0f} kernels, "
                  f"{tt / 1e3:.4f} ms, {tt / device:.4f} of device time")
        print(f"  train profile (torch.profiler, one step): host wall "
              f"{wall / 1e3:.4f} ms, device kernel time {device / 1e3:.4f} "
              f"ms, {n_kern:.0f} kernels, device busy {busy:.4f} of the host "
              f"wall")
        for name, (t, k) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:12]:
            print(f"    kernel {t / device:7.4f} {t / 1e3:10.4f} ms "
                  f"{k:7.0f}x {name[:90]}")
    del prog, params, opt, batch, res_a
    release()
    shutil.rmtree(work / "a", ignore_errors=True)

    res_b, launches_b, wall_b = drive("b")
    expect(launches_b, TRAIN_STEPS, "b")
    hist_b, digest_b, _ = summary(res_b)
    dts_b = [h["dt"] for h in res_b[3]]
    del res_b
    release()
    shutil.rmtree(work / "b", ignore_errors=True)
    print(f"  run b: {wall_b:.2f} s; losses, grad norms and parameter "
          f"digest {digest_b} {'==' if hist_b == hist_a else '!='} run a's "
          f"{digest_a}")
    check(hist_b == hist_a and digest_b == digest_a,
          f"train: two fresh runs differ: {hist_a} vs {hist_b}, "
          f"{digest_a} vs {digest_b}")

    cut = ["--n-layers", str(KILL_LAYERS)]
    res_d, launches_d, wall_d = drive("d", extra=cut)
    expect(launches_d, TRAIN_STEPS, "d", KILL_LAYERS)
    hist_d, digest_d, _ = summary(res_d)
    del res_d
    release()
    res_k, launches_k, wall_k = drive("c", TRAIN_EVERY,
                                      cut + ["--fail-at-step",
                                             str(TRAIN_KILL)])
    check(res_k is None, "train c: the run was not killed")
    release()
    expect(launches_k, TRAIN_KILL, "c killed", KILL_LAYERS)
    res_r, launches_r, wall_r = drive("c", extra=cut)
    expect(launches_r, TRAIN_STEPS - TRAIN_EVERY, "c resumed", KILL_LAYERS)
    hist_r, digest_r, _ = summary(res_r)
    del res_r
    release()
    shutil.rmtree(work, ignore_errors=True)
    print(f"  run d, {KILL_LAYERS} layer at full width, uninterrupted "
          f"({wall_d:.2f} s), digest {digest_d}; run c, the same with a "
          f"checkpoint every {TRAIN_EVERY}, killed after step {TRAIN_KILL} "
          f"({wall_k:.2f} s: 4 steps and one save) and resumed from step "
          f"{TRAIN_EVERY} ({wall_r:.2f} s: restore and 3 steps): steps "
          f"{[h[0] for h in hist_r]}, digest {digest_r}")
    check(hist_r == hist_d[TRAIN_EVERY:] and digest_r == digest_d,
          f"train: the resumed run differs: {hist_r} vs "
          f"{hist_d[TRAIN_EVERY:]}, {digest_r} vs {digest_d}")
    steady = sorted(dts_a[1:] + dts_b[1:])
    step_ms = steady[len(steady) // 2] * 1e3
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms * 1e-3)
    print(f"  train speed: median {step_ms:.4f} ms a step over steps 1-5 of "
          f"runs a and b ({[round(d * 1e3, 3) for d in dts_a]}, "
          f"{[round(d * 1e3, 3) for d in dts_b]} ms), {tok_s:.3f} "
          f"tokens/s; B7b {b7b['ms'] * 1e3:.1f} device us a launch, SDPA's "
          f"backward {b7b['library_ms'] * 1e3:.1f} us, "
          f"{cfg.n_layers} launches a step: "
          f"{cfg.n_layers * b7b['ms']:.3f} ms of the step")

    # a 2-layer full-width model in f32: loss and every gradient on the
    # card (kernels) against the CPU (plain forms), TF32 off
    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    small = build_model(cfg2).init(
        torch.Generator(device="cuda").manual_seed(1))
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab, (2, 257)).astype(np.int32))
    for fn in counters.values():
        fn.launches = 0
    loss_c, _ = small.loss_fn({"tokens": toks.cuda()})
    loss_c.backward()
    check(flash_attention.launches == 4 and
          flash_attention_backward.launches == 2,
          f"the f32 card loss launched flash_attention "
          f"{flash_attention.launches} / backward "
          f"{flash_attention_backward.launches} times, not 4 / 2")
    grads_c = {n: p.grad.cpu() for n, p in small.named_parameters()}
    loss_c = float(loss_c.detach())
    small.zero_grad(set_to_none=True)
    small.to("cpu")
    loss_h, _ = small.loss_fn({"tokens": toks})
    loss_h.backward()
    worst, worst_name = 0.0, ""
    for n, p in small.named_parameters():
        scale = float(p.grad.abs().max())
        e = float((grads_c[n] - p.grad).abs().max()) / max(scale, 1e-30)
        check(math.isfinite(e) and scale > 0, f"f32 grad {n}: {e}, {scale}")
        if e > worst:
            worst, worst_name = e, n
    lrel = abs(loss_c - float(loss_h)) / abs(float(loss_h))
    print(f"  2-layer full-width f32 loss and gradients (2 x 256 tokens), "
          f"card vs CPU: loss {loss_c:.7f} vs {float(loss_h):.7f} (rel "
          f"{lrel:.3e}), worst leaf {worst_name} {worst:.3e} of its max "
          f"|grad| (tolerance {GRAD_TOL}, TF32 off)")
    check(lrel <= GRAD_TOL and worst <= GRAD_TOL,
          f"f32 card gradients {worst} ({worst_name}) / loss {lrel} from "
          "the CPU's")
    del small, grads_c
    gc.collect()
    print(f"phase 19: {time.perf_counter() - t19:.1f} s")
    return {"flash_attention": launches_a["flash_attention"],
            "flash_attention_backward":
                launches_a["flash_attention_backward"]}


# ---- phase 20: Mixture-of-Experts, olmoe-1b-7b served and trained -----------

MOE_ARCH = "olmoe-1b-7b"
MOE_PARAMS = 6_919_100_416          # full width and depth
MOE_TRAIN_LAYERS, MOE_TRAIN_PARAMS = 4, 1_884_310_528   # f32 state fits 80 GB


def moe_flash_phase():
    """B7 and B7b at olmoe's attention shape (16 q heads over 16 kv heads,
    so G = 1; BH = 4 x 16, L = S = 1024, hd 128, causal, bf16): B7 against
    its plain form and the f64 oracle at phase 13's bars, B7b against its
    plain backward and the f64 oracle at phase 19's, each timed beside its
    plain form, SDPA (its backward) and the bound."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    BH, L, S, G, hd = 64, 1024, 1024, 1, 128
    gen = torch.Generator(device="cuda").manual_seed(20)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                     .to(torch.bfloat16)
                     for shape in ((BH, L, G, hd), (BH, S, hd), (BH, S, hd),
                                   (BH, L, G, hd)))
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    err = float((got.double() - want.double()).abs().max())
    oerr = float((got.double() - ref.flash_attention_ref(
        q, k, v, causal=True)).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= FLASH_TOL["bfloat16"]
          and oerr <= ORACLE_TOL["bfloat16"], f"B7 at olmoe's shape: "
          f"{err} from its plain form, {oerr} from the f64 oracle")
    nbytes, ops = flash_work(BH, L, S, G, hd, True, 2)
    bound = max(nbytes / HBM_BPS, ops / BF16_FLOPS) * 1e3
    t_k = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), n=50,
                  warmup=5)
    t_p = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True),
                  n=3, warmup=1)
    qt, kt, vt = q.transpose(1, 2).contiguous(), k[:, None], v[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_l = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), n=50, warmup=5)
    print(f"MoE phase (a): B7 at olmoe's prefill shape (BH {BH}, L = S = "
          f"{L}, G {G}, hd {hd}, causal, bf16): vs plain {err:.3e}, vs f64 "
          f"oracle {oerr:.3e}; kernel {t_k:.6f} ms, plain {t_p:.6f} ms, "
          f"SDPA {t_l:.6f} ms, bound {bound:.6f} ms ({bound / t_k:.4f} of "
          f"it; {ops / (t_k * 1e-3) / 1e12:.2f} TFLOP/s)")
    b7 = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": bound,
          "max_abs_err": err}
    del got, want, qt, kt, vt, q, k, v, dout
    b7b, text = b7b_at("olmoe's shape", BH, L, S, G, hd, 20)
    print(f"  B7b at olmoe's training shape (the same): {text}")
    return {"flash_attention": b7, "flash_attention_backward": b7b}


@contextlib.contextmanager
def routing_record(per_token=False):
    """Record each MoE routing while the block runs: (top_e on the host,
    the smallest gap between a token's k-th and (k+1)-th router logit, or
    with ``per_token`` every token's gap on the host)."""
    import torch
    from repro_torch.models import moe

    real, seen = moe._route, []

    def spy(x2d, router_w, m):
        out = real(x2d, router_w, m)
        with torch.no_grad():
            top = torch.topk(x2d.float() @ router_w.float(),
                             m.top_k + 1).values
            gap = top[:, -2] - top[:, -1]
            seen.append((out[0].cpu(),
                         gap.cpu() if per_token else float(gap.min())))
        return out

    moe._route = spy
    try:
        yield seen
    finally:
        moe._route = real


def same_routing(card, cpu, label):
    """The card and the CPU chose the same top-k sets in every MoE layer
    (a flip there moves a whole token): prints the smallest logit gap."""
    check(len(card) == len(cpu) > 0, f"{label}: {len(card)} routings on the "
          f"card, {len(cpu)} on the CPU")
    gap = min(g for _, g in card + cpu)
    print(f"  {label}: {len(card)} MoE routings, the same top-k experts on "
          f"the card and the CPU; smallest gap between a token's k-th and "
          f"(k+1)-th router logit {gap:.3e}")
    for n, ((a, _), (b, _)) in enumerate(zip(card, cpu)):
        check(torch_equal_sets(a, b), f"{label}: layer {n} routed "
              f"differently on the card and the CPU (smallest logit gap "
              f"{gap:.3e})")


def torch_equal_sets(a, b) -> bool:
    """Two (T, K) top-k index tensors pick the same set per token."""
    import torch
    return bool(torch.equal(a.sort(dim=-1).values, b.sort(dim=-1).values))


def moe_dense_prefill(model, toks, cache=None):
    """``model.prefill`` through the dense oracle (every expert on every
    token: no capacity, so no drops)."""
    model.moe_dispatch = "dense"
    try:
        return model.prefill({"tokens": toks}, cache)
    finally:
        model.moe_dispatch = "fused"


def moe_drops(routes, m) -> tuple:
    """``(dropped, assigned)`` (token, pick) assignments of the capacity
    dispatch of each recorded routing (``routing_record``): its tables
    again on the host."""
    from repro_torch.models import moe
    dropped = assigned = 0
    for top_e, _ in routes:
        _, keep = moe._dispatch_tables(
            top_e, None, m.n_experts,
            moe._capacity(top_e.shape[0], m, m.n_experts))
        dropped += int((~keep).sum())
        assigned += keep.numel()
    return dropped, assigned


def moe_teacher_forced(model, prompt, gen, max_len):
    """Each decode step (the served ``fused`` dispatch; at 4 tokens it
    drops nothing) against a no-cache dense prefill of the same prefix,
    the cache filled by a dense prefill, so both sides hold every expert
    of every prompt token.  Returns per position and row the logit gap
    (of the position's max |logit|) and whether any layer routed the
    decode token unlike the prefill's same position; per layer the count
    of such flips; the prefill's k-th / (k+1)-th router logit gap at each
    flip; and the smallest gap seen."""
    import torch

    B, P = prompt.shape
    logits, cache = moe_dense_prefill(model, prompt,
                                      model.init_cache(B, max_len))
    out = {"rel": [], "row_rel": [], "row_flip": [], "flips": None,
           "flip_gaps": [], "gap": math.inf, "finite": True}
    decode_routes = []
    for t in range(gen.shape[1]):
        routes = []
        if t:
            with routing_record() as routes:
                logits, cache = model.decode_step(gen[:, t - 1:t],
                                                  P + t - 1, cache)
            decode_routes += routes
        with routing_record(per_token=True) as full_routes:
            full, _ = moe_dense_prefill(
                model, torch.cat([prompt, gen[:, :t]], dim=1))
        out["finite"] &= bool(torch.isfinite(logits).all()) and \
            bool(torch.isfinite(full).all())
        scale = full.float().abs().max()
        check(float(scale) > 0, f"teacher-forced position {t}: the no-cache "
              "prefill's logits are all zero")
        row = ((logits.float() - full.float()).abs().amax(-1) / scale)
        out["row_rel"].append(row.tolist())
        out["rel"].append(float(row.max()))
        out["gap"] = min([out["gap"]] +
                         [float(g.min()) for _, g in full_routes])
        flipped = [False] * B
        if routes:
            flips = []
            for (a, _), (b, g) in zip(routes, full_routes):
                last = b.reshape(B, P + t, -1)[:, -1]
                rows = (a.sort(-1).values !=
                        last.sort(-1).values).any(-1)
                flips.append(int(rows.sum()))
                for r in rows.nonzero().flatten().tolist():
                    flipped[r] = True
                    out["flip_gaps"].append(float(g.reshape(
                        B, P + t)[r, -1]))
            out["flips"] = flips if out["flips"] is None else \
                [x + y for x, y in zip(out["flips"], flips)]
        out["row_flip"].append(flipped)
    cfg = model.cfg
    n_moe = cfg.n_units * sum(s.moe for s in cfg.pattern_unit)
    dropped, _ = moe_drops(decode_routes, cfg.moe)
    check(dropped == 0 and len(decode_routes) == (gen.shape[1] - 1) * n_moe,
          f"teacher-forced decode: {len(decode_routes)} dispatches, "
          f"{dropped} assignments dropped")
    out["worst"] = max(out["rel"])
    return out


def moe_sensitivity(model, prompt) -> float:
    """How far the dense prefill's logits move (of max |logit|) when the
    embeddings move by one ulp of the compute dtype (times 1 + eps)."""
    import torch
    base, _ = moe_dense_prefill(model, prompt)
    real = model._embed

    def nudged(tokens):
        x = real(tokens)
        return x * (1 + torch.finfo(x.dtype).eps)

    model._embed = nudged
    try:
        moved, _ = moe_dense_prefill(model, prompt)
    finally:
        del model._embed
    return float((moved.float() - base.float()).abs().max()
                 / base.float().abs().max())


def moe_serve_phase():
    """olmoe-1b-7b at full width and depth (16 layers, 64 experts top-8,
    6,919,100,416 parameters, bf16 compute over f32 parameters from a
    seeded generator) served by ``BatchServer``: two waves of 4 requests
    (1024-token prompts, 32 new tokens) with every kernel counter zeroed
    just before and read just after (``flash_attention`` 16 x 2, no other
    kernel); the capacity dispatch's drops in the served prefills; every
    teacher-forced decode step against a no-cache ``dense`` prefill (the
    reference's oracle, no capacity): in bf16 measured, with its routing
    flips and the model's one-ulp sensitivity (random-weight olmoe is
    chaotic at bf16: no bar holds there), then in f32 at full width held
    to ``F32_TF_TOL`` where the routing agrees, with at most
    ``MOE_TF_FLIP_SHARE`` of the decode tokens routed otherwise; prefill
    / decode timings and a profiled prefill; then a 1-layer full-width
    f32 prefill on the card against the CPU, with the same routing."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import build_model, get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import active_param_count
    from repro_torch.models import moe

    cfg = get_config(MOE_ARCH)
    m = cfg.moe
    check(cfg.n_layers == 16 and cfg.compute_dtype == "bfloat16" and
          (m.n_experts, m.top_k, m.d_expert) == (64, 8, 1024) and
          cfg.n_heads == cfg.n_kv_heads == 16, f"{MOE_ARCH} changed: {cfg}")
    t0 = time.perf_counter()
    model = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == MOE_PARAMS, f"{MOE_ARCH} has {n_params} parameters")
    check(model.moe_dispatch == "fused", "serving dispatch is not fused")
    print(f"MoE phase (b): {MOE_ARCH}, {n_params} parameters "
          f"({active_param_count(cfg)} active a token), {cfg.param_dtype} "
          f"params, {cfg.compute_dtype} compute, dispatch "
          f"{model.moe_dispatch}; init {time.perf_counter() - t0:.2f} s")

    max_len = SERVE_PROMPT + SERVE_NEW
    waves, done, server, launches, rng = lm_serve_counted(model, MOE_ARCH)

    # the drops of the served prefills (the same inputs, fresh caches)
    prompts = [torch.from_numpy(np.stack([r.prompt for r in w])).cuda()
               for w in waves]
    with routing_record() as routes:
        for toks in prompts:
            model.prefill({"tokens": toks},
                          model.init_cache(SERVE_BATCH, max_len))
    dropped, assigned = moe_drops(routes, m)
    cap = moe._capacity(SERVE_BATCH * SERVE_PROMPT, m, m.n_experts)
    print(f"  capacity dispatch of the served prefills ({cap} slots an "
          f"expert for {SERVE_BATCH * SERVE_PROMPT} tokens x top-{m.top_k}): "
          f"{dropped} of {assigned} assignments dropped "
          f"({dropped / assigned:.6f}) over {len(routes)} layer "
          f"dispatches; a {SERVE_BATCH}-token "
          f"decode step has {moe._capacity(SERVE_BATCH, m, m.n_experts)} "
          f"slots an expert and drops nothing")

    # teacher-forced decode against the dense oracle in bf16: measured,
    # with the routing flips between the two paths counted
    gen = torch.from_numpy(np.stack([r.out_tokens
                                     for r in done[:SERVE_BATCH]])).cuda()
    fused0, _ = model.prefill({"tokens": prompts[0]})
    dense0, _ = moe_dense_prefill(model, prompts[0])
    drop_rel = float((fused0.float() - dense0.float()).abs().max()
                     / dense0.float().abs().max())
    print(f"  the served (fused) prefill's last-position logits against the "
          f"dense oracle's: max |dlogit| / max |logit| = {drop_rel:.4e} "
          f"(the capacity drops' effect)")
    del fused0, dense0
    tf = moe_teacher_forced(model, prompts[0], gen, max_len)
    sens = moe_sensitivity(model, prompts[0])
    print(f"  bf16 teacher-forced decode (fused; cache from a dense prefill) "
          f"vs no-cache dense prefill, {SERVE_NEW} positions: max |dlogit| "
          f"/ max |logit| = {tf['worst']:.4e} (per position "
          f"{[float(f'{r:.3e}') for r in tf['rel']]}); decode tokens routed "
          f"unlike the prefill's same positions, per layer over all "
          f"positions: {tf['flips']} of {SERVE_BATCH * (SERVE_NEW - 1)}; "
          f"smallest k-th / (k+1)-th logit gap {tf['gap']:.3e}; one bf16 ulp "
          f"on the embeddings moves the dense prefill's logits by "
          f"{sens:.4e} of max |logit|")
    check(tf["finite"], "non-finite bf16 teacher-forced logits")

    prefill_once = lm_serve_timings(model, prompts[0])
    prof = _profile(prefill_once, 1)
    if prof is None:
        print("  MoE prefill profile: device time not measured (no CUDA "
              "events)")
    else:
        wall, device, n_kern, busy, by_name = prof
        print(f"  MoE prefill profile (torch.profiler, one {SERVE_BATCH} x "
              f"{SERVE_PROMPT} prefill): host wall {wall / 1e3:.4f} ms, "
              f"device kernel time {device / 1e3:.4f} ms, {n_kern:.0f} "
              f"kernels, device busy {busy:.4f} of the host wall")
        for name, (t, k) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:10]:
            print(f"    kernel {t / device:7.4f} {t / 1e3:10.4f} ms "
                  f"{k:7.0f}x {name[:90]}")
    del model, server, prompts, gen, prefill_once   # the thunk holds model
    gc_release()

    # the same in f32 at full width (the same parameters: they are drawn
    # in f32 whatever the compute dtype): no routing flips, and the bar
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = build_model(cfg32).init(
        torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.from_numpy(np.stack([r.prompt for r in waves[0]])).cuda()
    gen = torch.from_numpy(np.stack([r.out_tokens
                                     for r in done[:SERVE_BATCH]])).cuda()
    tf32 = moe_teacher_forced(model, prompt, gen, max_len)
    sens32 = moe_sensitivity(model, prompt)
    same = [r for rows, fl in zip(tf32["row_rel"], tf32["row_flip"])
            for r, f in zip(rows, fl) if not f]
    flipped = [(t, b, float(f"{r:.3e}")) for t, (rows, fl) in
               enumerate(zip(tf32["row_rel"], tf32["row_flip"]))
               for b, (r, f) in enumerate(zip(rows, fl)) if f]
    n_dec = SERVE_BATCH * (SERVE_NEW - 1)
    print(f"  f32 teacher-forced decode, the same tokens: decode tokens "
          f"routed as the prefill's same position in every layer: "
          f"{n_dec - len(flipped)} of {n_dec}, their logits within "
          f"{max(same):.4e} of max |logit| (tolerance {F32_TF_TOL}); the "
          f"others (position, row, gap) {flipped} (at most "
          f"{MOE_TF_FLIP_SHARE} of the tokens), flips per layer "
          f"{tf32['flips']}, the prefill's logit gap at each flip "
          f"{[float(f'{g:.3e}') for g in tf32['flip_gaps']]}; smallest "
          f"gap {tf32['gap']:.3e}; one f32 ulp on the embeddings moves the "
          f"logits by {sens32:.4e}")
    check(tf32["finite"], "non-finite f32 teacher-forced logits")
    check(len(flipped) <= MOE_TF_FLIP_SHARE * n_dec,
          f"f32 teacher-forced decode: {len(flipped)} of {n_dec} decode "
          f"tokens routed unlike the dense prefill")
    check(max(same) <= F32_TF_TOL, f"f32 decode logits {max(same)} from "
          "the dense prefill's where the routing agrees")
    del model, prompt, gen
    gc_release()

    # one full-width layer in f32: card (kernel) against CPU (plain form)
    cfg1 = dataclasses.replace(cfg, n_layers=1, compute_dtype="float32")
    small = build_model(cfg1).init(
        torch.Generator(device="cuda").manual_seed(1))
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, size=(2, 300))
                            .astype(np.int32))
    before = flash_attention.launches
    with routing_record() as card_routes:
        on_card, _ = small.prefill({"tokens": toks.cuda()})
    check(flash_attention.launches == before + 1,
          "the f32 card prefill did not run the kernel")
    on_card = on_card.cpu()
    small.to("cpu")
    with routing_record() as cpu_routes:
        on_cpu, _ = small.prefill({"tokens": toks})
    same_routing(card_routes, cpu_routes, "1-layer f32 prefill")
    rel = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
    print(f"  1-layer full-width f32 prefill (2 x 300 tokens), card vs CPU: "
          f"max |dlogit| / max |logit| = {rel:.4e} (tolerance "
          f"{F32_LOGIT_TOL}, TF32 off)")
    check(bool(torch.isfinite(on_card).all()) and rel <= F32_LOGIT_TOL,
          f"f32 card logits {rel} from the CPU's")
    del small
    gc_release()
    return launches


def gc_release():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def moe_train_phase():
    """olmoe-1b-7b at full width cut to 4 of its 16 layers (its f32
    parameters, gradients and AdamW moments, 110.7 GB at full depth, do
    not fit one card) trained through ``launch.train.main`` (``--n-layers
    4``, batch 4 x seq 1024, lr 3e-3, warmup 10, 6 steps, the synthetic
    stream, no checkpoints) twice from fresh processes' state: one digest
    of losses, grad norms, aux terms and every parameter;
    ``flash_attention`` 4 x 2 x 6 and B7b 4 x 6 launches a run; ms a step,
    tokens/s, peak memory; then a 1-layer full-width f32 loss and every
    gradient on the card against the CPU, with the same routing."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from repro_torch import build_model, get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward)
    from repro_torch.launch import train as train_launch

    t20 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    counters = {**kernel_counters(), "flash_attention": flash_attention,
                "flash_attention_backward": flash_attention_backward}
    work = ROOT / "build" / "phase20"
    shutil.rmtree(work, ignore_errors=True)

    def drive(tag):
        argv = ["--arch", MOE_ARCH, "--n-layers", str(MOE_TRAIN_LAYERS),
                "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
                "--seq", str(TRAIN_SEQ), "--ckpt-every", "0",
                "--ckpt-dir", str(work / tag)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        prog, params, opt, hist = train_launch.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        check(prog.microbatches == 1 and prog.model.moe_dispatch == "fused"
              and sum(p.numel() for p in params.values()) ==
              MOE_TRAIN_PARAMS, f"train {tag}: not {MOE_ARCH} at "
              f"{MOE_TRAIN_LAYERS} layers, one microbatch, fused")
        fwd = MOE_TRAIN_LAYERS * 2 * TRAIN_STEPS  # forward + remat recompute
        bwd = MOE_TRAIN_LAYERS * TRAIN_STEPS
        check(launches["flash_attention"] == fwd and
              launches["flash_attention_backward"] == bwd and
              all(n == 0 for k, n in launches.items()
                  if not k.startswith("flash")),
              f"MoE train {tag}: launches {launches}, expected "
              f"flash_attention {fwd}, flash_attention_backward {bwd}")
        keys = ("step", "loss", "ce", "moe_lb", "moe_z", "grad_norm")
        rows = [tuple(h[k] for k in keys) for h in hist]
        check(all(math.isfinite(x) for r in rows for x in r[1:]),
              f"MoE train {tag}: non-finite loss / aux / grad norm {rows}")
        out = (rows, param_digest(params), int(opt["step"]),
               [h["dt"] for h in hist], launches, wall, peak)
        del prog, params, opt, hist
        gc_release()
        return out

    rows_a, digest_a, opt_step, dts_a, launches, wall_a, peak = drive("a")
    print(f"MoE phase (c): {MOE_ARCH} at full width, {MOE_TRAIN_LAYERS} of "
          f"16 layers ({MOE_TRAIN_PARAMS} parameters), {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, {TRAIN_STEPS} steps; run a {wall_a:.2f} s, "
          f"launches {launches}; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)")
    for r in rows_a:
        print(f"  step {r[0]}: loss {r[1]:.6f} ce {r[2]:.6f} moe_lb "
              f"{r[3]:.6f} moe_z {r[4]:.6f} grad_norm {r[5]:.6f}")
    check(opt_step == TRAIN_STEPS, f"MoE train a: AdamW step {opt_step}")
    rows_b, digest_b, _, dts_b, _, wall_b, _ = drive("b")
    print(f"  run b: {wall_b:.2f} s; losses, aux terms, grad norms and "
          f"parameter digest {digest_b} "
          f"{'==' if (rows_b, digest_b) == (rows_a, digest_a) else '!='} "
          f"run a's {digest_a}")
    check(rows_b == rows_a and digest_b == digest_a,
          f"MoE train: two fresh runs differ: {rows_a} vs {rows_b}, "
          f"{digest_a} vs {digest_b}")
    shutil.rmtree(work, ignore_errors=True)
    steady = sorted(dts_a[1:] + dts_b[1:])
    step_ms = steady[len(steady) // 2] * 1e3
    print(f"  MoE train speed: median {step_ms:.4f} ms a step over steps 1-5 "
          f"of runs a and b ({[round(d * 1e3, 3) for d in dts_a]}, "
          f"{[round(d * 1e3, 3) for d in dts_b]} ms), "
          f"{TRAIN_BATCH * TRAIN_SEQ / (step_ms * 1e-3):.3f} tokens/s")

    # one full-width layer in f32: loss and every gradient on the card
    # (kernels) against the CPU (plain forms), TF32 off
    cfg1 = dataclasses.replace(cfg, n_layers=1, compute_dtype="float32")
    small = build_model(cfg1).init(
        torch.Generator(device="cuda").manual_seed(1))
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab, (2, 129)).astype(np.int32))
    for fn in counters.values():
        fn.launches = 0
    with routing_record() as card_routes:
        loss_c, met_c = small.loss_fn({"tokens": toks.cuda()})
    loss_c.backward()
    check(flash_attention.launches == 2 and
          flash_attention_backward.launches == 1,
          f"the f32 card loss launched flash_attention "
          f"{flash_attention.launches} / backward "
          f"{flash_attention_backward.launches} times, not 2 / 1")
    grads_c = {n: p.grad.cpu() for n, p in small.named_parameters()}
    met_c = {k: float(v.detach()) for k, v in met_c.items()}
    loss_c = float(loss_c.detach())
    small.zero_grad(set_to_none=True)
    small.to("cpu")
    t_cpu = time.perf_counter()
    with routing_record() as cpu_routes:
        loss_h, met_h = small.loss_fn({"tokens": toks})
    loss_h.backward()
    t_cpu = time.perf_counter() - t_cpu
    same_routing(card_routes, cpu_routes, "1-layer f32 loss")
    worst, worst_name = 0.0, ""
    for n, p in small.named_parameters():
        scale = float(p.grad.abs().max())
        e = float((grads_c[n] - p.grad).abs().max()) / max(scale, 1e-30)
        check(math.isfinite(e) and scale > 0, f"f32 grad {n}: {e}, {scale}")
        if e > worst:
            worst, worst_name = e, n
    rels = {k: abs(met_c[k] - float(met_h[k].detach()))
            / abs(float(met_h[k].detach())) for k in met_c}
    lrel = abs(loss_c - float(loss_h.detach())) / abs(float(loss_h.detach()))
    print(f"  1-layer full-width f32 loss and gradients (2 x 128 tokens; "
          f"the CPU's loss and backward {t_cpu:.2f} s), card vs CPU: loss "
          f"{loss_c:.7f} vs {float(loss_h.detach()):.7f} (rel {lrel:.3e}; "
          f"ce / "
          f"moe_lb / moe_z rel {', '.join(f'{v:.3e}' for v in rels.values())}"
          f"), worst leaf {worst_name} {worst:.3e} of its max |grad| "
          f"(tolerance {GRAD_TOL}, TF32 off)")
    check(lrel <= GRAD_TOL and max(rels.values()) <= GRAD_TOL and
          worst <= GRAD_TOL, f"f32 card gradients {worst} ({worst_name}) / "
          f"loss {lrel} / aux {rels} from the CPU's")
    del small, grads_c
    gc_release()
    print(f"MoE phase (c): {time.perf_counter() - t20:.1f} s")
    return {"flash_attention": launches["flash_attention"],
            "flash_attention_backward": launches["flash_attention_backward"],
            "step_ms": step_ms}


def moe_phase():
    """Phase 20: (a) B7 / B7b at olmoe's G = 1 shape, (b) olmoe-1b-7b
    served at full width and depth, (c) trained at full width, 4 layers.
    Returns the kernels' olmoe entries for the kernels line."""
    t0 = time.perf_counter()
    kern = moe_flash_phase()
    served = moe_serve_phase()
    trained = moe_train_phase()
    print(f"phase 20: {time.perf_counter() - t0:.1f} s")
    return {name: {"olmoe_ms": acc["ms"], "olmoe_library_ms":
                   acc["library_ms"], "olmoe_bound_ms": acc["bound_ms"],
                   "olmoe_serve_launches": served[name],
                   "olmoe_train_launches": trained[name]}
            for name, acc in kern.items()}


# ---- phase 21: state-space models, rwkv6-3b and jamba-v0.1-52b served --------

RWKV_ARCH, RWKV_PARAMS = "rwkv6-3b", 3_073_313_280          # full size
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_LAYERS, JAMBA_UNIT_PARAMS = 8, 13_295_235_072   # one of its 4 units
SSM_TF_STEPS = 8           # teacher-forced decode steps checked a model
SSM_LAYER_TOL = 1e-4       # a full-width Mamba layer, card vs CPU, of max


def ssm_flash_phase():
    """B7 at jamba's attention shape (32 q heads over 8 kv heads, so G =
    4; BH = 4 x 8, L = S = 1024, hd 128, causal, bf16) against its plain
    form (phase 13's bar), timed beside its plain form, SDPA and the
    bound."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    BH, L, S, G, hd = 32, 1024, 1024, 4, 128
    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for shape in ((BH, L, G, hd), (BH, S, hd), (BH, S, hd)))
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    err = float((got.double() - want.double()).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= FLASH_TOL["bfloat16"],
          f"B7 at jamba's shape: {err} from its plain form")
    nbytes, ops = flash_work(BH, L, S, G, hd, True, 2)
    bound = max(nbytes / HBM_BPS, ops / BF16_FLOPS) * 1e3
    t_k = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), n=50,
                  warmup=5)
    t_p = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True),
                  n=3, warmup=1)
    # SDPA over the kv heads repeated G times (its GQA layout)
    qt = q.transpose(1, 2).contiguous()                     # (BH, G, L, hd)
    kt = k[:, None].expand(BH, G, S, hd).contiguous()
    vt = v[:, None].expand(BH, G, S, hd).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_l = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), n=50, warmup=5)
    print(f"SSM phase (b): B7 at jamba's prefill shape (BH {BH}, L = S = "
          f"{L}, G {G}, hd {hd}, causal, bf16, {ops / 1e9:.2f} GFLOP): vs "
          f"plain {err:.3e} (tolerance {FLASH_TOL['bfloat16']}); kernel "
          f"{t_k:.6f} ms, plain {t_p:.6f} ms, SDPA {t_l:.6f} ms, bound "
          f"{bound:.6f} ms ({bound / t_k:.4f} of it; "
          f"{ops / (t_k * 1e-3) / 1e12:.2f} TFLOP/s)")
    return {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": bound,
            "max_abs_err": err}


def ssm_profiles(model, prompt, label):
    """Steady prefill / decode timings through the entry points, then a
    profiled prefill and a profiled decode step: device ms by kernel,
    kernels a call, busy share of the host wall."""
    import torch

    prefill_once = lm_serve_timings(model, prompt)
    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_NEW)
    lg, cache = model.prefill({"tokens": prompt}, cache)
    tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]

    def decode_once():
        model.decode_step(tok, SERVE_PROMPT, cache)

    for what, fn in (("prefill", prefill_once),
                     ("decode step", decode_once)):
        prof = _profile(fn, 1)
        if prof is None:
            print(f"  {label} {what} profile: device time not measured (no "
                  f"CUDA events)")
            continue
        wall, device, n_kern, busy, by_name = prof
        print(f"  {label} {what} profile (torch.profiler, one call, "
              f"{SERVE_BATCH} rows): host wall {wall / 1e3:.4f} ms, device "
              f"kernel time {device / 1e3:.4f} ms, {n_kern:.0f} kernels, "
              f"device busy {busy:.4f} of the host wall")
        for name, (t, k) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:8]:
            print(f"    kernel {t / device:7.4f} {t / 1e3:10.4f} ms "
                  f"{k:7.0f}x {name[:90]}")
    del cache, lg, tok


def ssm_card_vs_cpu(cfg, label, n_prefill=256, n_decode=4):
    """``cfg`` at full width in f32: a prefill of 2 x ``n_prefill`` tokens
    into a cache and ``n_decode`` decode steps, on the card and on the CPU
    with the same weights; every call's logits within ``F32_LOGIT_TOL``
    of max |logit|."""
    import numpy as np
    import torch
    from repro_torch import build_model

    small = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(1))
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab, (2, n_prefill + n_decode)).astype(np.int32))

    def run(model):
        dev = model.device
        out = []
        lg, cache = model.prefill({"tokens": toks[:, :n_prefill].to(dev)},
                                  model.init_cache(2, n_prefill + n_decode))
        out.append(lg.cpu())
        for t in range(n_prefill, n_prefill + n_decode):
            lg, cache = model.decode_step(toks[:, t:t + 1].to(dev), t, cache)
            out.append(lg.cpu())
        return out

    on_card = run(small)
    small.to("cpu")
    t_cpu = time.perf_counter()
    on_cpu = run(small)
    t_cpu = time.perf_counter() - t_cpu
    rels = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(on_card, on_cpu)]
    print(f"  {label}: a 2 x {n_prefill} prefill and {n_decode} decode "
          f"steps, f32 at full width, card vs CPU (the CPU's {t_cpu:.2f} s): "
          f"max |dlogit| / max |logit| per call "
          f"{[float(f'{r:.3e}') for r in rels]} (tolerance {F32_LOGIT_TOL}, "
          f"TF32 off)")
    check(all(bool(torch.isfinite(a).all()) for a in on_card) and
          max(rels) <= F32_LOGIT_TOL, f"{label}: card logits {rels} from "
          "the CPU's")
    del small
    gc_release()


def rwkv_serve_phase():
    """rwkv6-3b at full width and depth (32 layers, 3,073,313,280
    parameters, f32 parameters from a seeded generator, bf16 compute)
    served by ``BatchServer``: two waves of 4 x (1024 + 32) tokens with
    every kernel counter zeroed just before and read just after (no
    kernel: ``flash_attention`` 0); timings and profiles; the first
    ``SSM_TF_STEPS`` teacher-forced decode steps against a no-cache
    prefill, in bf16 (held at ``TF_LOGIT_TOL`` unless one bf16 ulp on the
    embeddings already moves the logits further) and in f32 at full width
    (``F32_TF_TOL``); a 1-layer f32 prefill and 4 decode steps on the card
    against the CPU."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import build_model, get_config

    cfg = get_config(RWKV_ARCH)
    check(cfg.n_layers == 32 and cfg.d_model == 2560 and
          cfg.compute_dtype == "bfloat16" and
          cfg.pattern_unit[0].kind == "rwkv", f"{RWKV_ARCH} changed: {cfg}")
    t0 = time.perf_counter()
    model = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == RWKV_PARAMS, f"{RWKV_ARCH} has {n_params} parameters")
    print(f"SSM phase (a): {RWKV_ARCH}, {n_params} parameters, "
          f"{cfg.param_dtype} params, {cfg.compute_dtype} compute; init "
          f"{time.perf_counter() - t0:.2f} s")
    waves, done, server, launches, _ = lm_serve_counted(model, RWKV_ARCH)
    prompt = torch.from_numpy(np.stack([r.prompt for r in waves[0]])).cuda()
    gen = torch.from_numpy(np.stack([r.out_tokens for r in
                                     done[:SERVE_BATCH]]))[:, :SSM_TF_STEPS + 1]
    max_len = SERVE_PROMPT + SERVE_NEW
    ssm_profiles(model, prompt, RWKV_ARCH)

    tf = moe_teacher_forced(model, prompt, gen.cuda(), max_len)
    sens = moe_sensitivity(model, prompt)
    held = sens <= TF_LOGIT_TOL
    print(f"  bf16 teacher-forced decode vs no-cache prefill, the first "
          f"{SSM_TF_STEPS} decode steps: max |dlogit| / max |logit| = "
          f"{tf['worst']:.4e} (per position "
          f"{[float(f'{r:.3e}') for r in tf['rel']]}); one bf16 ulp on the "
          f"embeddings moves the prefill's logits by {sens:.4e} of max "
          f"|logit|: {'held at ' + str(TF_LOGIT_TOL) if held else 'not held (the one-ulp move exceeds ' + str(TF_LOGIT_TOL) + ')'}")
    check(tf["finite"], "non-finite bf16 teacher-forced logits")
    if held:
        check(tf["worst"] <= TF_LOGIT_TOL, f"{RWKV_ARCH} bf16 decode logits "
              f"{tf['worst']} from the prefill's")
    del model, server, prompt
    gc_release()

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = build_model(cfg32).init(
        torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.from_numpy(np.stack([r.prompt for r in waves[0]])).cuda()
    tf32 = moe_teacher_forced(model, prompt, gen.cuda(), max_len)
    print(f"  f32 teacher-forced decode at full width, the same tokens: max "
          f"|dlogit| / max |logit| = {tf32['worst']:.4e} (per position "
          f"{[float(f'{r:.3e}') for r in tf32['rel']]}; tolerance "
          f"{F32_TF_TOL})")
    check(tf32["finite"] and tf32["worst"] <= F32_TF_TOL,
          f"{RWKV_ARCH} f32 decode logits {tf32['worst']} from the prefill's")
    del model, prompt
    gc_release()
    ssm_card_vs_cpu(dataclasses.replace(cfg, n_layers=1,
                                        compute_dtype="float32"),
                    f"1-layer {RWKV_ARCH}")
    return launches


def _rescale_unit_weights(model, std) -> None:
    """Scale every unit leaf that ``init`` drew by the reference's rule
    (``normal``, no declared scale: ``1 / sqrt(n_units)``, the stacked
    leaf's first dim its fan-in) to the standard deviation ``std(shape)``
    of its unstacked shape."""
    import torch
    from repro_torch.models.layers import _flatten
    from repro_torch.models.transformer import _leaf

    cfg = model.cfg
    P = len(cfg.pattern_unit)
    with torch.no_grad():
        for path, d in _flatten(model.defs["units"]).items():
            if d.init == "normal" and d.scale is None:
                f = std(d.shape[1:]) * math.sqrt(cfg.n_units)
                i = int(path[0][len("layer"):])
                for u in range(cfg.n_units):
                    _leaf(model.layers[u * P + i], path[1:]).mul_(f)
    model.drop_cast()


def draw_at_full_depth(model, full_units: int) -> None:
    """The unit weights at the full model's ``1 / sqrt(full_units)``: a
    model cut to one unit would draw them at 1.0, and jamba's residual
    stream then outgrows float32 in the norms' sum of squares (every
    logit 0, every router logit tied; PR 28, call 1)."""
    _rescale_unit_weights(model, lambda shape: full_units ** -0.5)


def draw_at_fan_in(model) -> None:
    """The unit weights at ``1 / sqrt(fan_in)``, the fan-in the input dim
    of the leaf's product (``shape[-2]``): activations stay of order one
    through the depth, as a trained model's do."""
    _rescale_unit_weights(
        model, lambda shape: (shape[-2] if len(shape) > 1 else shape[-1])
        ** -0.5)


def mamba_layer_card_vs_cpu(cfg):
    """One Mamba layer of ``cfg`` at full width in f32 (seeded weights by
    the reference's rule): a 4 x 1024 prefill from a seeded state, then 4
    decode steps from the state it leaves, on the card and on the CPU;
    every output and the final states within ``SSM_LAYER_TOL`` of max."""
    import torch
    from repro_torch.models import layers, mamba

    gen = torch.Generator().manual_seed(7)
    p = {k: layers._init_one(gen, d, torch.float32)
         for k, d in mamba.mamba_defs(cfg).items()}
    B, L, di, ds = SERVE_BATCH, SERVE_PROMPT, cfg.d_inner_mamba, \
        cfg.mamba_d_state
    x = torch.randn(B, L + 4, cfg.d_model, generator=gen)
    state0 = {"conv": torch.randn(B, cfg.mamba_d_conv - 1, di,
                                  generator=gen),
              "ssm": torch.randn(B, di, ds, generator=gen)}

    def run(dev):
        pd = {k: v.to(dev) for k, v in p.items()}
        st = {k: v.to(dev) for k, v in state0.items()}
        outs = []
        out, st = mamba.mamba_fwd(pd, x[:, :L].to(dev), cfg, state=st)
        outs.append(out.cpu())
        for t in range(L, L + 4):
            out, st = mamba.mamba_fwd(pd, x[:, t:t + 1].to(dev), cfg,
                                      state=st)
            outs.append(out.cpu())
        return outs, {k: v.cpu() for k, v in st.items()}

    t1 = time.perf_counter()
    card, card_st = run("cuda")
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t1
    t1 = time.perf_counter()
    cpu, cpu_st = run("cpu")
    t_cpu = time.perf_counter() - t1
    rels = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(card + list(card_st.values()),
                            cpu + list(cpu_st.values()))]
    print(f"  one Mamba layer at full width (d_inner {di}, d_state {ds}, "
          f"dt_rank {mamba.dt_rank(cfg)}), f32: a {B} x {L} prefill from a "
          f"seeded state and 4 decode steps, card ({t_card:.2f} s) vs CPU "
          f"({t_cpu:.2f} s): max |d| / max per output and final state "
          f"{[float(f'{r:.3e}') for r in rels]} (tolerance {SSM_LAYER_TOL}, "
          f"TF32 off)")
    check(all(bool(torch.isfinite(a).all()) for a in card) and
          max(rels) <= SSM_LAYER_TOL, f"Mamba layer card vs CPU: {rels}")


def jamba_teacher_forced(cfg32, prompt, gen, label, draw, hold):
    """The first ``SSM_TF_STEPS`` f32 teacher-forced decode steps of a
    model of ``cfg32`` (seed 0, then ``draw``) against a no-cache dense
    prefill, with the f32 one-ulp sensitivity of its logits; PR 27's rule
    (``F32_TF_TOL`` where the routing agrees, at most
    ``MOE_TF_FLIP_SHARE`` of the tokens routed otherwise) held when
    ``hold`` is True, or, with ``hold`` None, when one f32 ulp on the
    embeddings moves the logits by less than the bar (a model that
    chaotic cannot tell two summation orders apart).  Returns whether the
    rule was held."""
    import torch
    from repro_torch import build_model

    max_len = SERVE_PROMPT + SERVE_NEW
    model = build_model(cfg32).init(
        torch.Generator(device="cuda").manual_seed(0))
    draw(model)
    tf = moe_teacher_forced(model, prompt.cuda(), gen.cuda(), max_len)
    sens = moe_sensitivity(model, prompt.cuda())
    same = [r for rows, fl in zip(tf["row_rel"], tf["row_flip"])
            for r, f in zip(rows, fl) if not f]
    flipped = [(t, b, float(f"{r:.3e}")) for t, (rows, fl) in
               enumerate(zip(tf["row_rel"], tf["row_flip"]))
               for b, (r, f) in enumerate(zip(rows, fl)) if f]
    n_dec = SERVE_BATCH * SSM_TF_STEPS
    if hold is None:
        hold = sens <= F32_TF_TOL
    print(f"  f32 teacher-forced decode, {label} (fused; cache from a dense "
          f"prefill) vs no-cache dense prefill, the first {SSM_TF_STEPS} "
          f"decode steps: decode tokens routed as the prefill's same "
          f"position in every MoE layer: {n_dec - len(flipped)} of {n_dec}, "
          f"their logits within {max(same, default=0.0):.4e} of max |logit| "
          f"(per position {[float(f'{r:.3e}') for r in tf['rel']]}); the "
          f"others (position, row, gap) {flipped}; flips per MoE layer "
          f"{tf['flips']}; smallest k-th / (k+1)-th router logit gap "
          f"{tf['gap']:.3e}; one f32 ulp on the embeddings moves the dense "
          f"prefill's logits by {sens:.4e} of max |logit|; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB: "
          + (f"held ({F32_TF_TOL} where the routing agrees, at most "
             f"{MOE_TF_FLIP_SHARE} of the tokens routed otherwise)" if hold
             else f"not held (the one-ulp move exceeds {F32_TF_TOL})"))
    check(tf["finite"], f"non-finite f32 teacher-forced logits ({label})")
    if hold:
        check(len(flipped) <= MOE_TF_FLIP_SHARE * n_dec,
              f"f32 teacher-forced decode ({label}): {len(flipped)} of "
              f"{n_dec} decode tokens routed unlike the dense prefill")
        check(max(same) <= F32_TF_TOL, f"{JAMBA_ARCH} f32 decode logits "
              f"({label}) {max(same)} from the dense prefill's where the "
              "routing agrees")
    del model
    gc_release()
    return hold


def jamba_serve_phase():
    """jamba-v0.1-52b at full width cut to one of its four 8-layer units
    (7 Mamba layers and 1 attention layer; 4 MoE layers of 16 experts,
    top-2; 13,295,235,072 parameters) with bf16 parameters: its f32
    parameters and their bf16 casts (79.8 GB) do not fit the card.  The
    unit's weights are drawn at the full model's scale
    (``draw_at_full_depth``).
    ``BatchServer`` serves two waves of 4 x (1024 + 32) tokens with every
    kernel counter zeroed just before and read just after
    (``flash_attention`` 2: one attention layer a wave); the capacity
    dispatch's drops in the served prefills; timings and profiles.  Then,
    the bf16 model freed, the same unit in f32 (53.2 GB): the first
    ``SSM_TF_STEPS`` teacher-forced decode steps against a no-cache dense
    prefill (``jamba_teacher_forced``: PR 27's rule, held where one f32
    ulp moves the logits less than its bar; else measured and held again
    on the unit drawn at each leaf's fan-in scale), and one full-width
    Mamba layer on the card against the CPU."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import build_model, get_config
    from repro_torch.launch.steps import active_param_count
    from repro_torch.models import moe

    full = get_config(JAMBA_ARCH)
    m = full.moe
    check(full.n_layers == 32 and len(full.pattern_unit) == JAMBA_LAYERS and
          full.d_model == 4096 and (m.n_experts, m.top_k) == (16, 2) and
          (full.n_heads, full.n_kv_heads) == (32, 8),
          f"{JAMBA_ARCH} changed: {full}")
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS,
                              param_dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    draw_at_full_depth(model, full.n_units)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == JAMBA_UNIT_PARAMS,
          f"{JAMBA_ARCH} at {JAMBA_LAYERS} layers has {n_params} parameters")
    print(f"SSM phase (b): {JAMBA_ARCH} at full width, {JAMBA_LAYERS} of "
          f"{full.n_layers} layers ({n_params} parameters, "
          f"{active_param_count(cfg)} active a token), {cfg.param_dtype} "
          f"params, {cfg.compute_dtype} compute, dispatch "
          f"{model.moe_dispatch}; init {time.perf_counter() - t0:.2f} s")
    waves, done, server, launches, _ = lm_serve_counted(model, JAMBA_ARCH)
    max_len = SERVE_PROMPT + SERVE_NEW
    prompts = [torch.from_numpy(np.stack([r.prompt for r in w])).cuda()
               for w in waves]
    with routing_record() as routes:
        for toks in prompts:
            model.prefill({"tokens": toks},
                          model.init_cache(SERVE_BATCH, max_len))
    dropped, assigned = moe_drops(routes, m)
    cap = moe._capacity(SERVE_BATCH * SERVE_PROMPT, m, m.n_experts)
    check(cap == 644, f"capacity {cap} for {SERVE_BATCH * SERVE_PROMPT} "
          "tokens, not 644")
    print(f"  capacity dispatch of the served prefills ({cap} slots an "
          f"expert for {SERVE_BATCH * SERVE_PROMPT} tokens x top-{m.top_k}): "
          f"{dropped} of {assigned} assignments dropped "
          f"({dropped / assigned:.6f}) over {len(routes)} layer dispatches")
    ssm_profiles(model, prompts[0], JAMBA_ARCH)
    gen = torch.from_numpy(np.stack([r.out_tokens for r in
                                     done[:SERVE_BATCH]]))[:, :SSM_TF_STEPS + 1]
    prompt = prompts[0].cpu()
    del model, server, prompts
    gc_release()

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    held = jamba_teacher_forced(cfg32, prompt, gen, "the served draw",
                                lambda m: draw_at_full_depth(m, full.n_units),
                                hold=None)
    if not held:
        jamba_teacher_forced(cfg32, prompt, gen, "drawn at each leaf's "
                             "fan-in scale", draw_at_fan_in, hold=True)
    mamba_layer_card_vs_cpu(full)
    return launches


def ssm_phase():
    """Phase 21: (a) rwkv6-3b served at full width and depth, (b) B7 at
    jamba's G = 4 shape and jamba-v0.1-52b served at full width, one
    unit.  Returns the flash_attention entries for the kernels line."""
    t0 = time.perf_counter()
    print(f"phase 21 on {card_line()}")
    rwkv = rwkv_serve_phase()
    print(f"SSM phase (a): {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    b7 = ssm_flash_phase()
    jamba = jamba_serve_phase()
    print(f"SSM phase (b): {time.perf_counter() - t1:.1f} s")
    print(f"phase 21: {time.perf_counter() - t0:.1f} s on {card_line()}")
    return {"flash_attention": {
        "jamba_ms": b7["ms"], "jamba_plain_ms": b7["plain_ms"],
        "jamba_library_ms": b7["library_ms"],
        "jamba_bound_ms": b7["bound_ms"],
        "jamba_max_abs_err": b7["max_abs_err"],
        "jamba_serve_launches": jamba["flash_attention"],
        "rwkv_serve_launches": rwkv["flash_attention"]}}


# ---- phase 22: the state-space models trained: rwkv6-3b, the jamba share ---

JAMBA_SHARE = (0, 8)        # one card of 8-way expert parallelism
JAMBA_SHARE_PARAMS = 3_430_232_064   # one unit, 2 of 16 experts a MoE layer
SSM_GRAD_TOKENS = 300       # crosses a WKV block; Mamba chunks of 100
RWKV_PROFILE_LAYERS = 2     # the profiled rwkv6-3b step's depth
GEMM_KERNEL = re.compile(r"gemm|cutlass|xmma|nvjet|cublas|gemv|sm90_|splitK",
                         re.I)


def ssm_grads_card_vs_cpu(cfg_rwkv, cfg_jamba):
    """(a) In f32 with TF32 off, on 2 x ``SSM_GRAD_TOKENS`` tokens: one
    rwkv6-3b layer at full width (the 1-layer LM: its loss and every
    gradient) and one Mamba layer at jamba's width (every parameter's
    gradient and the input's, of a seeded projection of its output), each
    on the card against the CPU with the same weights: within
    ``GRAD_TOL`` of each leaf's max |grad|."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import build_model
    from repro_torch.models import layers, mamba, rwkv

    check(SSM_GRAD_TOKENS > rwkv.WKV_BLOCK, "the WKV check crosses no block")
    cfg1 = dataclasses.replace(cfg_rwkv, n_layers=1, compute_dtype="float32")
    small = build_model(cfg1).init(
        torch.Generator(device="cuda").manual_seed(1))
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg1.vocab, (2, SSM_GRAD_TOKENS + 1)).astype(np.int32))
    loss_c, _ = small.loss_fn({"tokens": toks.cuda()})
    loss_c.backward()
    grads_c = {n: p.grad.cpu() for n, p in small.named_parameters()}
    loss_c = float(loss_c.detach())
    small.zero_grad(set_to_none=True)
    small.to("cpu")
    t_cpu = time.perf_counter()
    loss_h, _ = small.loss_fn({"tokens": toks})
    loss_h.backward()
    loss_h = float(loss_h.detach())
    t_cpu = time.perf_counter() - t_cpu
    worst, worst_name = 0.0, ""
    for n, p in small.named_parameters():
        scale = float(p.grad.abs().max())
        e = float((grads_c[n] - p.grad).abs().max()) / max(scale, 1e-30)
        check(math.isfinite(e) and scale > 0, f"rwkv f32 grad {n}: {e}, "
              f"{scale}")
        if e > worst:
            worst, worst_name = e, n
    lrel = abs(loss_c - loss_h) / abs(loss_h)
    print(f"SSM train phase (a): one {RWKV_ARCH} layer at full width, f32, "
          f"2 x {SSM_GRAD_TOKENS} tokens (WKV block {rwkv.WKV_BLOCK}), card "
          f"vs CPU (the CPU's loss and backward {t_cpu:.2f} s): loss "
          f"{loss_c:.7f} vs {loss_h:.7f} (rel {lrel:.3e}), worst leaf "
          f"{worst_name} {worst:.3e} of its max |grad| (tolerance "
          f"{GRAD_TOL}, TF32 off)")
    check(lrel <= GRAD_TOL and worst <= GRAD_TOL, f"rwkv f32 card gradients "
          f"{worst} ({worst_name}) / loss {lrel} from the CPU's")
    del small, grads_c

    gen = torch.Generator().manual_seed(7)
    p = {k: layers._init_one(gen, d, torch.float32)
         for k, d in mamba.mamba_defs(cfg_jamba).items()}
    x = torch.randn(2, SSM_GRAD_TOKENS, cfg_jamba.d_model, generator=gen)
    g = torch.randn(x.shape, generator=gen)

    def run(dev):
        pd = {k: v.to(dev).requires_grad_() for k, v in p.items()}
        xd = x.to(dev).requires_grad_()
        out, _ = mamba.mamba_fwd(pd, xd, cfg_jamba)
        names = list(pd)
        grads = torch.autograd.grad(out, [pd[k] for k in names] + [xd],
                                    g.to(dev))
        return out.detach().cpu(), {n: t.cpu() for n, t in
                                    zip(names + ["x"], grads)}

    out_c, grads_c = run("cuda")
    t_cpu = time.perf_counter()
    out_h, grads_h = run("cpu")
    t_cpu = time.perf_counter() - t_cpu
    rels = {n: float((grads_c[n] - t).abs().max() / t.abs().max())
            for n, t in grads_h.items()}
    rels["out"] = float((out_c - out_h).abs().max() / out_h.abs().max())
    worst_name = max(rels, key=rels.get)
    print(f"  one Mamba layer at {JAMBA_ARCH}'s width (d_inner "
          f"{cfg_jamba.d_inner_mamba}), f32, 2 x {SSM_GRAD_TOKENS} tokens "
          f"(chunks of {SSM_GRAD_TOKENS // 3}), card vs CPU (the CPU's "
          f"{t_cpu:.2f} s): max |d| / max per gradient "
          f"{ {n: float(f'{r:.3e}') for n, r in rels.items()} } (tolerance "
          f"{GRAD_TOL}, TF32 off)")
    check(all(math.isfinite(r) for r in rels.values()) and
          rels[worst_name] <= GRAD_TOL, f"Mamba f32 card gradients: {rels}")
    gc_release()


def ssm_train_counters():
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward)
    return {**kernel_counters(), "flash_attention": flash_attention,
            "flash_attention_backward": flash_attention_backward}


def wkv_profile(prog, params, opt, batch):
    """One profiled training step of an RWKV program: host wall, device
    kernel time and busy share, the device time under the WKV Function's
    forward, its checkpoint recompute and its backward (record_function
    ranges set from outside the model), and the kernels split into the
    recurrence's ``addcmul`` launches, GEMMs and the rest.  Returns None
    when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import rwkv

    blocks, backward = rwkv._wkv_blocks, rwkv.WKVFunction.backward
    model, in_loss = prog.model, []

    def loss_fn(batch):
        in_loss.append(True)
        try:
            return type(model).loss_fn(model, batch)
        finally:
            in_loss.pop()

    def labelled_blocks(*args, **kw):
        with record_function("wkv forward" if in_loss else "wkv recompute"):
            return blocks(*args, **kw)

    def labelled_backward(ctx, *grads):
        with record_function("wkv backward"):
            return backward(ctx, *grads)

    model.loss_fn = loss_fn
    rwkv._wkv_blocks = labelled_blocks
    rwkv.WKVFunction.backward = staticmethod(labelled_backward)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prog.step_fn(params, opt, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        del model.loss_fn
        rwkv._wkv_blocks = blocks
        rwkv.WKVFunction.backward = staticmethod(backward)
    t1 = time.perf_counter()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    # the ranges' own device-side spans (user annotations) are no kernels
    ann = [e for e in dev if getattr(e, "is_user_annotation", False)
           or e.name.startswith("wkv ")]
    kern = [e for e in dev if not (getattr(e, "is_user_annotation", False)
                                   or e.name.startswith("wkv "))]
    if not kern:
        return None
    cats = {"addcmul (the recurrences)": [0.0, 0], "GEMM": [0.0, 0],
            "other (elementwise, reductions, copies)": [0.0, 0]}
    spans, by_name = [], {}
    for e in kern:
        t = e.time_range.elapsed_us()
        tn, kn = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tn + t, kn + 1)
        key = "addcmul (the recurrences)" if "addcmul" in e.name else \
            "GEMM" if GEMM_KERNEL.search(e.name) else \
            "other (elementwise, reductions, copies)"
        cats[key][0] += t
        cats[key][1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    # per range: its calls, their device span (first to last kernel,
    # gaps included) and the kernel time that starts inside it
    ranges = {}
    for label in ("wkv forward", "wkv recompute", "wkv backward"):
        iv = sorted((e.time_range.start, e.time_range.end) for e in ann
                    if e.name == label)
        inside = sum(t_e - t_s for t_s, t_e in spans
                     if any(a <= t_s < b for a, b in iv))
        ranges[label] = (len(iv), sum(b - a for a, b in iv) / 1e3,
                         inside / 1e3)
    device = sum(t for t, _ in cats.values()) / 1e3
    return {"wall_ms": wall, "device_ms": device, "kernels": len(kern),
            "busy": busy / 1e3 / wall,
            "cats": {k: (t / 1e3, n) for k, (t, n) in cats.items()},
            "ranges": ranges, "by_name": by_name,
            "post_s": time.perf_counter() - t1}


def rwkv_profile(n_layers):
    """rwkv6-3b at full width cut to ``n_layers`` (each layer is one unit,
    so a full-depth step is ``32 / n_layers`` times its layers' work plus
    the embedding, head and update), one training step on phase 19's batch
    shape: after two warm steps, a step's host wall and device span (CUDA
    events) unprofiled, then one step under torch.profiler split by
    ``wkv_profile``, its top kernels by device time.  The profiler's
    post-processing of a full-depth step (165,185 kernels) took 226 s
    (PR 29, call 1), so the profiled step runs at this cut."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import get_config
    from repro_torch.configs import SHAPES
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_config(RWKV_ARCH), n_layers=n_layers)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH)
    prog = make_train_step(cfg, shape, ocfg=adamw.AdamWConfig(
        lr=3e-3, warmup_steps=10, total_steps=TRAIN_STEPS), microbatches=1)
    prog.model.init(torch.Generator(device="cuda").manual_seed(0))
    params, opt = prog.params, adamw.init_state(prog.params)
    batch = {"tokens": torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int32)).cuda()}
    for _ in range(2):
        prog.step_fn(params, opt, batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    prog.step_fn(params, opt, batch)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    span = start.elapsed_time(end)
    prof = wkv_profile(prog, params, opt, batch)
    print(f"  rwkv train profile: {RWKV_ARCH} at full width cut to "
          f"{n_layers} layers, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, after two "
          f"warm steps: unprofiled step host wall {wall:.4f} ms, device "
          f"span {span:.4f} ms (CUDA events)")
    if prof is None:
        print("  rwkv train profile: device time not measured (no CUDA "
              "events)")
    else:
        print(f"  rwkv train profile (torch.profiler, the next step; its "
              f"post-processing {prof['post_s']:.1f} s): host wall "
              f"{prof['wall_ms']:.4f} ms, device kernel time "
              f"{prof['device_ms']:.4f} ms, {prof['kernels']} kernels, "
              f"device busy {prof['busy']:.4f} of the host wall")
        for name, (t, n) in prof["cats"].items():
            print(f"    {name}: {t:.4f} ms device, {n} kernels, "
                  f"{t / prof['device_ms']:.4f} of device time")
        for name, (n, span, inside) in prof["ranges"].items():
            print(f"    {name} (record_function, {n} device ranges): "
                  f"device span {span:.4f} ms, kernels in it {inside:.4f} ms")
        for name, (t, k) in sorted(prof["by_name"].items(),
                                   key=lambda kv: -kv[1][0])[:12]:
            print(f"    kernel {t / 1e3 / prof['device_ms']:7.4f} "
                  f"{t / 1e3:10.4f} ms {k:7d}x {name[:100]}")
    del prog, params, opt, batch
    gc_release()


def rwkv_train_phase():
    """(b) rwkv6-3b at full width and depth (32 layers, 3,073,313,280
    parameters) trained through ``launch.train.main`` on phase 19's
    schedule (4 x 1024 tokens, lr 3e-3, warmup 10, ``TRAIN_STEPS`` steps,
    the synthetic stream, ``--ckpt-every 0``) twice, every kernel counter
    zeroed just before and read just after (none may launch: the model
    has no attention): the losses, grad norms and parameter digest equal
    bitwise between the runs and finite; ms a step, tokens/s, peak
    memory; a profiled step (``rwkv_profile``)."""
    import shutil

    import torch
    from repro_torch.launch import train as train_launch

    counters = ssm_train_counters()
    work = ROOT / "build" / "phase22"
    shutil.rmtree(work, ignore_errors=True)

    def drive(tag):
        argv = ["--arch", RWKV_ARCH, "--steps", str(TRAIN_STEPS),
                "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--ckpt-every", "0", "--ckpt-dir", str(work / tag)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = train_launch.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        prog, params, opt, hist = res
        check(prog.microbatches == 1 and sum(
            p.numel() for p in params.values()) == RWKV_PARAMS,
            f"rwkv train {tag}: not {RWKV_ARCH} at one microbatch")
        check(all(n == 0 for n in launches.values()),
              f"rwkv train {tag}: a kernel ran: {launches}")
        rows = [(h["step"], h["loss"], h["grad_norm"]) for h in hist]
        check(all(math.isfinite(x) for r in rows for x in r[1:]),
              f"rwkv train {tag}: non-finite loss / grad norm {rows}")
        check(int(opt["step"]) == TRAIN_STEPS, f"rwkv train {tag}: AdamW "
              f"step {int(opt['step'])}")
        out = (rows, param_digest(params), [h["dt"] for h in hist],
               launches, wall, torch.cuda.max_memory_allocated())
        del res, prog, params, opt, hist
        gc_release()
        return out

    t0 = time.perf_counter()
    rows_a, digest_a, dts_a, launches, wall_a, peak = drive("a")
    print(f"SSM train phase (b): {RWKV_ARCH} at full width and depth "
          f"({RWKV_PARAMS} parameters), {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
          f"{TRAIN_STEPS} steps; run a {wall_a:.2f} s, launches {launches}; "
          f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    for r in rows_a:
        print(f"  step {r[0]}: loss {r[1]:.6f} grad_norm {r[2]:.6f}")
    rows_b, digest_b, dts_b, _, wall_b, _ = drive("b")
    shutil.rmtree(work, ignore_errors=True)
    same = (rows_b, digest_b) == (rows_a, digest_a)
    print(f"  run b: {wall_b:.2f} s; losses, grad norms and parameter digest "
          f"{digest_b} {'==' if same else '!='} run a's {digest_a}")
    check(same, f"rwkv train: two fresh runs differ: {rows_a} vs {rows_b}, "
          f"{digest_a} vs {digest_b}")
    steady = sorted(dts_a[1:] + dts_b[1:])
    step_ms = steady[len(steady) // 2] * 1e3
    rwkv_profile(RWKV_PROFILE_LAYERS)
    print(f"  rwkv train speed: median {step_ms:.4f} ms a step over steps "
          f"1-5 of runs a and b ({[round(d * 1e3, 3) for d in dts_a]}, "
          f"{[round(d * 1e3, 3) for d in dts_b]} ms), "
          f"{TRAIN_BATCH * TRAIN_SEQ / (step_ms * 1e-3):.3f} tokens/s; "
          f"(b) {time.perf_counter() - t0:.1f} s")
    return launches


def jamba_train_phase():
    """(c) jamba-v0.1-52b at full width, one 8-layer unit, as one card's
    share of 8-way expert parallelism (``expert_share=(0, 8)``: 2 of the
    16 experts held a MoE layer, every token routed over all 16; 3,430,232,064
    parameters), drawn by ``draw_at_fan_in``, through ``make_train_step``
    and ``run_training`` on phase 19's schedule, twice, every kernel
    counter zeroed just before and read just after (``flash_attention`` 2
    a step: forward and remat recompute; B7b 1 a step; nothing else): the
    losses, aux terms, grad norms and parameter digest equal bitwise and
    finite; ms a step, tokens/s, peak memory; the capacity dispatch's
    dropped assignments of an evaluation loss on the stream's first batch
    after run a."""
    import dataclasses
    import shutil

    import torch
    from repro_torch import get_config
    from repro_torch.configs import SHAPES
    from repro_torch.data.synthetic import DataConfig, _batch_at
    from repro_torch.launch.steps import make_train_step, param_count
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training

    full = get_config(JAMBA_ARCH)
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    m = cfg.moe
    check(param_count(cfg, JAMBA_SHARE) == JAMBA_SHARE_PARAMS and
          cfg.remat and cfg.compute_dtype == "bfloat16",
          f"{JAMBA_ARCH} share: {param_count(cfg, JAMBA_SHARE)} parameters")
    counters = ssm_train_counters()
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0, copy_period=4)
    work = ROOT / "build" / "phase22"

    def drive(tag, drops=False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prog = make_train_step(cfg, shape, ocfg=adamw.AdamWConfig(
            lr=3e-3, warmup_steps=10, total_steps=TRAIN_STEPS),
            microbatches=1, expert_share=JAMBA_SHARE)
        model = prog.model

        def init():
            model.init(torch.Generator(device="cuda").manual_seed(0))
            draw_at_fan_in(model)

        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        params, opt, hist = run_training(
            TrainLoopConfig(total_steps=TRAIN_STEPS,
                            ckpt_dir=str(work / tag), ckpt_every=0),
            prog, data, init, log=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {name: fn.launches for name, fn in counters.items()}
        check(sum(p.numel() for p in params.values()) == JAMBA_SHARE_PARAMS
              and model.expert_share == JAMBA_SHARE and
              params["layers.1.moe.w_gate"].shape[0] == 2,
              f"jamba train {tag}: not the share's parameters")
        check(launches["flash_attention"] == 2 * TRAIN_STEPS and
              launches["flash_attention_backward"] == TRAIN_STEPS and
              all(n == 0 for k, n in launches.items()
                  if not k.startswith("flash")),
              f"jamba train {tag}: launches {launches}, expected "
              f"flash_attention {2 * TRAIN_STEPS}, flash_attention_backward "
              f"{TRAIN_STEPS}")
        keys = ("step", "loss", "ce", "moe_lb", "moe_z", "grad_norm")
        rows = [tuple(h[k] for k in keys) for h in hist]
        check(all(math.isfinite(x) for r in rows for x in r[1:]),
              f"jamba train {tag}: non-finite loss / aux / grad norm {rows}")
        check(int(opt["step"]) == TRAIN_STEPS, f"jamba train {tag}: AdamW "
              f"step {int(opt['step'])}")
        out = (rows, param_digest(params), [h["dt"] for h in hist],
               launches, wall, peak)
        if drops:
            first = torch.from_numpy(_batch_at(data, 0)).cuda()
            with torch.no_grad(), routing_record() as routes:
                model.loss_fn({"tokens": first})
            out += (moe_drops(routes, m) + (len(routes),),)
        del prog, model, params, opt, hist
        gc_release()
        return out

    t0 = time.perf_counter()
    rows_a, digest_a, dts_a, launches, wall_a, peak, drops = drive("a", True)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"SSM train phase (c): {JAMBA_ARCH} at full width, {JAMBA_LAYERS} "
          f"of {full.n_layers} layers, expert share {JAMBA_SHARE[0]}/"
          f"{JAMBA_SHARE[1]} ({m.n_experts // JAMBA_SHARE[1]} of "
          f"{m.n_experts} experts held a MoE layer, {JAMBA_SHARE_PARAMS} "
          f"parameters, drawn at each leaf's fan-in scale), {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, {TRAIN_STEPS} steps, one microbatch; run a "
          f"{wall_a:.2f} s, launches {launches}; peak device memory {peak} "
          f"bytes ({peak / 2**30:.3f} GiB)")
    for r in rows_a:
        print(f"  step {r[0]}: loss {r[1]:.6f} ce {r[2]:.6f} moe_lb "
              f"{r[3]:.6f} moe_z {r[4]:.6f} grad_norm {r[5]:.6f}")
    dropped, assigned, n_routes = drops
    print(f"  capacity dispatch of an evaluation loss on the stream's first "
          f"batch after run a ({moe._capacity(tokens, m, m.n_experts)} slots "
          f"an expert for {tokens} tokens x top-{m.top_k}, all "
          f"{m.n_experts} experts routed over): {dropped} of {assigned} "
          f"assignments dropped "
          f"({dropped / assigned:.6f}) over {n_routes} MoE layers")
    rows_b, digest_b, dts_b, _, wall_b, _ = drive("b")
    shutil.rmtree(work, ignore_errors=True)
    same = (rows_b, digest_b) == (rows_a, digest_a)
    print(f"  run b: {wall_b:.2f} s; losses, aux terms, grad norms and "
          f"parameter digest {digest_b} {'==' if same else '!='} run a's "
          f"{digest_a}")
    check(same, f"jamba train: two fresh runs differ: {rows_a} vs {rows_b}, "
          f"{digest_a} vs {digest_b}")
    steady = sorted(dts_a[1:] + dts_b[1:])
    step_ms = steady[len(steady) // 2] * 1e3
    print(f"  jamba share train speed: median {step_ms:.4f} ms a step over "
          f"steps 1-5 of runs a and b ({[round(d * 1e3, 3) for d in dts_a]}, "
          f"{[round(d * 1e3, 3) for d in dts_b]} ms), "
          f"{TRAIN_BATCH * TRAIN_SEQ / (step_ms * 1e-3):.3f} tokens/s; (c) "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def ssm_train_phase():
    """Phase 22: (a) one rwkv6-3b layer and one Mamba layer at full width,
    gradients card vs CPU; (b) rwkv6-3b trained at full width and depth;
    (c) jamba-v0.1-52b's one-unit expert share trained at full width; (d)
    B7b at jamba's G = 4 training shape.  Returns the kernels' entries for
    the kernels line."""
    from repro_torch import get_config

    t0 = time.perf_counter()
    print(f"phase 22 on {card_line()}")
    ssm_grads_card_vs_cpu(get_config(RWKV_ARCH), get_config(JAMBA_ARCH))
    print(f"SSM train phase (a): {time.perf_counter() - t0:.1f} s")
    rwkv = rwkv_train_phase()
    jamba = jamba_train_phase()
    b7b, text = b7b_at("jamba's training shape", 32, 1024, 1024, 4, 128, 22)
    print(f"SSM train phase (d): B7b at jamba's training shape (BH 32, L = S "
          f"= 1024, G 4, hd 128, causal, bf16): {text}")
    print(f"phase 22: {time.perf_counter() - t0:.1f} s on {card_line()}")
    return {"flash_attention": {
                "jamba_train_launches": jamba["flash_attention"],
                "rwkv_train_launches": rwkv["flash_attention"]},
            "flash_attention_backward": {
                "jamba_ms": b7b["ms"], "jamba_plain_ms": b7b["plain_ms"],
                "jamba_library_ms": b7b["library_ms"],
                "jamba_bound_ms": b7b["bound_ms"],
                "jamba_max_abs_err": b7b["max_abs_err"],
                "jamba_train_launches": jamba["flash_attention_backward"],
                "rwkv_train_launches": rwkv["flash_attention_backward"]}}


# ---- phase 23: whisper-small, the encoder-decoder, served and trained ---------

WHISPER_ARCH, WHISPER_PARAMS = "whisper-small", 278_301_696   # full size
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW = 8, 224, 32
WHISPER_MAX_LEN = 448      # whisper's text context
WHISPER_TRAIN_TEXT = 448   # a training row: 449 tokens, 448 inputs
WHISPER_ATTN = 36          # B7 launches a prefill: 12 encoder + 12 decoder
                           # self + 12 cross attention layers


def whisper_frames(cfg, batch, seed):
    """(batch, encoder_seq, d_model) bf16 frame embeddings from a seeded
    generator on the card (the reference's audio frontend is a stub)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen,
                       device="cuda").to(torch.bfloat16)


def whisper_rescale(model, std) -> None:
    """Scale every EncDec layer weight that ``init`` drew by the
    reference's rule (``1 / sqrt(n)`` for a stack of n layers) to the
    standard deviation ``std(shape)`` of its unstacked shape."""
    import torch
    from repro_torch.models.layers import _flatten
    from repro_torch.models.transformer import _leaf

    with torch.no_grad():
        for units, layers in (("enc_units", model.enc_layers),
                              ("dec_units", model.dec_layers)):
            for path, d in _flatten(model.defs[units]).items():
                if d.init == "normal" and d.scale is None:
                    f = std(d.shape[1:]) * math.sqrt(len(layers))
                    for layer in layers:
                        _leaf(layer, path).mul_(f)
    model.drop_cast()



def teacher_forced(model, batch, gen, max_len, first):
    """The cached prefill of ``batch`` (its ``tokens`` and the model's
    other leaves: frames, prefix rows) and each decode step's logits
    (feeding ``gen``'s columns from cache slot ``first``, where the prompt
    ends) against a no-cache prefill of the same inputs: per position the
    logit gap of the position's max |logit| over the real vocabulary (the
    padded columns hold -1e30), and whether the first (cached prefill
    against no-cache) is bitwise."""
    import torch

    prompt = batch["tokens"]
    V = model.cfg.vocab
    logits, cache = model.prefill(batch, model.init_cache(prompt.shape[0],
                                                          max_len))
    out = {"rel": [], "finite": True, "bitwise": None}
    for t in range(gen.shape[1] + 1):
        if t:
            logits, cache = model.decode_step(gen[:, t - 1:t], first + t - 1,
                                              cache)
        full, _ = model.prefill({**batch, "tokens": torch.cat(
            [prompt, gen[:, :t]], dim=1)})
        if not t:
            out["bitwise"] = torch.equal(logits, full)
        logits_v, full_v = logits[:, :V].float(), full[:, :V].float()
        out["finite"] &= bool(torch.isfinite(logits_v).all()) and \
            bool(torch.isfinite(full_v).all())
        scale = full_v.abs().max()
        check(float(scale) > 0, f"teacher-forced position {t}: the no-cache "
              "prefill's logits are all zero")
        out["rel"].append(float((logits_v - full_v).abs().max() / scale))
    out["worst"] = max(out["rel"])
    return out


def logit_sensitivity(model, batch) -> float:
    """How far the no-cache prefill's logits move (of max |logit|, the real
    vocabulary's) when the token embeddings move by one ulp of the compute
    dtype."""
    import torch
    V = model.cfg.vocab
    base, _ = model.prefill(batch)
    real = model._embed

    def nudged(tokens):
        x = real(tokens)
        return x * (1 + torch.finfo(x.dtype).eps)

    model._embed = nudged
    try:
        moved, _ = model.prefill(batch)
    finally:
        del model._embed
    base = base[:, :V].float()
    return float((moved[:, :V].float() - base).abs().max()
                 / base.abs().max())


def tf_check(model, batch, gen, label, tol, *, arch, max_len, first, refan,
             hold=True):
    """Teacher-forced decode of ``gen`` from slot ``first`` against
    no-cache prefills (``teacher_forced``), and the logits' one-ulp
    sensitivity, on ``model`` at the reference's init: held at ``tol``
    where one ulp of the compute dtype on the embeddings moves the logits
    less, else printed; then, where it was not held, the same on the
    model's layer weights redrawn at ``1 / sqrt(fan_in)`` (``refan``),
    held there at ``tol`` when ``hold`` or where its one-ulp move is under
    ``tol`` (phase 21's rule for jamba)."""
    for scale in ("the reference's init", "fan-in scale"):
        tf = teacher_forced(model, batch, gen, max_len, first)
        sens = logit_sensitivity(model, batch)
        held = sens <= tol or (scale == "fan-in scale" and hold)
        print(f"  {label} teacher-forced decode vs no-cache prefill, "
              f"{gen.shape[1]} decode steps from slot {first}, layer weights "
              f"at {scale}: max |dlogit| / max |logit| = {tf['worst']:.4e} "
              f"(per position {[float(f'{r:.3e}') for r in tf['rel']]}); one "
              f"{label} ulp on the embeddings moves the prefill's logits by "
              f"{sens:.4e} of max |logit|: "
              f"{'held at ' + str(tol) if held else 'not held'}")
        check(tf["finite"] and tf["bitwise"], f"{label} teacher-forced "
              "logits non-finite, or the cached prefill unlike the no-cache "
              "one")
        if held:
            check(tf["worst"] <= tol, f"{arch} {label} decode logits "
                  f"{tf['worst']} from the prefill's at {scale}")
        if sens <= tol or scale == "fan-in scale":
            return
        refan(model)


def call_profile(fn, label):
    """A profiled call: device ms by kernel, kernels, busy share."""
    prof = _profile(fn, 1)
    if prof is None:
        print(f"  {label} profile: device time not measured (no CUDA "
              "events)")
        return
    wall, device, n_kern, busy, by_name = prof
    flash = sum(t for name, (t, _) in by_name.items() if "flash_" in name)
    gemm = sum(t for name, (t, _) in by_name.items()
               if GEMM_KERNEL.search(name))
    print(f"  {label} profile (torch.profiler, one call): host wall "
          f"{wall / 1e3:.4f} ms, device kernel time {device / 1e3:.4f} ms, "
          f"{n_kern:.0f} kernels, device busy {busy:.4f} of the host wall; "
          f"flash kernels {flash / 1e3:.4f} ms, GEMMs {gemm / 1e3:.4f} ms, "
          f"the rest {(device - flash - gemm) / 1e3:.4f} ms")
    for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    kernel {t / device:7.4f} {t / 1e3:10.4f} ms {k:7.0f}x "
              f"{name[:90]}")


def attn_counters():
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward)
    return {**kernel_counters(), "flash_attention": flash_attention,
            "flash_attention_backward": flash_attention_backward}


def logits_card_vs_cpu(small, batch, text, first, attn, label):
    """``small`` (f32, built on the card) fed ``batch`` (CPU tensors: its
    ``tokens``, ``text`` + 4 columns, and the model's other leaves): a
    prefill of the first ``text`` tokens into a cache of ``first`` + 4
    slots and 4 decode steps from slot ``first`` on the card (``attn`` B7
    launches a prefill), then on the CPU (the plain forms); each call's
    logits within ``F32_LOGIT_TOL`` of max |logit| over the real
    vocabulary (the padded columns hold -1e30).  Leaves ``small`` on the
    CPU."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention

    toks = batch["tokens"]

    def run(model):
        dev = model.device
        out = []
        before = flash_attention.launches
        lg, cache = model.prefill(
            {**{k: v.to(dev) for k, v in batch.items()},
             "tokens": toks[:, :text].to(dev)},
            model.init_cache(toks.shape[0], first + 4))
        if dev.type == "cuda":
            check(flash_attention.launches == before + attn, f"{label}: the "
                  "f32 card prefill did not launch B7 for each attention "
                  "layer")
        out.append(lg.cpu())
        for t in range(4):
            lg, cache = model.decode_step(
                toks[:, text + t:text + t + 1].to(dev), first + t, cache)
            out.append(lg.cpu())
        return out

    on_card = run(small)
    small.to("cpu")
    t_cpu = time.perf_counter()
    on_cpu = run(small)
    t_cpu = time.perf_counter() - t_cpu
    V = small.cfg.vocab
    rels = [float((a[:, :V] - b[:, :V]).abs().max() / b[:, :V].abs().max())
            for a, b in zip(on_card, on_cpu)]
    print(f"  {label}, card vs CPU (the CPU's {t_cpu:.2f} s): max |dlogit| / "
          f"max |logit| per call {[float(f'{r:.3e}') for r in rels]} "
          f"(tolerance {F32_LOGIT_TOL}, TF32 off)")
    check(all(bool(torch.isfinite(a).all()) for a in on_card) and
          max(rels) <= F32_LOGIT_TOL, f"{label}: card logits {rels} from "
          "the CPU's")


def whisper_card_vs_cpu(cfg):
    """One encoder and one decoder layer at full width in f32, drawn at
    fan-in scale (as ``whisper_grads_card_vs_cpu``): a prefill of 2 x
    (1,500 frames + 224 tokens) into a cache and 4 decode steps on the
    card (B7: 3 launches) against the CPU's plain forms
    (``logits_card_vs_cpu``).  At the 12-layer model's ``1 / sqrt(12)``
    the two read 7.7e-4 apart (an NVIDIA H100 80GB HBM3 at 700 W), where
    one f32 ulp moves the full model's logits by 6.6e-2."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import build_model

    cfg1 = dataclasses.replace(cfg, encoder_layers=1, n_layers=1,
                               compute_dtype="float32")
    small = build_model(cfg1).init(
        torch.Generator(device="cuda").manual_seed(1))
    whisper_rescale(small, lambda shape: shape[-2] ** -0.5)
    batch = {"frames": whisper_frames(cfg, 2, 3).float().cpu(),
             "tokens": torch.from_numpy(np.random.RandomState(3).randint(
                 0, cfg.vocab, (2, WHISPER_PROMPT + 4)).astype(np.int32))}
    logits_card_vs_cpu(
        small, batch, WHISPER_PROMPT, WHISPER_PROMPT, 3,
        f"1 encoder + 1 decoder layer, f32 at full width, fan-in scale: a "
        f"2 x (1500 frames + {WHISPER_PROMPT} tokens) prefill and 4 decode "
        f"steps")
    del small
    gc_release()


def whisper_serve_phase():
    """whisper-small at full width and depth (278,301,696 parameters) in
    ``make_prefill_step`` / ``make_decode_step``'s programs (one model,
    bf16 weights at the reference's init, seeded): 8 requests of 1,500
    frames and a 224-token prompt.  (a) the prefill program, every kernel
    counter zeroed just before and read just after (B7 36, nothing
    else), its logits finite; (b) ``EncDec.prefill`` into a 448-slot cache
    (its logits bitwise the program's), then 32 greedy steps of the decode
    program (no kernel); timings, peak memory, a profiled prefill and
    decode step; teacher-forced decode against no-cache prefills in bf16
    (``TF_LOGIT_TOL``) and in f32 (``F32_TF_TOL``), by
    ``tf_check``'s rule; one encoder and one decoder layer in f32,
    card vs CPU."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import build_model, get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    cfg = get_config(WHISPER_ARCH)
    check(cfg.encoder_layers == cfg.n_layers == 12 and cfg.d_model == 768
          and cfg.encoder_seq == 1500 and cfg.compute_dtype == "bfloat16",
          f"{WHISPER_ARCH} changed: {cfg}")
    t0 = time.perf_counter()
    prefill_fn, model = make_prefill_step(cfg)
    decode_fn, same = make_decode_step(cfg, model=model)
    check(same is model and model.pdt == torch.bfloat16, "the decode "
          "program does not share the prefill's bf16 model")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == WHISPER_PARAMS, f"{WHISPER_ARCH} has {n_params} "
          "parameters")
    print(f"encoder-decoder phase (a): {WHISPER_ARCH}, {n_params} "
          f"parameters, bf16 weights (the step builders'), init "
          f"{time.perf_counter() - t0:.2f} s; {WHISPER_BATCH} requests x "
          f"({cfg.encoder_seq} frames + {WHISPER_PROMPT} tokens)")
    frames = whisper_frames(cfg, WHISPER_BATCH, 23)
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (WHISPER_BATCH, WHISPER_PROMPT)).astype(np.int32)) \
        .cuda()
    batch = {"frames": frames, "tokens": prompt}
    counters = attn_counters()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t1 = time.perf_counter()
    logits = prefill_fn(batch)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t1) * 1e3
    launches = {name: fn.launches for name, fn in counters.items()}
    check(launches["flash_attention"] == WHISPER_ATTN and
          all(n == 0 for k, n in launches.items() if k != "flash_attention"),
          f"whisper prefill launches {launches}, expected flash_attention "
          f"{WHISPER_ATTN} and nothing else")
    check(logits.shape == (WHISPER_BATCH, cfg.padded_vocab) and
          bool(torch.isfinite(logits).all()), "whisper prefill logits: "
          "shape / non-finite")

    cache = model.init_cache(WHISPER_BATCH, WHISPER_MAX_LEN)
    lg, cache = model.prefill(batch, cache)
    bitwise = torch.equal(lg, logits)
    print(f"  prefill program: launches {launches}, first call "
          f"{first:.3f} ms; the cached prefill's last logits "
          f"{'==' if bitwise else '!='} the no-cache program's (bitwise; "
          f"max |d| {float((lg.float() - logits.float()).abs().max()):.3e})")
    check(bitwise, "the cached prefill's logits differ from the no-cache "
          "program's")
    tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
    for fn in counters.values():
        fn.launches = 0
    fed = []
    for i in range(WHISPER_NEW):
        fed.append(tok)
        lg, cache = decode_fn(tok, WHISPER_PROMPT + i, cache)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    dec_launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    gen = torch.cat(fed, dim=1)
    check(all(n == 0 for n in dec_launches.values()) and
          bool(torch.isfinite(lg).all()) and
          0 <= int(gen.min()) and int(gen.max()) < cfg.vocab,
          f"whisper decode: launches {dec_launches}, tokens out of range or "
          "non-finite logits")
    print(f"  {WHISPER_NEW} greedy decode steps: launches {dec_launches}; "
          f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")

    ttft = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill_fn(batch)
        torch.cuda.synchronize()
        ttft.append((time.perf_counter() - t1) * 1e3)

    def decode_run():
        c = model.init_cache(WHISPER_BATCH, WHISPER_MAX_LEN)
        out, c = model.prefill(batch, c)
        tk = torch.argmax(out, dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for i in range(WHISPER_NEW):
            tk.cpu()
            out, c = decode_fn(tk, WHISPER_PROMPT + i, c)
            tk = torch.argmax(out, dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        return (time.perf_counter() - t2) * 1e3 / WHISPER_NEW

    steps = [decode_run() for _ in range(3)]
    ttft_ms, step_ms = sorted(ttft)[2], sorted(steps)[1]
    print(f"  whisper serving: prefill (time to first token) median "
          f"{ttft_ms:.4f} ms of {WHISPER_BATCH} requests ({ttft}); decode "
          f"median {step_ms:.4f} ms a step of {WHISPER_BATCH} rows "
          f"({steps}), {WHISPER_BATCH * 1e3 / step_ms:.3f} tok/s")
    call_profile(lambda: prefill_fn(batch), "whisper prefill")
    call_profile(lambda: decode_fn(tok, WHISPER_PROMPT, cache),
                 "whisper decode step")
    del cache, lg, logits

    whisper_tf = dict(arch=WHISPER_ARCH, max_len=WHISPER_MAX_LEN,
                      first=WHISPER_PROMPT, refan=lambda m: whisper_rescale(
                          m, lambda shape: shape[-2] ** -0.5))
    tf_check(model, batch, gen, "bf16", TF_LOGIT_TOL, hold=False,
             **whisper_tf)
    del model, prefill_fn, decode_fn, same
    gc_release()

    model = build_model(dataclasses.replace(cfg, compute_dtype="float32")) \
        .init(torch.Generator(device="cuda").manual_seed(0))
    tf_check(model, {"frames": frames.float(), "tokens": prompt}, gen,
             "f32", F32_TF_TOL, **whisper_tf)
    del model
    gc_release()
    whisper_card_vs_cpu(cfg)
    return {"prefill_launches": launches["flash_attention"],
            "ttft_ms": ttft_ms, "step_ms": step_ms}


def train_counted(cfg, tag, shape, text, leaves_at, label, profile=False):
    """One fresh run of ``make_train_step`` on ``cfg`` and ``shape`` (f32
    weights at the reference's init from seed 0, remat "nothing", one
    microbatch, AdamW at launch.train's schedule: lr 3e-3, warmup 10) over
    ``TRAIN_STEPS`` batches of ``shape.global_batch`` rows of ``text`` + 1
    tokens from the synthetic stream, each with the other leaves
    ``leaves_at(step)`` gives (frames, prefix rows), every kernel counter
    zeroed just before and read just after.  Returns ``(rows (step, loss,
    grad norm), parameter digest, step seconds, launches, peak bytes,
    parameters)``."""
    import torch
    from repro_torch.data.synthetic import DataConfig, _batch_at
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    prog = make_train_step(cfg, shape, ocfg=adamw.AdamWConfig(
        lr=3e-3, warmup_steps=10, total_steps=TRAIN_STEPS), microbatches=1)
    check(prog.microbatches == 1 and cfg.remat and
          cfg.remat_policy == "nothing", f"train {tag}: not one microbatch "
          "with remat 'nothing'")
    prog.model.init(torch.Generator(device="cuda").manual_seed(0))
    params, opt = prog.params, adamw.init_state(prog.params)
    n_params = sum(p.numel() for p in params.values())
    data = DataConfig(vocab=cfg.vocab, seq_len=text,
                      global_batch=shape.global_batch, seed=0)

    def batch_at(step):
        return {**leaves_at(step),
                "tokens": torch.from_numpy(_batch_at(data, step)).cuda()}

    counters = attn_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    rows, dts = [], []
    for step in range(TRAIN_STEPS):
        batch = batch_at(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = prog.step_fn(params, opt, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        rows.append((step, loss, float(m["grad_norm"])))
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    digest = param_digest(params)
    if profile:
        batch = batch_at(TRAIN_STEPS)
        call_profile(lambda: prog.step_fn(params, opt, batch),
                     f"{label} training step")
    del prog, params, opt, m, batch
    gc_release()
    return rows, digest, dts, launches, peak, n_params


def grads_card_vs_cpu(small, batch, b7, b7b, label):
    """The loss of ``batch`` (CPU tensors) and every gradient of ``small``
    (f32, built on the card, remat on) on the card (``b7`` B7 and ``b7b``
    B7b launches) against the CPU's plain forms, ``GRAD_TOL`` of each
    leaf's max; key biases ``bk``, whose gradient is zero in exact
    arithmetic (softmax ignores a shift of every key's logit), to
    ``GRAD_TOL`` of their layer's ``bv`` gradient.  Leaves ``small`` on
    the CPU."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward)

    flash_attention.launches = flash_attention_backward.launches = 0
    loss_c, _ = small.loss_fn({k: v.cuda() for k, v in batch.items()})
    loss_c.backward()
    check(flash_attention.launches == b7 and
          flash_attention_backward.launches == b7b, f"{label}: the f32 card "
          f"loss launched B7 {flash_attention.launches} / B7b "
          f"{flash_attention_backward.launches} times, not {b7} / {b7b}")
    grads_c = {n: p.grad.cpu() for n, p in small.named_parameters()}
    loss_c = float(loss_c.detach())
    small.zero_grad(set_to_none=True)
    small.to("cpu")
    t_cpu = time.perf_counter()
    loss_h, _ = small.loss_fn(batch)
    loss_h.backward()
    t_cpu = time.perf_counter() - t_cpu
    grads_h = {n: p.grad for n, p in small.named_parameters()}
    worst, worst_name, bk = 0.0, "", None
    for n, g in grads_h.items():
        scale = float(g.abs().max())
        if n.endswith(".bk"):
            bv = float(grads_h[n[:-2] + "bv"].abs().max())
            bk = max(bk or 0.0, float(grads_c[n].abs().max()) / bv,
                     scale / bv)
            continue
        e = float((grads_c[n] - g).abs().max()) / max(scale, 1e-30)
        check(math.isfinite(e) and scale > 0, f"f32 grad {n}: {e}, {scale}")
        if e > worst:
            worst, worst_name = e, n
    lrel = abs(loss_c - float(loss_h.detach())) / abs(float(loss_h.detach()))
    bk_text = "" if bk is None else (
        f", bk gradients (zero in exact arithmetic) at most {bk:.3e} of bv's")
    print(f"  {label}, card vs CPU (the CPU's {t_cpu:.2f} s): loss rel "
          f"{lrel:.3e}, worst leaf {worst_name} {worst:.3e} of its max "
          f"|grad|{bk_text} (tolerance {GRAD_TOL}, TF32 off)")
    check(lrel <= GRAD_TOL and worst <= GRAD_TOL and (bk or 0.0) <= GRAD_TOL,
          f"{label}: f32 card gradients {worst} ({worst_name}) / loss {lrel} "
          f"/ bk {bk} from the CPU's")
    del grads_c, grads_h


def train_twice(cfg, shape, text, leaves_at, label, attn, heading,
                n_params=None):
    """Two fresh ``train_counted`` runs, the second followed by a profiled
    step: losses, grad norms and a parameter digest bitwise equal and
    finite; ``attn`` B7b launches a step and twice as many of B7 (forward
    + remat recompute), nothing else; ``n_params`` parameters where given;
    ms a step (the median of steps 1-5 of both runs) and text tokens/s.
    ``heading`` opens the printout.  Returns ``(launches, step ms, peak
    bytes)``."""
    def run(tag, profile=False):
        out = train_counted(cfg, tag, shape, text, leaves_at, label, profile)
        check(n_params is None or out[-1] == n_params,
              f"{label} train {tag}: {out[-1]} parameters")
        return out

    rows_a, digest_a, dts_a, launches, peak, _ = run("a")
    fwd, bwd = 2 * attn * TRAIN_STEPS, attn * TRAIN_STEPS
    print(f"{heading}, {TRAIN_STEPS} steps; launches {launches}; peak device "
          f"memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    for r in rows_a:
        print(f"  step {r[0]}: loss {r[1]:.6f} grad_norm {r[2]:.6f}")
    check(launches["flash_attention"] == fwd and
          launches["flash_attention_backward"] == bwd and
          all(n == 0 for k, n in launches.items() if not k.startswith("flash")),
          f"{label} train launches {launches}, expected flash_attention "
          f"{fwd} (forward + remat recompute), flash_attention_backward "
          f"{bwd}")
    check(all(math.isfinite(x) for r in rows_a for x in r[1:]),
          f"{label} train: non-finite loss / grad norm {rows_a}")
    rows_b, digest_b, dts_b, _, _, _ = run("b", profile=True)
    print(f"  run b: losses, grad norms and parameter digest {digest_b} "
          f"{'==' if (rows_b, digest_b) == (rows_a, digest_a) else '!='} "
          f"run a's {digest_a}")
    check(rows_b == rows_a and digest_b == digest_a,
          f"{label} train: two fresh runs differ: {rows_a} vs {rows_b}, "
          f"{digest_a} vs {digest_b}")
    steady = sorted(dts_a[1:] + dts_b[1:])
    step_ms = steady[len(steady) // 2] * 1e3
    print(f"  {label} train speed: median {step_ms:.4f} ms a step over "
          f"steps 1-5 of runs a and b ({[round(d * 1e3, 3) for d in dts_a]}, "
          f"{[round(d * 1e3, 3) for d in dts_b]} ms), "
          f"{shape.global_batch * text / (step_ms * 1e-3):.3f} text tokens/s")
    return launches, step_ms, peak


def whisper_grads_card_vs_cpu(cfg):
    """One encoder and one decoder layer at full width in f32, remat on:
    the loss of 2 x (1,500 frames + 129 tokens) and every gradient on the
    card (B7 6, B7b 3) against the CPU's plain forms
    (``grads_card_vs_cpu``).  The layer weights are drawn at their fan-in
    scale, ``1 / sqrt(fan_in)``, as the CPU tests draw theirs: at the
    12-layer model's ``1 / sqrt(12)`` one f32 ulp on the embeddings moves
    these gradients by 2.0e-4 of a leaf's max (measured on the CPU at 2 x
    300 frames; fan-in scale 1.3e-6), and the card read 4.6e-3 against
    the CPU (an NVIDIA H100 80GB HBM3 at 700 W)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import build_model

    cfg1 = dataclasses.replace(cfg, encoder_layers=1, n_layers=1,
                               compute_dtype="float32")
    small = build_model(cfg1).init(
        torch.Generator(device="cuda").manual_seed(1))
    whisper_rescale(small, lambda shape: shape[-2] ** -0.5)
    batch = {"frames": whisper_frames(cfg, 2, 4).float().cpu(),
             "tokens": torch.from_numpy(np.random.RandomState(4).randint(
                 0, cfg.vocab, (2, 129)).astype(np.int32))}
    grads_card_vs_cpu(small, batch, 6, 3,
                      "1 encoder + 1 decoder layer, f32 at full width, "
                      "fan-in scale, loss and gradients (2 x (1500 frames + "
                      "128 tokens))")
    del small
    gc_release()


def whisper_train_phase():
    """whisper-small at full width and depth trained through
    ``make_train_step`` (8 x (1,500 frames + 449 tokens), remat
    "nothing", 6 steps, no checkpoints) twice by ``train_twice``: B7 72
    and B7b 36 launches a step; one layer each in f32, gradients card vs
    CPU."""
    import dataclasses

    from repro_torch import get_config
    from repro_torch.configs import SHAPES

    cfg = get_config(WHISPER_ARCH)
    shape = dataclasses.replace(SHAPES["train_4k"],
                                seq_len=WHISPER_TRAIN_TEXT,
                                global_batch=WHISPER_BATCH)
    launches, step_ms, _ = train_twice(
        cfg, shape, WHISPER_TRAIN_TEXT,
        lambda step: {"frames": whisper_frames(cfg, WHISPER_BATCH,
                                               100 + step)},
        "whisper", WHISPER_ATTN,
        f"encoder-decoder phase (b): {WHISPER_ARCH} trained at full width "
        f"and depth, {WHISPER_BATCH} x ({cfg.encoder_seq} frames + "
        f"{WHISPER_TRAIN_TEXT + 1} tokens)")
    whisper_grads_card_vs_cpu(cfg)
    return {"flash_attention": launches["flash_attention"],
            "flash_attention_backward": launches["flash_attention_backward"],
            "step_ms": step_ms}


def encdec_phase():
    """Phase 23: whisper-small served and trained at full width and
    depth.  Returns the kernels' whisper entries for the kernels line."""
    t0 = time.perf_counter()
    print(f"phase 23 on {card_line()}")
    served = whisper_serve_phase()
    print(f"encoder-decoder phase (a): {time.perf_counter() - t0:.1f} s")
    trained = whisper_train_phase()
    print(f"phase 23: {time.perf_counter() - t0:.1f} s on {card_line()}")
    return {"flash_attention": {
                "whisper_prefill_launches": served["prefill_launches"],
                "whisper_train_launches": trained["flash_attention"]},
            "flash_attention_backward": {
                "whisper_train_launches":
                    trained["flash_attention_backward"]}}


# ---- phase 24: VLM prefixes (internvl2-26b) ----------------------------------

VLM_ARCH, VLM_PARAMS = "internvl2-26b", 19_862_722_560   # full size
VLM_BATCH, VLM_PROMPT, VLM_NEW = 4, 256, 32   # + the config's 256 prefix rows
VLM_TF_STEPS = 8           # teacher-forced decode steps checked
VLM_TRAIN_LAYERS, VLM_TRAIN_PARAMS = 4, 2_699_089_920   # f32 state fits
VLM_TRAIN_BATCH, VLM_TRAIN_TEXT = 2, 512     # + 256 prefix rows a row
VLM_CUT_TEXT = 64          # text tokens of the 1-2 layer card-vs-CPU cuts


def vlm_prefix(cfg, batch, seed, rows=None):
    """(batch, rows or prefix_tokens, d_model) bf16 patch embeddings from a
    seeded generator on the card (the reference's vision frontend is a
    stub)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((batch, rows or cfg.prefix_tokens, cfg.d_model),
                       generator=gen, device="cuda").to(torch.bfloat16)


def vlm_flash_phase():
    """B7 and B7b at internvl2-26b's attention shape (48 q heads over 8 kv
    heads: G = 6, the first group count that is no power of two; BH = 4 x
    8, L = S = 512: the 256 prefix rows and 256 prompt tokens, hd 128,
    causal, bf16): B7 against its plain form and the f64 oracle at phase
    13's bars, B7b against its plain backward and the f64 oracle at phase
    19's, bitwise on repeat, each timed beside its plain form, SDPA (its
    backward) and the bound."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    BH, L, S, G, hd = 32, 512, 512, 6, 128
    gen = torch.Generator(device="cuda").manual_seed(24)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for shape in ((BH, L, G, hd), (BH, S, hd), (BH, S, hd)))
    got = fa.flash_attention(q, k, v, causal=True)
    again = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    err = float((got.double() - want.double()).abs().max())
    oerr = float((got.double() - ref.flash_attention_ref(
        q, k, v, causal=True)).abs().max())
    check(bool(torch.isfinite(got).all()) and torch.equal(got, again) and
          err <= FLASH_TOL["bfloat16"] and oerr <= ORACLE_TOL["bfloat16"],
          f"B7 at internvl's G = 6 shape: {err} from its plain form, {oerr} "
          f"from the f64 oracle, bitwise on repeat {torch.equal(got, again)}")
    b7, _ = flash_times(q, k, v, True, want)
    b7["max_abs_err"] = err
    print(f"VLM phase (a): B7 at internvl2-26b's prefill shape (BH {BH}, L "
          f"= S = {L}, G {G}, hd {hd}, causal, bf16, {b7['ops'] / 1e9:.2f} "
          f"GFLOP, {b7['bytes'] / 1e6:.3f} MB): vs plain {err:.3e}, vs f64 "
          f"oracle {oerr:.3e}, bitwise on repeat; kernel {b7['ms']:.6f} ms, "
          f"plain {b7['plain_ms']:.6f} ms, SDPA {b7['library_ms']:.6f} ms, "
          f"bound {b7['bound_ms']:.6f} ms "
          f"({'bytes' if b7['bytes'] / HBM_BPS >= b7['ops'] / BF16_FLOPS else 'operations'}"
          f"; {b7['bound_ms'] / b7['ms']:.4f} of it; "
          f"{b7['ops'] / (b7['ms'] * 1e-3) / 1e12:.2f} TFLOP/s)")
    del got, again, want, q, k, v
    b7b, text = b7b_at("internvl's G = 6 shape", BH, L, S, G, hd, 24)
    print(f"  B7b at internvl2-26b's training shape (the same): {text}")
    return {"flash_attention": {k: b7[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")},
            "flash_attention_backward": b7b}


def vlm_card_vs_cpu(cfg):
    """Two layers at full width in f32, drawn at fan-in scale: a prefill
    of 2 x (256 prefix rows + 64 tokens) into a cache and 4 decode steps
    from slot P + L on the card (B7: 2 launches, G = 6) against the CPU's
    plain forms (``logits_card_vs_cpu``)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import build_model

    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    small = build_model(cfg2).init(
        torch.Generator(device="cuda").manual_seed(1))
    draw_at_fan_in(small)
    P, T = cfg.prefix_tokens, VLM_CUT_TEXT
    batch = {"prefix_embeds": vlm_prefix(cfg, 2, 3).float().cpu(),
             "tokens": torch.from_numpy(np.random.RandomState(3).randint(
                 0, cfg.vocab, (2, T + 4)).astype(np.int32))}
    logits_card_vs_cpu(
        small, batch, T, P + T, 2,
        f"2 layers, f32 at full width, fan-in scale: a 2 x ({P} prefix rows "
        f"+ {T} tokens) prefill and 4 decode steps from slot {P + T}")
    del small
    gc_release()


def vlm_serve_phase():
    """internvl2-26b at full width and depth (19,862,722,560 parameters,
    bf16 weights at the reference's init, seeded) through
    ``make_prefill_step`` / ``make_decode_step`` sharing one model: 4
    requests of 256 seeded prefix rows and a 256-token prompt.  The
    prefill program with every kernel counter zeroed just before and read
    just after (B7 48, G = 6, nothing else); ``LM.prefill`` into a 544-slot
    cache (its last logits bitwise the program's), then 32 greedy steps
    of the decode program from slot 512 (no kernel); timings, peak memory,
    a profiled prefill and decode step; bf16 teacher-forced decode
    against no-cache prefills by ``tf_check``'s rule; two layers in
    f32, card vs CPU."""
    import numpy as np
    import torch
    from repro_torch import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    cfg = get_config(VLM_ARCH)
    check(cfg.n_layers == 48 and cfg.d_model == 6144 and
          cfg.n_heads // cfg.n_kv_heads == 6 and cfg.prefix_tokens == 256
          and cfg.padded_vocab == 92_672, f"{VLM_ARCH} changed: {cfg}")
    P, T = cfg.prefix_tokens, VLM_PROMPT
    max_len = P + T + VLM_NEW
    t0 = time.perf_counter()
    prefill_fn, model = make_prefill_step(cfg)
    decode_fn, same = make_decode_step(cfg, model=model)
    check(same is model and model.pdt == torch.bfloat16, "the decode "
          "program does not share the prefill's bf16 model")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == VLM_PARAMS, f"{VLM_ARCH} has {n_params} parameters")
    print(f"VLM phase (b): {VLM_ARCH}, {n_params} parameters, bf16 weights "
          f"(the step builders'), init {time.perf_counter() - t0:.2f} s; "
          f"{VLM_BATCH} requests x ({P} prefix rows + {T} tokens), "
          f"{VLM_NEW} new tokens, a {max_len}-slot cache")
    prefix = vlm_prefix(cfg, VLM_BATCH, 24)
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (VLM_BATCH, T)).astype(np.int32)).cuda()
    batch = {"prefix_embeds": prefix, "tokens": prompt}
    counters = attn_counters()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t1 = time.perf_counter()
    logits = prefill_fn(batch)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t1) * 1e3
    launches = {name: fn.launches for name, fn in counters.items()}
    check(launches["flash_attention"] == cfg.n_layers and
          all(n == 0 for k, n in launches.items() if k != "flash_attention"),
          f"internvl prefill launches {launches}, expected flash_attention "
          f"{cfg.n_layers} and nothing else")
    check(logits.shape == (VLM_BATCH, cfg.padded_vocab) and
          bool(torch.isfinite(logits).all()), "internvl prefill logits: "
          "shape / non-finite")

    cache = model.init_cache(VLM_BATCH, max_len)
    lg, cache = model.prefill(batch, cache)
    bitwise = torch.equal(lg, logits)
    print(f"  prefill program: launches {launches}, first call "
          f"{first:.3f} ms; the cached prefill's last logits "
          f"{'==' if bitwise else '!='} the no-cache program's (bitwise)")
    check(bitwise, "the cached prefill's logits differ from the no-cache "
          "program's")
    tok = torch.argmax(lg[:, :cfg.vocab], dim=-1).to(torch.int32)[:, None]
    for fn in counters.values():
        fn.launches = 0
    fed = []
    for i in range(VLM_NEW):
        fed.append(tok)
        lg, cache = decode_fn(tok, P + T + i, cache)
        tok = torch.argmax(lg[:, :cfg.vocab], dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    dec_launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    gen = torch.cat(fed, dim=1)
    check(all(n == 0 for n in dec_launches.values()) and
          bool(torch.isfinite(lg).all()) and
          0 <= int(gen.min()) and int(gen.max()) < cfg.vocab,
          f"internvl decode: launches {dec_launches}, tokens out of range "
          "or non-finite logits")
    print(f"  {VLM_NEW} greedy decode steps from slot {P + T}: launches "
          f"{dec_launches}; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)")

    ttft = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill_fn(batch)
        torch.cuda.synchronize()
        ttft.append((time.perf_counter() - t1) * 1e3)

    def decode_run():
        c = model.init_cache(VLM_BATCH, max_len)
        out, c = model.prefill(batch, c)
        tk = torch.argmax(out[:, :cfg.vocab], dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for i in range(VLM_NEW):
            tk.cpu()
            out, c = decode_fn(tk, P + T + i, c)
            tk = torch.argmax(out[:, :cfg.vocab], dim=-1) \
                .to(torch.int32)[:, None]
        torch.cuda.synchronize()
        return (time.perf_counter() - t2) * 1e3 / VLM_NEW

    steps = [decode_run() for _ in range(2)]
    ttft_ms, step_ms = sorted(ttft)[1], min(steps)
    print(f"  internvl serving: prefill (time to first token) median "
          f"{ttft_ms:.4f} ms of {VLM_BATCH} requests ({ttft}); decode "
          f"{step_ms:.4f} ms a step of {VLM_BATCH} rows (the faster of "
          f"{steps}), {VLM_BATCH * 1e3 / step_ms:.3f} tok/s")
    call_profile(lambda: prefill_fn(batch), "internvl prefill")
    call_profile(lambda: decode_fn(tok, P + T, cache),
                 "internvl decode step")
    del cache, lg, logits

    tf_check(model, batch, gen[:, :VLM_TF_STEPS], "bf16", TF_LOGIT_TOL,
             arch=VLM_ARCH, max_len=P + T + VLM_TF_STEPS, first=P + T,
             refan=draw_at_fan_in)
    del model, prefill_fn, decode_fn, same
    gc_release()
    vlm_card_vs_cpu(cfg)
    return {"prefill_launches": launches["flash_attention"],
            "ttft_ms": ttft_ms, "step_ms": step_ms, "peak": peak}


def vlm_grads_card_vs_cpu(cfg):
    """One layer at full width in f32, drawn at fan-in scale, remat on: the
    loss of 2 x (256 prefix rows + 65 tokens) and every gradient on the
    card (B7 2, B7b 1, G = 6) against the CPU's plain forms
    (``grads_card_vs_cpu``, phase 19's bar)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import build_model

    cfg1 = dataclasses.replace(cfg, n_layers=1, compute_dtype="float32")
    small = build_model(cfg1).init(
        torch.Generator(device="cuda").manual_seed(1))
    draw_at_fan_in(small)
    batch = {"prefix_embeds": vlm_prefix(cfg, 2, 4).float().cpu(),
             "tokens": torch.from_numpy(np.random.RandomState(4).randint(
                 0, cfg.vocab, (2, VLM_CUT_TEXT + 1)).astype(np.int32))}
    grads_card_vs_cpu(small, batch, 2, 1,
                      f"1 layer, f32 at full width, fan-in scale, loss and "
                      f"gradients (2 x ({cfg.prefix_tokens} prefix rows + "
                      f"{VLM_CUT_TEXT} tokens))")
    del small
    gc_release()


def vlm_train_phase():
    """internvl2-26b at full width cut to 4 of its 48 layers (f32
    weights alone are 79.5 GB at full depth) trained through
    ``make_train_step`` with a batch that carries ``prefix_embeds`` (2 x
    (256 prefix rows + 513 tokens), remat "nothing", 6 steps, no
    checkpoints) twice by ``train_twice``: B7 4 x 2 and B7b 4 launches a
    step (G = 6); one layer in f32, gradients card vs CPU."""
    import dataclasses

    from repro_torch import get_config
    from repro_torch.configs import SHAPES

    cfg = dataclasses.replace(get_config(VLM_ARCH),
                              n_layers=VLM_TRAIN_LAYERS)
    shape = dataclasses.replace(SHAPES["train_4k"],
                                seq_len=cfg.prefix_tokens + VLM_TRAIN_TEXT,
                                global_batch=VLM_TRAIN_BATCH)
    launches, step_ms, peak = train_twice(
        cfg, shape, VLM_TRAIN_TEXT,
        lambda step: {"prefix_embeds": vlm_prefix(cfg, VLM_TRAIN_BATCH,
                                                  100 + step)},
        "internvl", VLM_TRAIN_LAYERS,
        f"VLM phase (c): {VLM_ARCH} trained at full width, "
        f"{VLM_TRAIN_LAYERS} of 48 layers ({VLM_TRAIN_PARAMS} parameters), "
        f"{VLM_TRAIN_BATCH} x ({cfg.prefix_tokens} prefix rows + "
        f"{VLM_TRAIN_TEXT + 1} tokens)", n_params=VLM_TRAIN_PARAMS)
    vlm_grads_card_vs_cpu(cfg)
    return {"flash_attention": launches["flash_attention"],
            "flash_attention_backward": launches["flash_attention_backward"],
            "step_ms": step_ms, "peak": peak}


def vlm_phase():
    """Phase 24: B7 / B7b at internvl2-26b's G = 6 shape, internvl2-26b
    served at full width and depth and trained at full width on 4 of 48
    layers.  Returns the kernels' internvl entries for the kernels
    line."""
    t0 = time.perf_counter()
    print(f"phase 24 on {card_line()}")
    kern = vlm_flash_phase()
    print(f"VLM phase (a): {time.perf_counter() - t0:.1f} s")
    served = vlm_serve_phase()
    print(f"VLM phase (b): {time.perf_counter() - t0:.1f} s")
    trained = vlm_train_phase()
    print(f"phase 24: {time.perf_counter() - t0:.1f} s on {card_line()}")
    return {"flash_attention": {
                "internvl_shape": kern["flash_attention"],
                "internvl_prefill_launches": served["prefill_launches"],
                "internvl_train_launches": trained["flash_attention"]},
            "flash_attention_backward": {
                "internvl_shape": kern["flash_attention_backward"],
                "internvl_train_launches":
                    trained["flash_attention_backward"]}}


# ---- phase 25: the dry run ---------------------------------------------------

def dryrun_phase():
    """Phase 25: ``repro_torch.launch.dryrun`` on the card.  Every halo
    cell (the 1-D, 2-D and 3-D virtual meshes x the four backends, then
    the 3-D mesh at widths 2 / two pulses) with the bytes its forward
    exchange moved equal to the plan's forward bytes, its launches (pallas:
    B1 a decomposed dim; signal: B3, or B4 with two pulses) and one
    forward's device time; a dense and a pruned MD cell (800 atoms on
    2x2x2, 6 steps; the pruned one with the pallas halo: B1 / B2 / B5 /
    B6); every LM cell of ``--all`` built on ``meta`` with the card's
    allocated memory unchanged.  Records go to ``build/dryrun_smoke``."""
    import shutil

    import torch
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    print(f"phase 25 on {card_line()}")
    out = ROOT / "build" / "dryrun_smoke"
    shutil.rmtree(out, ignore_errors=True)
    halo = dryrun.run_halo_cells(force=True, out=out) + \
        dryrun.run_halo_cells(force=True, width=2, pulses=2, out=out,
                              dds=["3d"])
    check(len(halo) == 16, f"{len(halo)} halo cells")
    for r in halo:
        tag = f"halo {r['dd']} {r['backend']} w{r['width']} p{r['pulses']}"
        check(r["ok"] and r["moved_bytes"] == r["plan_fwd_bytes"] and
              r["fwd_device_ms"] is not None, f"{tag}: {r.get('error')}")
        want = {"pallas": "pack", "signal": "fused_pulses"
                if r["pulses"] > 1 else "put_signal"}.get(r["backend"])
        check(want is None or r["launches"][want] > 0,
              f"{tag}: launches {r['launches']}")
        print(f"  {tag}: moved {r['moved_bytes']} B a domain (the plan's "
              f"{r['plan_fwd_bytes']}) over {r['devices']} domains; "
              f"launches {r['launches']}; one fwd {r['fwd_device_ms']:.6f} "
              f"ms of device time (CUDA events, 20 calls)")
    md = [dryrun.run_md_cells("dense", force=True, out=out),
          dryrun.run_md_cells("pallas", force=True, halo_backend="pallas",
                              out=out)]
    for r in md:
        check(r["ok"] and r["n_atoms_conserved"] and
              math.isfinite(r["pe_final"]), f"MD cell {r['force_backend']}: "
              f"{r.get('error')}")
        print(f"  MD cell {r['force_backend']} / {r['backend']} halo: "
              f"pe_final {r['pe_final']}, prune ratio "
              f"{r['pair_stats']['prune_ratio']:.4f}, launches "
              f"{r['launches']}, {r['wall_s']} s")
    check(md[1]["launches"]["pair_forces"] > 0 and
          md[1]["launches"]["scatter_accum"] > 0 and
          md[1]["launches"]["pack"] > 0, f"the pruned MD cell launched "
          f"{md[1]['launches']}")
    del halo, md
    gc_release()             # the MD cells' engines (reference cycles)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    lm = dryrun.run_cells(ARCH_IDS, list(SHAPES), force=True, out=out)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    check(len(lm) == len(ARCH_IDS) * len(SHAPES) and
          all(r["ok"] for r in lm) and after == before,
          f"LM cells: {[r for r in lm if not r['ok']][:1]}, allocated "
          f"{before} -> {after}")
    built = [r for r in lm if not r.get("skipped")]
    print(f"  {len(lm)} LM cells ({len(built)} built on meta, "
          f"{len(lm) - len(built)} skipped), the card's allocated memory "
          f"{before} -> {after} bytes; cells on one card: "
          f"{sorted((r['arch'], r['shape']) for r in built if r['fits_one_card'])}")
    dryrun.summarize(out)
    print(f"phase 25: {time.perf_counter() - t0:.1f} s on {card_line()}")
    return {"lm_cells": len(lm)}


def main():
    args = sys.argv[1:]
    if args in (["--serve"], ["--drill"], ["--train"], ["--moe"],
                ["--ssm"], ["--ssm-train"], ["--encdec"], ["--vlm"],
                ["--dryrun"]):
        pass
    elif args and (len(args) != 2
                   or args[0] not in ("--kernels", "--steps")):
        fail("usage: chip_smoke.py [--kernels CHECKOUT | --steps CHECKOUT "
             "| --serve | --drill | --train | --moe | --ssm | --ssm-train "
             "| --encdec | --vlm | --dryrun]")
    src = Path(args[1]).resolve() / "src" if len(args) == 2 else SRC
    if not (src / "repro_torch" / "csrc" / "halo_pack.cu").is_file():
        fail(f"{src / 'repro_torch'} not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{kind}")

    if args == ["--serve"]:
        from repro_torch.kernels import _build
        _build.build(["halo_pack", "halo_signal", "nonbonded"])
        serve_md_phase()
        print(card)
        return
    if args == ["--drill"]:
        from repro_torch import make_grappa_like
        from repro_torch.kernels import _build
        _build.build(["halo_pack", "halo_signal", "nonbonded"])
        drill_phase(make_grappa_like(45_000, seed=0))
        print(card)
        return
    if args == ["--train"]:
        from repro_torch.kernels import _build
        built = _build.build(["halo_pack", "halo_signal", "nonbonded",
                              "flash_attention"])
        train_phase(b7b_phase(built["flash_attention"].path)
                    ["flash_attention_backward"])
        print(card)
        return
    if args == ["--moe"]:
        from repro_torch.kernels import _build
        _build.build(["halo_pack", "halo_signal", "nonbonded",
                      "flash_attention"])
        moe_phase()
        print(card)
        return
    if args == ["--ssm"]:
        from repro_torch.kernels import _build
        _build.build(["halo_pack", "halo_signal", "nonbonded",
                      "flash_attention"])
        ssm_phase()
        print(card)
        return
    if args == ["--ssm-train"]:
        from repro_torch.kernels import _build
        _build.build(["halo_pack", "halo_signal", "nonbonded",
                      "flash_attention"])
        ssm_train_phase()
        print(card)
        return
    if args == ["--encdec"]:
        from repro_torch.kernels import _build
        _build.build(["halo_pack", "halo_signal", "nonbonded",
                      "flash_attention"])
        encdec_phase()
        print(card)
        return
    if args == ["--vlm"]:
        from repro_torch.kernels import _build
        _build.build(["halo_pack", "halo_signal", "nonbonded",
                      "flash_attention"])
        vlm_phase()
        print(card)
        return
    if args == ["--dryrun"]:
        from repro_torch.kernels import _build
        _build.build(["halo_pack", "halo_signal", "nonbonded",
                      "flash_attention"])
        dryrun_phase()
        print(card)
        return
    if args and args[0] == "--steps":
        from repro_torch.kernels import _build
        _build.build(["halo_pack", "halo_signal", "nonbonded"])
        steps_phase()
        print(card)
        return
    if args:
        # phase 7, phase 10 and phase 15's kernel part alone on another
        # checkout's kernels, measured as this script measures its own (a
        # same-call comparison of commits)
        import numpy as np
        from repro_torch import make_grappa_like
        from repro_torch.kernels import _build
        _build.build(["halo_pack", "halo_signal", "nonbonded",
                      "flash_attention"])
        system = make_grappa_like(45_000, seed=0)
        nb_kernel_phase(system)
        signal_kernel_phase(system)
        wire_kernel_phase(make_grappa_like(45_000, seed=0,
                                           dtype=np.float64))
        b7b_speed(str(src.parent))
        print(card)
        return

    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build(["halo_pack", "nonbonded", "halo_signal",
                          "flash_attention"])
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for res in built.values():
        for line in res.log.splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "smem", "spill", "arning")):
                print(f"  ptxas {res.name}: {line.strip()}")

    # 3. kernels at the main path's shapes, on the main path's state
    import numpy as np
    from repro_torch import HaloSpec, MDEngine, make_grappa_like, make_md_mesh
    system = make_grappa_like(45_000, seed=0)
    eng = MDEngine(system, make_md_mesh(8),
                   HaloSpec(AXES, (1, 1, 1), backend="pallas"))
    cf, ci, _force, _diag = eng.rebin_fn(*eng.init_state())
    per_kernel = kernel_phase(eng, cf, ci)
    del eng, cf, ci, _force

    # 4. small reference
    reference_phase()

    # 5. the main path
    launches = main_path_phase()

    # 6. where a steady step spends device time
    profile_phase()

    # 7. the pruned kernels at the tier shapes of the first pruned block
    nb_kernel = nb_kernel_phase(system)

    # 8. the pruned main path (and nstprune=5)
    pruned_launches = pruned_path_phase(system)

    # 9. where a steady pruned step spends device time
    pruned_profile_phase(system)

    # 10. the signal kernels at the signal path's shapes
    sig_kernel = signal_kernel_phase(system)

    # 11. the signal main path (double buffer, fused rebin, two pulses,
    # pruned), each bitwise against serialized / off
    sig_launches, w2_launches = signal_path_phase(system)

    # 12. where a steady signal / double_buffer step spends device time,
    # and its host time against off
    signal_profile_phase(system)
    host_off_vs_double_buffer(system)
    del system

    # 13. flash_attention at the serve path's shapes
    flash_kernel = flash_phase(built["flash_attention"].path)

    # 14. qwen3-1.7b served at full width through the kernel
    serve_launches = serve_phase()

    # 15. compressed halo payloads: grappa-45k in f64, every wire format
    # through the pallas, signal and serialized paths
    system64 = make_grappa_like(45_000, seed=0, dtype=np.float64)
    wire_kernel = wire_kernel_phase(system64)
    wire_runs = wire_path_phase(system64)
    wire_drift_phase(system64)
    wire_profile(system64)
    wire_speed(system64)

    # 16. every MD cell through its step graphs against capture="off"
    t16 = time.perf_counter()
    block_graph_phase(make_grappa_like(45_000, seed=0), system64)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s")
    del system64

    # 17. MD serving: replica lanes, one launch per kernel for all lanes
    served = serve_md_phase()

    # 18. the self-healing runtime: faults injected, detected, recovered
    drill_phase(make_grappa_like(45_000, seed=0))

    # 19. training: B7b at the training shapes, then qwen3-1.7b trained at
    # full width (determinism, kill / resume), a 2-layer f32 card-vs-CPU
    # gradient check
    b7b_kernel = b7b_phase(built["flash_attention"].path)
    train_launches = train_phase(b7b_kernel["flash_attention_backward"])

    # 20. Mixture-of-Experts: B7 / B7b at olmoe's G = 1 shape, olmoe-1b-7b
    # served at full width and depth and trained at full width (4 layers)
    moe_kernel = moe_phase()

    # 21. state-space models: rwkv6-3b served at full width and depth,
    # jamba-v0.1-52b at full width (one unit), B7 at jamba's G = 4 shape
    ssm_kernel = ssm_phase()

    # 22. state-space models trained: rwkv6-3b at full width and depth, the
    # jamba-v0.1-52b unit as one card's expert share, B7b at jamba's G = 4
    ssm_train_kernel = ssm_train_phase()

    # 23. the encoder-decoder: whisper-small served through the prefill /
    # decode step builders and trained at full width and depth
    encdec_kernel = encdec_phase()

    # 24. VLM prefixes: B7 / B7b at internvl2-26b's G = 6 shape, internvl
    # served at full width and depth and trained at full width (4 layers)
    vlm_kernel = vlm_phase()

    # 25. the dry run: halo, MD and LM cells of launch.dryrun on the card
    dryrun_phase()

    replaces = {"pack": "src/repro/kernels/halo_pack.py:57",
                "unpack_add": "src/repro/kernels/halo_pack.py:105",
                "put_signal": "src/repro/kernels/halo_pack.py:165",
                "fused_pulses": "src/repro/kernels/halo_pack.py:263",
                "pack_wire": "src/repro/kernels/halo_pack.py:57",
                "put_signal_wire": "src/repro/kernels/halo_pack.py:165",
                "pair_forces": "src/repro/kernels/nonbonded.py:92",
                "scatter_accum": "src/repro/kernels/nonbonded.py:171",
                "flash_attention": "src/repro/kernels/flash_attention.py:76",
                "flash_attention_backward":
                    "src/repro/models/attention.py:89"}
    sources = {"pack": "src/repro_torch/csrc/halo_pack.cu",
               "unpack_add": "src/repro_torch/csrc/halo_pack.cu",
               "put_signal": "src/repro_torch/csrc/halo_signal.cu",
               "fused_pulses": "src/repro_torch/csrc/halo_signal.cu",
               "pack_wire": "src/repro_torch/csrc/halo_pack.cu",
               "put_signal_wire": "src/repro_torch/csrc/halo_signal.cu",
               "pair_forces": "src/repro_torch/csrc/nonbonded.cu",
               "scatter_accum": "src/repro_torch/csrc/nonbonded.cu",
               "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
               "flash_attention_backward":
                   "src/repro_torch/csrc/flash_attention.cu"}
    modules = {"pack": "halo_pack", "unpack_add": "halo_pack",
               "put_signal": "halo_pack", "fused_pulses": "halo_pack",
               "pack_wire": "halo_pack", "put_signal_wire": "halo_pack",
               "pair_forces": "nonbonded", "scatter_accum": "nonbonded",
               "flash_attention": "flash_attention",
               "flash_attention_backward": "flash_attention"}
    main_launches = {**launches, **{k: pruned_launches[k] for k in nb_kernel},
                     "put_signal": sig_launches["put_signal"],
                     "fused_pulses": w2_launches["fused_pulses"],
                     "flash_attention": serve_launches["flash_attention"],
                     "flash_attention_backward":
                         train_launches["flash_attention_backward"],
                     "pack_wire": wire_runs["float32"]["pallas/off"][
                         "pack_wire"],
                     "put_signal_wire": wire_runs["float32"]["signal/db2"][
                         "put_signal_wire"]}
    designs = {"pair_forces": "a lane group per cell pair, fb in "
                              "registers, fa reduce-scattered, no shared tile",
               "scatter_accum": "a warp per cell, 16-byte words, 4 entries' "
                                "loads in flight",
               "put_signal": "a flat 16-byte word grid over the launch, the "
                             "last arriver releases each destination",
               "put_signal_wire": "the same grid, N elements a thread into "
                                  "one 16-byte wire word",
               "fused_pulses": "the flat word grid, pulses padded to whole "
                               "blocks and taken by ticket; a block waits "
                               "only for forwarded words, the last arriver "
                               "releases each (destination, pulse)",
               "pack_wire": "a flat grid, N elements a thread into one "
                            "16-byte wire word",
               "flash_attention_backward":
                   "B7b, no TPU kernel: the reference trains through "
                   "autodiff of blocked_attention; bf16 on the tensor "
                   "cores: D and q * scale a 16-byte word a thread, a dK / "
                   "dV block per (bh, 128 keys) and a dQ block per (bh, 128 "
                   "rows), TMA-fed 64-row tiles, wgmma SS for S and dP, RS "
                   "for dV, dK and dQ, no atomics"}
    kernels = []
    for name, acc in {**per_kernel, **nb_kernel, **sig_kernel,
                      **flash_kernel, **b7b_kernel,
                      **{f"{k}_wire": a for k, a in wire_kernel.items()}
                      }.items():
        bound_by = "bytes" if acc["bytes"] / HBM_BPS >= \
            acc["ops"] / acc.get("peak", FP32_FLOPS) else "operations"
        kernels.append({
            "name": f"{modules[name]}.{name}", "route": "cuda",
            "source": sources[name], "replaces": replaces[name],
            "launches": main_launches[name],
            "max_abs_err": acc["max_abs_err"], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": bound_by, "library_ms": acc["library_ms"],
            **({"device_us_per_launch": acc["device_us_per_launch"]}
               if "device_us_per_launch" in acc else {}),
            **({"serve_launches": served[name]} if name in served else {}),
            **({"train_launches": train_launches[name]}
               if name in train_launches else {}),
            **moe_kernel.get(name, {}),
            **ssm_kernel.get(name, {}),
            **ssm_train_kernel.get(name, {}),
            **encdec_kernel.get(name, {}),
            **vlm_kernel.get(name, {}),
            **({"whisper_shapes": acc["whisper_shapes"]}
               if "whisper_shapes" in acc else {}),
            **({"design": designs[name]} if name in designs else {})})
    print("kernel times are one MD step's f32 launches, summed (pack: 3 fwd "
          "+ 3 rev pulses; unpack_add: 3 rev pulses; pair_forces and "
          "scatter_accum: the six tiers; put_signal: 3 fwd + 3 rev pulses "
          "of the signal path; fused_pulses: 3 fwd dims at widths (2,2,2) / "
          "pulses (2,2,2)); launches: pack and unpack_add on the dense main "
          "path, pair_forces and scatter_accum on the pruned one, put_signal "
          "on the dense signal / double_buffer depth-2 run, fused_pulses on "
          "the two-pulse signal run; flash_attention: one bf16 launch at "
          "the qwen3-1.7b serve shape (BH 32, L = S = 1024, G 2, hd 128), "
          "its launches over the two served waves, its bound at 989 "
          "TFLOP/s bf16, its yardstick SDPA, train_launches its launches "
          "over qwen3-1.7b's 6 training steps (28 layers x (forward + "
          "remat recompute)); flash_attention_backward (B7b): one bf16 "
          "backward at the training shape (the same shape), its launches "
          "over the 6 steps, its bound at 989 TFLOP/s bf16 over five "
          "products, its yardstick SDPA's backward; olmoe_*: B7 / B7b at "
          "olmoe-1b-7b's shape (BH 64, L = S = 1024, G 1, hd 128), ms, "
          "yardstick and bound as above, launches over its two served "
          "waves (16 layers) and over one 6-step training run at 4 layers; "
          "jamba_*: B7 at jamba-v0.1-52b's shape (BH 32, L = S = 1024, G 4, "
          "hd 128), launches over its two served waves (one unit, one "
          "attention layer); rwkv_serve_launches: over rwkv6-3b's two "
          "served waves (no attention); jamba_train_launches: over one "
          "6-step training run of the jamba-v0.1-52b unit as expert share "
          "0/8 (B7: forward + remat recompute; B7b: one a step); "
          "flash_attention_backward's jamba_*: B7b at that shape, G 4, timed "
          "and bounded as above; rwkv_train_launches: over one 6-step "
          "rwkv6-3b training run; whisper_shapes: B7 / B7b at "
          "whisper-small's encoder (BH 96, L = S = 1500, full), cross (BH "
          "96, L 224, S 1500, full) and decoder self (BH 96, L = S = 448, "
          "causal) shapes, G 1, hd 64, bf16, timed and bounded as above; "
          "whisper_prefill_launches: one prefill of 8 x (1500 frames + 224 "
          "tokens); whisper_train_launches: over one 6-step whisper-small "
          "training run (B7: forward + remat recompute; B7b: 36 a step); "
          "internvl_shape: B7 / B7b at internvl2-26b's prefill shape (BH "
          "32, L = S = 512, G 6, hd 128, causal, bf16), timed and bounded "
          "as above; internvl_prefill_launches: one prefill of 4 x (256 "
          "prefix rows + 256 tokens) at full depth; "
          "internvl_train_launches: over one 6-step training run at 4 of 48 "
          "layers (B7: forward + remat recompute; B7b: 4 a step); "
          "pack_wire / "
          "put_signal_wire "
          "(the wire forms, B1w / B3w): one f64 step's 3 forward launches, "
          "f64 rows to f32, launches on the grappa-45k f64 float32-wire "
          "pallas / off and signal / double_buffer runs, yardsticks "
          "index_select + .to (put_signal_wire: + roll)")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
